"""Loop bounding as a strategy decorator.

Covers mythril/laser/ethereum/strategy/extensions/bounded_loops.py:
each path carries a trace of reached instruction addresses; when the
trace's tail is one cycle repeated back-to-back, the repetition count
is measured and states past the configured bound are dropped before
they execute. Creation transactions get a floor of 8 iterations so
constructors that loop over storage can still deploy.
"""

from __future__ import annotations

import logging
from copy import copy
from typing import Dict, List

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy
from mythril_tpu_torch.laser.ethereum.transaction import ContractCreationTransaction

log = logging.getLogger(__name__)

CREATION_LOOP_FLOOR = 8


class JumpdestCountAnnotation(StateAnnotation):
    """Per-path trace of reached instruction addresses."""

    def __init__(self) -> None:
        self._reached_count: Dict[int, int] = {}
        self.trace: List[int] = []

    def __copy__(self):
        twin = JumpdestCountAnnotation()
        twin._reached_count = copy(self._reached_count)
        twin.trace = copy(self.trace)
        return twin


def _window_key(trace: List[int], lo: int, hi: int) -> int:
    """Pack trace[lo:hi] into one integer (8 bits per entry — cheap
    rolling compare, same aliasing behavior as the reference)."""
    packed = 0
    for at in range(lo, hi):
        packed |= trace[at] << ((at - lo) * 8)
    return packed


def tail_cycle_count(trace: List[int]) -> int:
    """How many times the trace's final cycle repeats contiguously.

    Scans backwards for an earlier occurrence of the trace's last two
    entries; the span between defines the candidate cycle, which is
    then counted backwards window by window.
    """
    anchor = None
    for at in range(len(trace) - 3, 0, -1):
        if trace[at] == trace[-2] and trace[at + 1] == trace[-1]:
            anchor = at
            break
    if anchor is None:
        return 0

    lo = anchor + 1
    width = len(trace) - 1 - lo
    key = _window_key(trace, lo, len(trace) - 1)

    repeats = 1
    at = lo
    while at >= 0 and _window_key(trace, at, at + width) == key:
        repeats += 1
        at -= width
    return repeats


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Wraps another strategy; drops states stuck in a loop."""

    def __init__(self, super_strategy: BasicSearchStrategy, *args) -> None:
        self.super_strategy = super_strategy
        self.bound = args[0][0]
        log.info(
            "Loaded search strategy extension: Loop bounds (limit = %d)",
            self.bound,
        )
        BasicSearchStrategy.__init__(
            self, super_strategy.work_list, super_strategy.max_depth
        )

    # historical names for the algorithm pieces (used by tests)
    calculate_hash = staticmethod(
        lambda i, j, trace: _window_key(trace, i, j)
    )
    get_loop_count = staticmethod(tail_cycle_count)

    def get_strategic_global_state(self) -> GlobalState:
        while True:
            state = self.super_strategy.get_strategic_global_state()

            annotation = next(
                iter(state.get_annotations(JumpdestCountAnnotation)), None
            )
            if annotation is None:
                annotation = JumpdestCountAnnotation()
                state.annotate(annotation)

            instruction = state.get_current_instruction()
            annotation.trace.append(instruction["address"])
            if instruction["opcode"].upper() != "JUMPDEST":
                return state

            repeats = tail_cycle_count(annotation.trace)
            in_creation = isinstance(
                state.current_transaction, ContractCreationTransaction
            )
            if in_creation and repeats < max(CREATION_LOOP_FLOOR, self.bound):
                return state
            if repeats > self.bound:
                log.debug("Loop bound reached, skipping state")
                continue
            return state
