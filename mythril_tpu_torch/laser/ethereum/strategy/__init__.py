"""Search-strategy protocol.

A strategy owns the engine worklist and decides which path state runs
next (mythril/laser/ethereum/strategy/__init__.py). Iteration ends
when the worklist drains; states at or past max_depth are discarded
as they surface.
"""

from __future__ import annotations

import abc

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState  # noqa: F401


class BasicSearchStrategy(abc.ABC):
    __slots__ = ("work_list", "max_depth")

    def __init__(self, pending_states, depth_cap):
        self.work_list = pending_states
        self.max_depth = depth_cap

    @abc.abstractmethod
    def get_strategic_global_state(self):
        """Pick (and remove) the next state to execute."""

    def __iter__(self):
        while True:
            try:
                chosen = self.get_strategic_global_state()
            except IndexError:
                return  # worklist drained
            if chosen.mstate.depth < self.max_depth:
                yield chosen
