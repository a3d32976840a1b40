"""SWC-113: multiple external calls in one transaction.

Covers mythril/analysis/module/modules/multiple_sends.py.
"""

from __future__ import annotations

import logging
from copy import copy
from typing import List

from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import MULTIPLE_SENDS
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

CALL_OPS = ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE")

REMEDIATION = (
    "This call is executed following another call within the same transaction. It is possible "
    "that the call never gets executed if a prior call fails permanently. This might be caused "
    "intentionally by a malicious callee. If possible, refactor the code such that each transaction "
    "only executes one external call or "
    "make sure that all callees can be trusted (i.e. they’re part of your own codebase)."
)


class MultipleSendsAnnotation(StateAnnotation):
    def __init__(self) -> None:
        self.call_offsets: List[int] = []

    def __copy__(self):
        twin = MultipleSendsAnnotation()
        twin.call_offsets = copy(self.call_offsets)
        return twin


def _call_trace(state: GlobalState) -> List[int]:
    tracker = next(iter(state.get_annotations(MultipleSendsAnnotation)), None)
    if tracker is None:
        tracker = MultipleSendsAnnotation()
        state.annotate(tracker)
    return tracker.call_offsets


class MultipleSends(ImmediateDetector):
    """Checks for multiple sends in a single transaction."""

    name = "Multiple external calls in the same transaction"
    swc_id = MULTIPLE_SENDS
    description = "Check for multiple sends in a single transaction"
    pre_hooks = list(CALL_OPS) + ["RETURN", "STOP"]

    def _analyze_state(self, state: GlobalState) -> list:
        instruction = state.get_current_instruction()
        offsets = _call_trace(state)

        if instruction["opcode"] in CALL_OPS:
            offsets.append(instruction["address"])
            return []

        # RETURN/STOP: the second and later calls are the finding
        for repeat_offset in offsets[1:]:
            try:
                witness = get_transaction_sequence(
                    state, state.world_state.constraints
                )
            except UnsatError:
                continue
            return [
                Issue(
                    swc_id=MULTIPLE_SENDS,
                    title="Multiple Calls in a Single Transaction",
                    severity="Low",
                    description_head=(
                        "Multiple calls are executed in the same transaction."
                    ),
                    description_tail=REMEDIATION,
                    gas_used=gas_range(state),
                    transaction_sequence=witness,
                    **found_at(state, address=repeat_offset),
                )
            ]
        return []


detector = MultipleSends()
