"""SWC-104: return value of an external call is never checked.

Covers mythril/analysis/module/modules/unchecked_retval.py —
CALL-family post-hooks collect retval symbols; a retval that can still
be both 0 and 1 when the transaction ends was never constrained.
"""

from __future__ import annotations

import logging
from copy import copy
from typing import List, Mapping, Union

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.swc_data import UNCHECKED_RET_VAL
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt.bitvec import BitVec

log = logging.getLogger(__name__)

CALL_OPS = ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE")

REMEDIATION = (
    "External calls return a boolean value. If the callee halts with an exception, 'false' is "
    "returned and execution continues in the caller. "
    "The caller should check whether an exception happened and react accordingly to avoid unexpected "
    "behavior. For example it is often desirable to wrap external calls in require() so the "
    "transaction is reverted if the call fails."
)


class UncheckedRetvalAnnotation(StateAnnotation):
    def __init__(self) -> None:
        self.retvals: List[Mapping[str, Union[int, BitVec]]] = []

    def __copy__(self):
        twin = UncheckedRetvalAnnotation()
        twin.retvals = copy(self.retvals)
        return twin


def _retval_log(state: GlobalState) -> list:
    tracker = next(iter(state.get_annotations(UncheckedRetvalAnnotation)), None)
    if tracker is None:
        tracker = UncheckedRetvalAnnotation()
        state.annotate(tracker)
    return tracker.retvals


class UncheckedRetval(ImmediateDetector):
    """Tests whether CALL return values are checked."""

    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = (
        "Test whether CALL return value is checked. "
        "For direct calls, the Solidity compiler auto-generates this check."
        " For low-level-calls the check is omitted."
    )
    pre_hooks = ["STOP", "RETURN"]
    post_hooks = list(CALL_OPS)

    def _analyze_state(self, state: GlobalState) -> list:
        instruction = state.get_current_instruction()
        pending = _retval_log(state)

        if instruction["opcode"] not in ("STOP", "RETURN"):
            # CALL-family post-hook: remember the pushed retval symbol
            log.debug("End of call, extracting retval")
            prev_op = state.environment.code.instruction_list[
                state.mstate.pc - 1
            ]["opcode"]
            assert prev_op in CALL_OPS
            pending.append(
                {
                    "address": state.instruction["address"] - 1,
                    "retval": state.mstate.stack[-1],
                }
            )
            return []

        from mythril_tpu_torch.analysis.prepass import device_already_proved

        found = []
        for entry in pending:
            if device_already_proved(
                state, UNCHECKED_RET_VAL, address=entry["address"]
            ):
                # a device lane ran this call and halted with no branch
                # after it — the banked witness carries the issue
                continue
            try:
                # unconstrained = both outcomes still satisfiable
                solver.get_transaction_sequence(
                    state,
                    state.world_state.constraints + [entry["retval"] == 1],
                )
                witness = solver.get_transaction_sequence(
                    state,
                    state.world_state.constraints + [entry["retval"] == 0],
                )
            except UnsatError:
                continue
            found.append(
                Issue(
                    title="Unchecked return value from external call.",
                    swc_id=UNCHECKED_RET_VAL,
                    severity="Medium",
                    description_head=(
                        "The return value of a message call is not checked."
                    ),
                    description_tail=REMEDIATION,
                    gas_used=gas_range(state),
                    transaction_sequence=witness,
                    **found_at(state, address=entry["address"]),
                )
            )
        return found


detector = UncheckedRetval()
