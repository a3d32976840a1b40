"""SWC-107: state access after an external call (reentrancy pattern).

Covers mythril/analysis/module/modules/state_change_external_calls.py.
A gas-forwarding external call annotates the path; any later storage
access (or value-bearing call) on that path becomes a potential issue
validated at transaction end.
"""

from __future__ import annotations

import logging
from copy import copy
from typing import List, Optional

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    DeferredDetector,
    DetectionModule,
    PotentialIssue,
    UnsatError,
    found_at,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import BitVec, Or, UGT, symbol_factory

log = logging.getLogger(__name__)

CALL_OPS = ("CALL", "DELEGATECALL", "CALLCODE")
STATE_OPS = ("SSTORE", "SLOAD", "CREATE", "CREATE2")

# shared with analysis/evidence.py — device-evidence SWC-107 issues must
# carry byte-identical text so report dedupe collapses the two paths
DESCRIPTION_TAIL_TEMPLATE = (
    "The contract account state is accessed after an external call to a {} address. "
    "To prevent reentrancy issues, consider accessing the state only before the call, especially if the "
    "callee is untrusted. Alternatively, a reentrancy lock can be used to prevent "
    "untrusted callees from re-entering the contract in an intermediate state."
)

ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF


def _forwarding_call_constraints(call_state: GlobalState) -> Constraints:
    """The call forwards real gas to a non-precompile callee."""
    gas = call_state.mstate.stack[-1]
    to = call_state.mstate.stack[-2]
    return Constraints(
        [
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            Or(
                to > symbol_factory.BitVecVal(16, 256),
                to == symbol_factory.BitVecVal(0, 256),
            ),
        ]
    )


class StateChangeCallsAnnotation(StateAnnotation):
    """Marks a path that performed a gas-forwarding external call."""

    def __init__(self, call_state: GlobalState, user_defined_address: bool):
        self.call_state = call_state
        self.state_change_states: List[GlobalState] = []
        self.user_defined_address = user_defined_address

    def __copy__(self):
        twin = StateChangeCallsAnnotation(
            self.call_state, self.user_defined_address
        )
        twin.state_change_states = self.state_change_states[:]
        return twin

    def get_issue(
        self, global_state: GlobalState, detector: DetectionModule
    ) -> Optional[PotentialIssue]:
        if not self.state_change_states:
            return None

        call_constraints = _forwarding_call_constraints(self.call_state)
        if self.user_defined_address:
            call_constraints += [
                self.call_state.mstate.stack[-2] == ATTACKER_ADDRESS
            ]

        try:
            solver.get_transaction_sequence(
                global_state,
                call_constraints + global_state.world_state.constraints,
            )
        except UnsatError:
            return None

        here = global_state.get_current_instruction()
        log.debug(
            "[EXTERNAL_CALLS] Detected state changes at address: %s",
            here["address"],
        )
        access_kind = "Read of" if here["opcode"] == "SLOAD" else "Write to"
        address_kind = "user defined" if self.user_defined_address else "fixed"

        return PotentialIssue(
            title="State access after external call",
            severity="Medium" if self.user_defined_address else "Low",
            description_head=(
                f"{access_kind} persistent state following external call"
            ),
            description_tail=DESCRIPTION_TAIL_TEMPLATE.format(address_kind),
            swc_id=REENTRANCY,
            constraints=call_constraints,
            detector=detector,
            **found_at(global_state),
        )


class StateChangeAfterCall(DeferredDetector):
    """Searches for state changes after gas-forwarding external calls."""

    name = "State change after an external call"
    swc_id = REENTRANCY
    description = (
        "Check whether the account state is accessed after the execution"
        " of an external call"
    )
    pre_hooks = list(CALL_OPS + STATE_OPS)

    def _analyze_state(self, state: GlobalState) -> List[PotentialIssue]:
        open_calls = list(state.get_annotations(StateChangeCallsAnnotation))
        opcode = state.get_current_instruction()["opcode"]

        if opcode in STATE_OPS:
            for call in open_calls:
                call.state_change_states.append(state)
        elif opcode in CALL_OPS:
            # a value-bearing call is itself a balance mutation
            if self._value_may_flow(state.mstate.stack[-3], state):
                for call in open_calls:
                    call.state_change_states.append(state)
            self._register_call(state)

        findings = []
        for call in open_calls:
            if not call.state_change_states:
                continue
            issue = call.get_issue(state, self)
            if issue:
                findings.append(issue)
        return findings

    @staticmethod
    def _register_call(state: GlobalState) -> None:
        """Annotate the path if this call forwards gas; classify the
        callee address as attacker-choosable or fixed."""
        base = copy(state.world_state.constraints)
        try:
            solver.get_model(base + _forwarding_call_constraints(state))
        except UnsatError:
            return
        try:
            solver.get_model(
                base + [state.mstate.stack[-2] == ATTACKER_ADDRESS]
            )
            state.annotate(StateChangeCallsAnnotation(state, True))
        except UnsatError:
            state.annotate(StateChangeCallsAnnotation(state, False))

    @staticmethod
    def _value_may_flow(value: BitVec, state: GlobalState) -> bool:
        if not value.symbolic:
            assert value.value is not None
            return value.value > 0
        try:
            solver.get_model(
                copy(state.world_state.constraints)
                + [value > symbol_factory.BitVecVal(0, 256)]
            )
            return True
        except UnsatError:
            return False


detector = StateChangeAfterCall()
