"""SWC-107 (reentrancy surface): call to a user-supplied address with
unrestricted gas.

Covers mythril/analysis/module/modules/external_calls.py.
"""

from __future__ import annotations

import logging
from copy import copy

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ACTORS,
    DeferredDetector,
    PotentialIssue,
    UnsatError,
    found_at,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import BitVec, Or, UGT, symbol_factory

log = logging.getLogger(__name__)

REMEDIATION = (
    "An external message call to an address specified by the caller is executed. Note that "
    "the callee account might contain arbitrary code and could re-enter any function "
    "within this contract. Reentering the contract in an intermediate state may lead to "
    "unexpected behaviour. Make sure that no state modifications "
    "are executed after this call and/or reentrancy guards are in place."
)


def _is_precompile_call(global_state: GlobalState) -> bool:
    to: BitVec = global_state.mstate.stack[-2]
    outside_precompiles = copy(global_state.world_state.constraints) + [
        Or(
            to < symbol_factory.BitVecVal(1, 256),
            to > symbol_factory.BitVecVal(PRECOMPILE_COUNT, 256),
        )
    ]
    try:
        solver.get_model(outside_precompiles)
        return False
    except UnsatError:
        return True


class ExternalCalls(DeferredDetector):
    """Searches for low-level calls that forward all gas to an
    attacker-controlled callee."""

    name = "External call to another contract"
    swc_id = REENTRANCY
    description = (
        "Search for external calls with unrestricted gas to a"
        " user-specified address."
    )
    pre_hooks = ["CALL"]
    dedupe = False  # the reference re-analyzes every hit

    def _analyze_state(self, state: GlobalState) -> list:
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        if device_already_proved(state, REENTRANCY):
            # a device lane concretely called the attacker from this
            # site with forwarded gas; the banked witness carries it
            return []
        gas, target = state.mstate.stack[-1], state.mstate.stack[-2]

        attack_property = Constraints(
            [
                UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                target == ACTORS.attacker,
            ]
        )
        try:
            solver.get_transaction_sequence(
                state, attack_property + state.world_state.constraints
            )
        except UnsatError:
            log.debug("[EXTERNAL_CALLS] No model found.")
            return []

        return [
            PotentialIssue(
                swc_id=REENTRANCY,
                title="External Call To User-Supplied Address",
                severity="Low",
                description_head=(
                    "A call to a user-supplied address is executed."
                ),
                description_tail=REMEDIATION,
                constraints=attack_property,
                detector=self,
                **found_at(state),
            )
        ]


detector = ExternalCalls()
