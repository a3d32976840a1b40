"""SWC-112: delegatecall to an attacker-supplied address.

Covers mythril/analysis/module/modules/delegatecall.py.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis.module.dsl import (
    ACTORS,
    DeferredDetector,
    PotentialIssue,
    found_at,
)
from mythril_tpu_torch.analysis.swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.smt import UGT, symbol_factory

log = logging.getLogger(__name__)

REMEDIATION = (
    "The smart contract delegates execution to a user-supplied address."
    "This could allow an attacker to execute arbitrary code in the context of this contract "
    "account and manipulate the state of the contract account or execute actions on its behalf."
)


class ArbitraryDelegateCall(DeferredDetector):
    """Detects delegatecall to a user-supplied address."""

    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = (
        "Check for invocations of delegatecall to a user-supplied address."
    )
    pre_hooks = ["DELEGATECALL"]

    def _analyze_state(self, state: GlobalState) -> list:
        gas, target = state.mstate.stack[-1], state.mstate.stack[-2]
        here = state.get_current_instruction()["address"]

        property_constraints = [
            target == ACTORS.attacker,
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            state.new_bitvec(f"retval_{here}", 256) == 1,
        ]
        # every message call in the sequence must come from the attacker
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                property_constraints.append(tx.caller == ACTORS.attacker)

        log.debug(
            "[DELEGATECALL] Detected potential delegatecall to a "
            "user-supplied address: %s",
            here,
        )
        return [
            PotentialIssue(
                swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
                title="Delegatecall to user-supplied address",
                severity="High",
                description_head=(
                    "The contract delegates execution to another contract "
                    "with a user-supplied address."
                ),
                description_tail=REMEDIATION,
                constraints=property_constraints,
                detector=self,
                **found_at(state),
            )
        ]


detector = ArbitraryDelegateCall()
