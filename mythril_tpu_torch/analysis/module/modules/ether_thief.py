"""SWC-105: anyone can profitably withdraw Ether.

Covers mythril/analysis/module/modules/ether_thief.py. The property:
a valid end state exists where the attacker's balance exceeds their
starting balance, with the attacker as an EOA sender.
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
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import UGT

log = logging.getLogger(__name__)

REMEDIATION = (
    "Arbitrary senders other than the contract creator can profitably extract Ether "
    "from the contract account. Verify the business logic carefully and make sure that appropriate "
    "security controls are in place to prevent unexpected loss of funds."
)


class EtherThief(DeferredDetector):
    """Searches for cases where Ether can be withdrawn to a
    user-specified address."""

    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = (
        "Search for cases where Ether can be withdrawn to a user-specified"
        " address. An issue is reported if there is a valid end state where"
        " the attacker has successfully increased their Ether balance."
    )
    post_hooks = ["CALL", "STATICCALL"]

    def _analyze_state(self, state: GlobalState) -> list:
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        if device_already_proved(
            state,
            UNPROTECTED_ETHER_WITHDRAWAL,
            address=state.get_current_instruction()["address"] - 1,
        ):
            # a device lane concretely sent value to the attacker from
            # this call site; the banked witness carries the issue
            return []
        state = copy(state)
        world = state.world_state

        attacker_profits = copy(world.constraints) + [
            UGT(
                world.balances[ACTORS.attacker],
                world.starting_balances[ACTORS.attacker],
            ),
            state.environment.sender == ACTORS.attacker,
            state.current_transaction.caller
            == state.current_transaction.origin,
        ]

        try:
            # pre-solve: raise a potential issue only when the profit
            # property is satisfiable on this path
            solver.get_model(attacker_profits)
        except UnsatError:
            return []

        return [
            PotentialIssue(
                swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
                title="Unprotected Ether Withdrawal",
                severity="High",
                description_head=(
                    "Any sender can withdraw Ether from the contract account."
                ),
                description_tail=REMEDIATION,
                detector=self,
                constraints=attacker_profits,
                # post hook: report the offset of the CALL itself
                **found_at(
                    state,
                    address=state.get_current_instruction()["address"] - 1,
                ),
            )
        ]


detector = EtherThief()
