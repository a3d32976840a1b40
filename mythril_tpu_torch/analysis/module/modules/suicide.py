"""SWC-106: anyone can SELFDESTRUCT the contract.

Covers mythril/analysis/module/modules/suicide.py — tries the
stronger property first (balance flows to the attacker); falls back to
the weaker killable-by-anyone variant when that is unsat.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ACTORS,
    ImmediateDetector,
    Issue,
    UnsatError,
    attacker_transactions,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_SELFDESTRUCT
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

TAIL_WITH_THEFT = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to destroy this "
    "contract account and withdraw its balance to an arbitrary address. Review the transaction trace "
    "generated for this issue and make sure that appropriate security controls are in place to prevent "
    "unrestricted access."
)
TAIL_KILL_ONLY = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to destroy this "
    "contract account. Review the transaction trace generated for this issue and make sure that "
    "appropriate security controls are in place to prevent unrestricted access."
)


class AccidentallyKillable(ImmediateDetector):
    """Checks if the contract can be 'accidentally' killed by anyone."""

    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = (
        "Check if the contact can be 'accidentally' killed by anyone. For"
        " kill-able contracts, also check whether it is possible to direct"
        " the contract balance to the attacker."
    )
    pre_hooks = ["SUICIDE"]

    def __init__(self):
        super().__init__()
        self._cache_address = {}

    def _analyze_state(self, state: GlobalState) -> list:
        log.debug(
            "SUICIDE in function %s", state.environment.active_function_name
        )
        # (no device-witness pre-emption here: this module's two-tier
        # property — balance theft before kill-only — is strictly
        # richer than the prepass's reachability witness, so the host
        # solve runs and fire_lasers dedups the weaker device issue)
        beneficiary = state.mstate.stack[-1]
        attacker_only = attacker_transactions(state, tie_origin=True)
        base = state.world_state.constraints + attacker_only

        try:
            try:
                witness = solver.get_transaction_sequence(
                    state, base + [beneficiary == ACTORS.attacker]
                )
                tail = TAIL_WITH_THEFT
            except UnsatError:
                witness = solver.get_transaction_sequence(state, base)
                tail = TAIL_KILL_ONLY
        except UnsatError:
            log.debug("No model found")
            return []

        return [
            Issue(
                swc_id=UNPROTECTED_SELFDESTRUCT,
                title="Unprotected Selfdestruct",
                severity="High",
                description_head=(
                    "Any sender can cause the contract to self-destruct."
                ),
                description_tail=tail,
                transaction_sequence=witness,
                gas_used=gas_range(state),
                **found_at(state),
            )
        ]


detector = AccidentallyKillable()
