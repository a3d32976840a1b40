"""SWC-127: jump to a caller-controlled destination.

Covers mythril/analysis/module/modules/arbitrary_jump.py.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ARBITRARY_JUMP
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

REMEDIATION = (
    "It is possible to redirect the control flow to arbitrary locations in the code. "
    "This may allow an attacker to bypass security controls or manipulate the business logic of the "
    "smart contract. Avoid using low-level-operations and assembly to prevent this issue."
)


class ArbitraryJump(ImmediateDetector):
    """Flags JUMP/JUMPI whose destination stays symbolic (and is
    therefore attacker-influenceable)."""

    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = "Search for jumps to arbitrary locations in the bytecode"
    pre_hooks = ["JUMP", "JUMPI"]

    def _execute(self, state: GlobalState) -> None:
        # reference quirk kept: the cache is consulted but never fed,
        # so repeated hits re-report (golden outputs depend on it)
        if state.get_current_instruction()["address"] in self.cache:
            return
        self.issues.extend(self._analyze_state(state))

    def _analyze_state(self, state: GlobalState) -> list:
        if state.mstate.stack[-1].symbolic is False:
            return []
        try:
            witness = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            return []
        return [
            Issue(
                swc_id=ARBITRARY_JUMP,
                title="Jump to an arbitrary instruction",
                severity="High",
                description_head=(
                    "The caller can redirect execution to arbitrary bytecode locations."
                ),
                description_tail=REMEDIATION,
                gas_used=gas_range(state),
                transaction_sequence=witness,
                **found_at(state),
            )
        ]


detector = ArbitraryJump()
