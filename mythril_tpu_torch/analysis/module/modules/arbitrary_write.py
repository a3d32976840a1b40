"""SWC-124: write to an attacker-chosen storage slot.

Covers mythril/analysis/module/modules/arbitrary_write.py. Two-phase:
the cheap local property is "the written slot can equal an arbitrary
sentinel value"; full validation happens at transaction end.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis.module.dsl import (
    DeferredDetector,
    PotentialIssue,
    found_at,
)
from mythril_tpu_torch.analysis.swc_data import WRITE_TO_ARBITRARY_STORAGE
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import symbol_factory

log = logging.getLogger(__name__)

#: arbitrary sentinel: a slot pinned by the storage layout can't equal it
SENTINEL_SLOT = 324345425435

REMEDIATION = (
    "It is possible to write to arbitrary storage locations. By modifying the values of "
    "storage variables, attackers may bypass security controls or manipulate the business logic of "
    "the smart contract."
)


class ArbitraryStorage(DeferredDetector):
    """Searches for a feasible write to an arbitrary storage slot."""

    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Search for any writes to an arbitrary storage slot"
    pre_hooks = ["SSTORE"]

    def _analyze_state(self, state: GlobalState) -> list:
        slot = state.mstate.stack[-1]
        reachable_with_sentinel = state.world_state.constraints + [
            slot == symbol_factory.BitVecVal(SENTINEL_SLOT, 256)
        ]
        return [
            PotentialIssue(
                swc_id=WRITE_TO_ARBITRARY_STORAGE,
                title="Write to an arbitrary storage location",
                severity="High",
                description_head=(
                    "The caller can write to arbitrary storage locations."
                ),
                description_tail=REMEDIATION,
                detector=self,
                constraints=reachable_with_sentinel,
                **found_at(state),
            )
        ]


detector = ArbitraryStorage()
