"""SWC-115: control flow depends on tx.origin.

Covers mythril/analysis/module/modules/dependence_on_origin.py — the
ORIGIN post-hook taints the pushed symbol; the JUMPI pre-hook reports
branches decided by a tainted value.
"""

from __future__ import annotations

import logging
from copy import copy

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.swc_data import TX_ORIGIN_USAGE
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

REMEDIATION = (
    "The tx.origin environment variable has been found to influence a control flow decision. "
    "Note that using tx.origin as a security control might cause a situation where a user "
    "inadvertently authorizes a smart contract to perform an action on their behalf. It is "
    "recommended to use msg.sender instead."
)


class TxOriginAnnotation:
    """Symbol annotation marking a value derived from ORIGIN."""


class TxOrigin(ImmediateDetector):
    """Detects branches that depend on the transaction origin."""

    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = (
        "Check whether control flow decisions are influenced by tx.origin"
    )
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]

    def _analyze_state(self, state: GlobalState) -> list:
        if state.get_current_instruction()["opcode"] != "JUMPI":
            # ORIGIN post-hook: taint the freshly pushed value
            state.mstate.stack[-1].annotate(TxOriginAnnotation())
            return []

        # JUMPI pre-hook: is the branch guard tainted?
        tainted = any(
            isinstance(a, TxOriginAnnotation)
            for a in state.mstate.stack[-2].annotations
        )
        if not tainted:
            return []
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        if device_already_proved(state, TX_ORIGIN_USAGE):
            # a device lane concretely reached this origin-guarded
            # branch; the banked witness carries the issue
            return []
        try:
            witness = solver.get_transaction_sequence(
                state, copy(state.world_state.constraints)
            )
        except UnsatError:
            return []
        # the JUMPI maps to the if/require in source
        return [
            Issue(
                swc_id=TX_ORIGIN_USAGE,
                title="Dependence on tx.origin",
                severity="Low",
                description_head=(
                    "Use of tx.origin as a part of authorization control."
                ),
                description_tail=REMEDIATION,
                gas_used=gas_range(state),
                transaction_sequence=witness,
                **found_at(state),
            )
        ]


detector = TxOrigin()
