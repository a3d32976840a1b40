"""SWC-110: reachable assert violation (INVALID/0xfe).

Covers mythril/analysis/module/modules/exceptions.py.
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
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

REMEDIATION = (
    "It is possible to trigger an assertion violation. Note that Solidity assert() statements should "
    "only be used to check invariants. Review the transaction trace generated for this issue and "
    "either make sure your program logic is correct, or use require() instead of assert() if your goal "
    "is to constrain user inputs or enforce preconditions. Remember to validate inputs from both callers "
    "(for instance, via passed arguments) and callees (for instance, via return values)."
)


class Exceptions(ImmediateDetector):
    """Checks whether any exception state (ASSERT_FAIL) is reachable."""

    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = "Checks whether any exception states are reachable."
    pre_hooks = ["ASSERT_FAIL"]

    def _analyze_state(self, state: GlobalState) -> list:
        log.debug(
            "ASSERT_FAIL in function %s",
            state.environment.active_function_name,
        )
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        if device_already_proved(state, ASSERT_VIOLATION):
            # the device prepass banked a concrete witness here; its
            # issue merges in at fire_lasers — skip the Optimize query
            return []
        try:
            witness = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            log.debug("no model found")
            return []
        return [
            Issue(
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                description_head="An assertion violation was triggered.",
                description_tail=REMEDIATION,
                transaction_sequence=witness,
                gas_used=gas_range(state),
                **found_at(state),
            )
        ]


detector = Exceptions()
