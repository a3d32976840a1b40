"""SWC-116/120: control flow depends on predictable block variables.

Covers mythril/analysis/module/modules/dependence_on_predictable_vars.py
— post-hooks on COINBASE/GASLIMIT/TIMESTAMP/NUMBER taint the pushed
symbol; BLOCKHASH of a potentially-old block taints too; the JUMPI
pre-hook reports branches on tainted values.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.module.module_helpers import is_prehook
from mythril_tpu_torch.analysis.swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import ULT, symbol_factory

log = logging.getLogger(__name__)

PREDICTABLE_OPS = ["COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER"]

REMEDIATION = (
    "Note that the values of variables like coinbase, gaslimit, block number and timestamp "
    "are predictable and can be manipulated by a malicious miner. Also keep in mind that "
    "attackers know hashes of earlier blocks. Don't use any of those environment variables "
    "as sources of randomness and be aware that use of these variables introduces "
    "a certain level of trust into miners."
)


class PredictableValueAnnotation:
    """Symbol annotation: value derives from a predictable env var."""

    def __init__(self, operation: str) -> None:
        self.operation = operation


class OldBlockNumberUsedAnnotation(StateAnnotation):
    """State annotation: BLOCKHASH was queried for a prior block."""


class PredictableVariables(ImmediateDetector):
    """Detects control-flow decisions on predictable parameters."""

    name = "Control flow depends on a predictable environment variable"
    swc_id = "{} {}".format(TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS)
    description = (
        "Check whether control flow decisions are influenced by block.coinbase,"
        "block.gaslimit, block.timestamp or block.number."
    )
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = ["BLOCKHASH"] + PREDICTABLE_OPS

    def _analyze_state(self, state: GlobalState) -> list:
        if is_prehook():
            opcode = state.get_current_instruction()["opcode"]
            if opcode == "JUMPI":
                return self._report_tainted_branch(state)
            # BLOCKHASH pre-hook: can the queried block be strictly
            # older than the current one? (upper bound on the block
            # number prevents overflow witnesses)
            height = state.mstate.stack[-1]
            in_the_past = [
                ULT(height, state.environment.block_number),
                ULT(
                    state.environment.block_number,
                    symbol_factory.BitVecVal(2**255, 256),
                ),
            ]
            try:
                solver.get_model(state.world_state.constraints + in_the_past)
                state.annotate(OldBlockNumberUsedAnnotation())
            except UnsatError:
                pass
            return []

        # post-hooks: taint the value the opcode just pushed
        produced_by = state.environment.code.instruction_list[
            state.mstate.pc - 1
        ]["opcode"]
        if produced_by == "BLOCKHASH":
            if any(state.get_annotations(OldBlockNumberUsedAnnotation)):
                state.mstate.stack[-1].annotate(
                    PredictableValueAnnotation(
                        "The block hash of a previous block"
                    )
                )
        else:
            state.mstate.stack[-1].annotate(
                PredictableValueAnnotation(
                    "The block.{} environment variable".format(
                        produced_by.lower()
                    )
                )
            )
        return []

    @staticmethod
    def _report_tainted_branch(state: GlobalState) -> list:
        findings = []
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        for taint in state.mstate.stack[-2].annotations:
            if not isinstance(taint, PredictableValueAnnotation):
                continue
            swc = (
                TIMESTAMP_DEPENDENCE
                if "timestamp" in taint.operation
                else WEAK_RANDOMNESS
            )
            if device_already_proved(state, swc):
                # a device lane concretely reached this branch; the
                # banked witness carries the issue
                continue
            try:
                witness = solver.get_transaction_sequence(
                    state, state.world_state.constraints
                )
            except UnsatError:
                continue
            findings.append(
                Issue(
                    swc_id=swc,
                    title="Dependence on predictable environment variable",
                    severity="Low",
                    description_head=(
                        "A control flow decision is made based on {}.".format(
                            taint.operation
                        )
                    ),
                    description_tail=(
                        taint.operation
                        + " is used to determine a control flow decision. "
                        + REMEDIATION
                    ),
                    gas_used=gas_range(state),
                    transaction_sequence=witness,
                    **found_at(state),
                )
            )
        return findings


detector = PredictableVariables()
