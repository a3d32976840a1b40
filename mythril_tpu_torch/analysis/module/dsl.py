"""Building blocks shared by every detection module.

The reference repeats the same scaffolding in all 14 modules
(mythril/analysis/module/modules/*): dedupe on the instruction
address, run the analysis, collect issues or potential issues, and
fill the same eight Issue fields from the state. Here that scaffolding
exists once:

  * `ImmediateDetector` — CALLBACK module that finishes its solving in
    the hook and reports `Issue`s directly.
  * `DeferredDetector` — CALLBACK module that pre-solves only a cheap
    property and parks a `PotentialIssue` on the state; the engine
    validates it at transaction end (two-phase flow,
    analysis/potential_issues.py).
  * `found_at(state)` — the Issue/PotentialIssue fields every detector
    copies out of the state.
  * `attacker_transactions(state)` — the "every message call comes
    from the attacker" constraint set detectors share.

Detector hooks receive states one at a time from the host engine but
whole lane vectors from the batched device engine — both arrive
through the HookBus opcode channels, so a module written against this
base runs on either engine unchanged.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.smt.bool import And

log = logging.getLogger(__name__)

__all__ = [
    "ACTORS",
    "DeferredDetector",
    "DetectionModule",
    "EntryPoint",
    "ImmediateDetector",
    "Issue",
    "PotentialIssue",
    "UnsatError",
    "attacker_transactions",
    "found_at",
]


def found_at(state: GlobalState, address: Optional[int] = None) -> dict:
    """The site-description fields shared by Issue and PotentialIssue,
    read off the offending state."""
    env = state.environment
    return dict(
        contract=env.active_account.contract_name,
        function_name=env.active_function_name,
        address=(
            address
            if address is not None
            else state.get_current_instruction()["address"]
        ),
        bytecode=env.code.bytecode,
    )


def gas_range(state: GlobalState) -> tuple:
    return (state.mstate.min_gas_used, state.mstate.max_gas_used)


def attacker_transactions(state: GlobalState, tie_origin: bool = False) -> list:
    """Constraints pinning every message call in the sequence to the
    attacker (optionally also requiring caller == origin, i.e. an EOA
    sender)."""
    out = []
    for tx in state.world_state.transaction_sequence:
        if isinstance(tx, ContractCreationTransaction):
            continue
        if tie_origin:
            out.append(And(tx.caller == ACTORS.attacker, tx.caller == tx.origin))
        else:
            out.append(tx.caller == ACTORS.attacker)
    return out


class ImmediateDetector(DetectionModule):
    """Solves its property in the hook and emits finished Issues.

    Subclasses implement `_analyze_state(state) -> List[Issue]`; the
    dedupe-by-address guard and issue collection live here. Set
    `dedupe = False` to analyze every hit of the same instruction.
    """

    entry_point = EntryPoint.CALLBACK
    dedupe = True

    def _execute(self, state: GlobalState) -> None:
        if self.dedupe and state.get_current_instruction()["address"] in self.cache:
            return
        found = self._analyze_state(state)
        for issue in found:
            self.cache.add(issue.address)
        self.issues.extend(found)

    def _analyze_state(self, state: GlobalState) -> List[Issue]:
        raise NotImplementedError


class DeferredDetector(DetectionModule):
    """Pre-solves a cheap property and parks PotentialIssues on the
    state for end-of-transaction validation."""

    entry_point = EntryPoint.CALLBACK
    dedupe = True

    def _execute(self, state: GlobalState) -> None:
        if self.dedupe and state.get_current_instruction()["address"] in self.cache:
            return
        found = self._analyze_state(state)
        get_potential_issues_annotation(state).potential_issues.extend(found)

    def _analyze_state(self, state: GlobalState) -> List[PotentialIssue]:
        raise NotImplementedError
