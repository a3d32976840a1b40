"""Two-phase issue flow.

Covers mythril/analysis/potential_issues.py. Detection modules
pre-solve only their cheap local property and park a `PotentialIssue`
on the state; when the engine finishes a transaction it calls
`check_potential_issues`, which solves the full path + property
constraints and, on sat, concretizes the exploit transactions and
promotes the finding onto its detector.
"""

from __future__ import annotations

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

#: the fields a PotentialIssue shares verbatim with the Issue it becomes
_CARRIED_FIELDS = (
    "title",
    "contract",
    "function_name",
    "address",
    "description_head",
    "description_tail",
    "severity",
    "swc_id",
    "bytecode",
)


class PotentialIssue:
    """A finding whose cheap precondition was satisfiable; full
    validation is deferred to transaction end."""

    def __init__(self, detector, constraints=None, **fields):
        self.detector = detector
        self.constraints = constraints or []
        for name in _CARRIED_FIELDS:
            setattr(self, name, fields.pop(name, "" if "descr" in name else None))
        if fields:
            raise TypeError(f"unknown PotentialIssue fields: {sorted(fields)}")

    def promote(self, state: GlobalState, transaction_sequence) -> Issue:
        """The finished Issue, with gas bounds and the concrete
        witness filled in from the validating state."""
        return Issue(
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
            **{name: getattr(self, name) for name in _CARRIED_FIELDS},
        )


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues = []


def get_potential_issues_annotation(state: GlobalState) -> PotentialIssuesAnnotation:
    """The state's potential-issues annotation (created on demand)."""
    existing = next(iter(state.get_annotations(PotentialIssuesAnnotation)), None)
    if existing is not None:
        return existing
    fresh = PotentialIssuesAnnotation()
    state.annotate(fresh)
    return fresh


def check_potential_issues(state: GlobalState) -> None:
    """Validate every pending potential issue against the full path
    constraints; sat findings move onto their detectors as Issues.

    Candidates the device prepass already holds a concrete witness for
    (same code, address, and SWC class) skip the expensive validation
    solve — the banked device issue carries the finding with an
    identical fingerprint (analysis/evidence.py)."""
    from mythril_tpu_torch.analysis.prepass import device_already_proved

    pending = get_potential_issues_annotation(state)
    for candidate in pending.potential_issues[:]:
        if device_already_proved(
            state, candidate.swc_id, address=candidate.address
        ):
            pending.potential_issues.remove(candidate)
            candidate.detector.cache.add(candidate.address)
            continue
        try:
            witness = get_transaction_sequence(
                state, state.world_state.constraints + candidate.constraints
            )
        except UnsatError:
            continue
        pending.potential_issues.remove(candidate)
        candidate.detector.cache.add(candidate.address)
        candidate.detector.issues.append(candidate.promote(state, witness))
