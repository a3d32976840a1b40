"""Corpus analysis on the card: the device half of the JAX package's
analysis/corpus.py.

One lane-striped device exploration (laser/batch/explore.py
`DeviceCorpusExplorer`) runs over the whole corpus; every contract whose
exploration the ownership gate accepts (`_outcome_owns`: frontier
closed, no degraded lanes, no dropped carries) is OWNED, and its issues
are synthesized from the banked concrete evidence (analysis/prepass.py,
analysis/evidence.py) with no host walk.

What the port leaves out, and how it says so:

- the host walk (`_analyze_one`: SymExecWrapper + fire_lasers) is not
  ported. A contract the device does not own gets an explicit result,
  `complete: False`, `owned: False`, with an `error` naming the missing
  walk, never an empty issue list that reads as clean; and
  `--device-ownership never`, which asks for the walk alone, raises;
- a prepass failure raises (the JAX package returns no outcomes so that
  its host walk carries on; here that would print an empty report);
- the multi-chip scheduler (`mesh_groups > 1`) raises, as the explorer's
  other unported options do;
- the verdict store (and with it the selector masks), the static and
  routing triage, and the overlapped prepass (which exists only to
  overlap the host walk) are not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: corpus size from which the prepass runs lean-cap waves and narrower
#: stripes (the JAX package's overlap threshold, which sizes both)
OVERLAP_MIN_CORPUS = 32

#: per-lane (memory bytes, storage slots) below and from OVERLAP_MIN_CORPUS
ROOMY_CAPS = (16384, 128)
LEAN_CAPS = (4096, 64)

#: the explorer's wave cap a phase: the budget is the real limiter, the
#: cap only backstops a runaway phase (the JAX package's 48)
PREPASS_WAVES = 48

DEFAULT_ADDRESS = 0x901D573B8CE8C997DE5F19173C32D966B4FA55FE

#: why a contract the device did not own has no issue list
HOST_WALK_MISSING = (
    "not analyzed: the device exploration did not own this contract, and "
    "the host walk (SymExecWrapper + fire_lasers) that would analyze it "
    "is not ported"
)


def resolve_prepass_budget_s(
    n_contracts: int, execution_timeout: Optional[float] = None
) -> float:
    """Default ACTIVE-time budget (waves + flip solving) for the striped
    corpus prepass under ownership.

    Every contract the exploration completes refunds its whole host walk
    (up to execution_timeout each), so the budget scales with the walk
    ceiling: up to half the refundable wall, bounded per corpus size.
    Early exits (per-contract parking, frontier exhaustion, coverage
    plateau) stop the spend well short of the budget on corpora that
    converge. With no walk ceiling the JAX package's witness-injection
    curve stands: small corpora 1s/contract, large corpora 0.5s/contract
    capped at 120s."""
    n = max(1, n_contracts)
    if execution_timeout:
        return min(0.5 * execution_timeout * n, 30.0 + 5.0 * n, 300.0)
    if n >= OVERLAP_MIN_CORPUS:
        return min(120.0, max(30.0, 0.5 * n))
    return min(30.0, 1.0 * n)


def _runnable_rows(
    contracts: List[Tuple[str, str, str]],
) -> List[Tuple[int, str]]:
    """(index, normalized runtime hex) for every contract the device
    prepass can execute: the filter both the prepass and its budget
    sizing share."""
    rows = []
    for idx, (code, _creation, _name) in enumerate(contracts):
        code = code[2:] if code.startswith("0x") else code
        if len(code) >= 8:
            rows.append((idx, code))
    return rows


def corpus_device_prepass(
    contracts: List[Tuple[str, str, str]],
    budget_s: Optional[float] = None,
    address: int = DEFAULT_ADDRESS,
    transaction_count: int = 1,
    stop_event=None,
    execution_timeout: Optional[float] = None,
    deadline=None,
    mesh_groups: Optional[int] = None,
    waves: int = PREPASS_WAVES,
    device=None,
) -> Dict[int, Dict]:
    """One striped device exploration over the corpus, on `device`
    (None: the card); returns {contract_index: single-contract prepass
    outcome} (indexed, not named: corpus rows may share names). A
    failure of the exploration raises, after a PREPASS_FAILED record.

    The geometry is the JAX package's: calldata the longest
    `required_calldata_len`, ROOMY_CAPS and 32 lanes a contract below
    OVERLAP_MIN_CORPUS contracts, LEAN_CAPS from there, 16 lanes from 64
    contracts, 512 steps a wave and `waves` (48) waves a phase under the
    active-time budget."""
    from mythril_tpu_torch.laser.batch.explore import (
        DeviceCorpusExplorer,
        required_calldata_len,
    )
    from mythril_tpu_torch.observe.spans import trace
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    if mesh_groups is not None and mesh_groups > 1:
        raise NotImplementedError(
            "the multi-chip corpus scheduler is not ported: the prepass "
            "runs one engine on one card"
        )
    runnable = _runnable_rows(contracts)
    if not runnable:
        return {}
    if budget_s is None:
        budget_s = resolve_prepass_budget_s(len(runnable), execution_timeout)
    mem_cap, storage_cap = (
        LEAN_CAPS if len(runnable) >= OVERLAP_MIN_CORPUS else ROOMY_CAPS
    )
    try:
        explorer = DeviceCorpusExplorer(
            [code for _, code in runnable],
            calldata_len=max(required_calldata_len(code) for _, code in runnable),
            mem_cap=mem_cap,
            storage_cap=storage_cap,
            lanes_per_contract=16 if len(runnable) >= 64 else 32,
            waves=waves,
            steps_per_wave=512,
            budget_s=budget_s,
            address=address,
            transaction_count=transaction_count,
            stop_event=stop_event,
            deadline=deadline,
            device=device,
        )
        with trace("corpus.prepass", contracts=len(runnable)):
            result = explorer.run()
    except Exception:
        DegradationLog().record(
            DegradationReason.PREPASS_FAILED, site="corpus-prepass"
        )
        raise
    stats = result["stats"]
    log.info(
        "Corpus device prepass: %d contracts, %d lane-steps over %d waves "
        "in %.1fs, %d branch directions covered",
        len(runnable),
        stats["device_steps"],
        stats["waves"],
        stats["wall_s"],
        stats["branches_covered"],
    )
    outcomes = {}
    for (idx, _code), outcome in zip(runnable, result["contracts"]):
        # the stats block is CORPUS-WIDE (one striped exploration); it
        # rides along on every outcome, marked so consumers don't sum it
        # per contract
        outcome["stats"] = dict(stats, scope="corpus")
        outcomes[idx] = outcome
    return outcomes


def _ownership_enabled() -> bool:
    """Resolve --device-ownership: the port always runs the device axis,
    so only `never` turns ownership off."""
    from mythril_tpu_torch.support.support_args import args

    return getattr(args, "device_ownership", "auto") != "never"


def _outcome_owns(outcome: Optional[Dict]) -> bool:
    """True when a FINAL prepass outcome covered the contract end to end
    (explore.py `device_complete`): frontier closed, no degraded lanes,
    no dropped carries. Partial (mid-exploration) outcomes never own,
    unless the explorer froze this contract early (`final_for_contract`:
    all gates green in the last phase, track parked, evidence
    immutable)."""
    return bool(
        outcome
        and outcome.get("device_complete")
        and (
            outcome.get("final_for_contract")
            or not (outcome.get("stats") or {}).get("partial")
        )
    )


def _maybe_ownable(outcome: Optional[Dict]) -> bool:
    """Could a still-running prepass still hand this contract over?
    False the moment an outcome shows a hard ownership failure (degraded
    lanes, dropped carries, saturated event bank): those gates only ever
    get worse."""
    if outcome is None:
        return True  # no information yet
    gates = outcome.get("completeness_gates") or {}
    return (
        gates.get("no_degraded", True)
        and gates.get("no_carry_overflow", True)
        and gates.get("no_event_overflow", True)
    )


def _owned_result(code, creation_code, name, outcome, address) -> Dict:
    """The analysis result for a device-owned contract: issues are
    synthesized from the banked concrete evidence (witness issues +
    evidence issues); no host walk runs. A synthesis fault raises: there
    is no walk to fall back to, and a smaller issue set must not pass
    for the analysis. `issue_objects` holds the `Issue`s the report is
    built from (`issues` their dicts, as in the JAX package)."""
    from mythril_tpu_torch.analysis.prepass import witness_issues
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract

    contract = EVMContract(
        code=code or "", creation_code=creation_code or "", name=name
    )
    issues = witness_issues(contract, outcome, address)
    stats = dict(outcome.get("stats") or {}, scope="corpus", owned=True)
    return {
        "name": name,
        "issues": [issue.as_dict for issue in issues],
        "issue_objects": issues,
        "device_prepass": stats,
        "owned": True,
        "error": None,
    }


def _unowned_result(name: str, outcome: Optional[Dict]) -> Dict:
    """The result for a contract the device did not own: explicitly
    incomplete, with the gates that failed, because the host walk that
    would analyze it is not ported."""
    if outcome is None:
        why = "no device outcome: runtime code shorter than 4 bytes"
    else:
        gates = outcome.get("completeness_gates") or {}
        failed = ", ".join(sorted(k for k, ok in gates.items() if not ok))
        # a hard failure (degraded lanes, dropped carries or events) no
        # longer exploration can repair; a soft one (the frontier still
        # open) more waves or budget might
        why = "%s gate failure: %s" % (
            "soft" if _maybe_ownable(outcome) else "hard",
            failed or "none (partial run)",
        )
    return {
        "name": name,
        "issues": [],
        "issue_objects": [],
        "device_prepass": (
            dict(outcome.get("stats") or {}, scope="corpus")
            if outcome is not None
            else None
        ),
        "owned": False,
        "error": f"{HOST_WALK_MISSING} ({why})",
    }


def _skipped_result(name: str, reason: str) -> Dict:
    """The result slot for a contract the supervisor never analyzed
    (deadline expiry / SIGTERM): same shape as an analyzed result,
    explicitly marked so the partial report can say which contracts are
    missing and why."""
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    DegradationLog().record(
        DegradationReason.CONTRACT_SKIPPED,
        site="corpus",
        detail=reason,
        contract=name,
    )
    return {
        "name": name,
        "issues": [],
        "issue_objects": [],
        "device_prepass": None,
        "error": None,
        "skipped": reason,
    }


def analyze_corpus(
    contracts: List[Tuple[str, str, str]],
    address: int = DEFAULT_ADDRESS,
    transaction_count: int = 2,
    execution_timeout: int = 60,
    device_budget_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    devices: Optional[int] = None,
    waves: int = PREPASS_WAVES,
    device=None,
) -> List[Dict]:
    """Analyze `contracts` = [(runtime_code_hex, creation_code_hex,
    name), ...] through one striped device prepass on `device` (None:
    the card) and the ownership gate. Returns one result dict per
    contract ({name, issues, issue_objects, owned, error, complete,
    device_prepass, ...}).

    Owned contracts carry the issues synthesized from their evidence.
    Every other contract is `complete: False` with an `error` naming the
    missing host walk. With `deadline_s` (falling back to the
    process-global run deadline) an expired budget, or a SIGINT/SIGTERM
    under `resilience.graceful_shutdown()`, marks the contracts not yet
    reported as skipped; owned contracts still report in full.
    `waves` caps the explorer's waves a phase (tests and chip_smoke.py
    pass a small cap so that a run does not depend on the wall clock;
    `device_budget_s` then still applies)."""
    from mythril_tpu_torch.support import resilience

    if not _ownership_enabled():
        raise NotImplementedError(
            "--device-ownership never sends every contract to the host "
            "walk, which is not ported"
        )
    deadline = (
        resilience.run_deadline()
        if deadline_s is None
        else resilience.Deadline(deadline_s, label="corpus")
    )
    prepass = corpus_device_prepass(
        contracts,
        budget_s=device_budget_s,
        address=address,
        transaction_count=transaction_count,
        execution_timeout=execution_timeout,
        deadline=deadline,
        stop_event=resilience.shutdown_event(),
        mesh_groups=devices,
        waves=waves,
        device=device,
    )
    results = []
    halt_reason = None
    for i, (code, creation_code, name) in enumerate(contracts):
        outcome = prepass.get(i)
        if _outcome_owns(outcome):
            # synthesis is cheap (no walk, no solver), so an owned
            # contract reports in full even after a halt
            results.append(
                _owned_result(code, creation_code, name, outcome, address)
            )
            continue
        if halt_reason is None:
            halt_reason = resilience.interrupted_reason(deadline)
        if halt_reason is not None:
            results.append(_skipped_result(name, halt_reason))
            continue
        results.append(_unowned_result(name, outcome))
    for i, result in enumerate(results):
        # per-contract completion status, first-class in the result
        # (and from there in the json/jsonv2 report meta)
        result["complete"] = (
            not result.get("skipped") and result.get("error") is None
        )
        result["device_complete"] = bool(
            (prepass.get(i) or {}).get("device_complete")
        )
    return results
