"""Corpus analysis on the card: the port's copy of the JAX package's
analysis/corpus.py, single-process.

One lane-striped device exploration (laser/batch/explore.py
`DeviceCorpusExplorer`) runs over the whole corpus; every contract whose
exploration the ownership gate accepts (`_outcome_owns`: frontier
closed, no degraded lanes, no dropped carries) is OWNED, and its issues
are synthesized from the banked concrete evidence (analysis/prepass.py,
analysis/evidence.py) with no host walk. Every other contract, and every
contract under `--device-ownership never`, goes through the host walk
(`_analyze_one`: SymExecWrapper + fire_lasers) with its prepass outcome
injected.

`analyze_corpus` takes the JAX schedule: the prepass runs on a thread
of its own beside the walks (`OverlappedPrepass`, smallest code first,
with the JAX drain window) when the device axis is on, the corpus has
more than one contract, and either this process may run on more than one
CPU (`_effective_cpus`) or OVERLAP_MIN_CORPUS rows are runnable;
otherwise the prepass runs first and the walks after it, so that their
solver races have the card to themselves. `use_device=False` is the
host-only leg (no prepass, every walk under `device_prepass` and
`device_solving` "never": nothing launches on the card);
`deterministic_solving` is scoped to the call; `on_timeout="fail"`
raises DeadlineExpiredError when a contract was skipped.

The corpus tiers run before the prepass, as in the JAX package: the
corpus link pass (analysis/static/linkset.py `link_corpus`, whenever
static pruning is on), the verdict store's triage (store/: exact
(codehash, config-fingerprint) hits settle at once, near-duplicate forks
and callee upgrades behind unchanged code get an `IncrementalPlan`,
whose selector masks reach the explorer through `corpus_device_prepass`
and `OverlappedPrepass`), then the static-answer triage. After the
walks, every complete full analysis writes its verdict back, and every
linked result carries the link pass's `link` and `link_run` blocks.

Where the port differs, and how it says so:

- `use_device=None` means the card (`device`, None: the card, which
  must be there), where the JAX package asks whether an accelerator is
  present;
- a prepass failure raises (the JAX package returns no outcomes so that
  its host walk carries on without the card);
- a walk that raises is recorded in the result's `error`, and the
  contract is `complete: False`, as in the JAX package;
- the multi-chip scheduler (`mesh_groups > 1`) raises, as the explorer's
  other unported options do;
- the pooled walk (`processes > 1`) raises;
- the learned router (routing/, `router_dir`, `router`) is the JAX
  one: host-routed rows leave the device prepass, a host-routed walk
  that overran its budget (or raised) gets one promotion prepass on the
  card (`_promote_overruns`), and every result writes a routing record
  (`_emit_routing_records`). A router that raises while it loads or
  decides is recorded in the DegradationLog (`router-failed`) and a
  routing record that cannot be built `routing-record-failed`, where
  the JAX package only logs them; the built-in ladder stands for that
  call, as in the JAX package. A promotion prepass that fails raises,
  as every prepass failure does here (the JAX package logs it and
  keeps the walk's result);
- a store that cannot be opened or read, and a verdict that cannot be
  written back, are recorded in the DegradationLog (`store-unavailable`,
  `store-writeback-failed`), where the JAX package only logs them; the
  contract takes the full path, and the analysis stands, as in the JAX
  package. A link pass that raises is recorded `static-prepass-failed`
  (site `corpus-link`) and the corpus runs unlinked, as in the JAX
  package;
- a store hit's result, and an incremental result's banked issues, also
  carry their `Issue`s in `issue_objects` (rebuilt from the banked
  dicts), as every port result does;
- `OverlappedPrepass`, the corpus prepass on a thread of its own beside
  the walks (here and in the analyzer facade, mythril/mythril_analyzer.py),
  is the JAX one (the store's selector masks included), with two
  departures: an exception in the prepass
  thread is kept and re-raised (by `outcome_for`, `drain` and `finish`,
  after the PREPASS_FAILED record), where the JAX `finish` returns no
  outcomes and the walks go on without the card; and a drain or finish
  that times out on a hung device call is recorded in the DegradationLog
  (`prepass-drain-timed-out`), not only logged;
- the static-answer triage (`_static_triage`, on unless
  `args.static_answer` or `args.static_prune` is off) is the JAX one,
  but a static pass that raises on a contract is recorded in the
  DegradationLog (`static-prepass-failed`), not only logged: the
  contract takes the full path, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import logging
import multiprocessing as mp
import os
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)


def _effective_cpus() -> int:
    """CPUs this process may actually run on: the affinity mask, not the
    host count (a container pinned to one core of a 64-core host must
    take the single-core schedule)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return mp.cpu_count()


#: corpus size from which the overlapped prepass pays even on one CPU
#: (the per-wave contention amortizes over many walks), and from which
#: the prepass runs lean-cap waves and narrower stripes
OVERLAP_MIN_CORPUS = 32

#: per-lane (memory bytes, storage slots) below and from OVERLAP_MIN_CORPUS
ROOMY_CAPS = (16384, 128)
LEAN_CAPS = (4096, 64)

#: the explorer's wave cap a phase: the budget is the real limiter, the
#: cap only backstops a runaway phase (the JAX package's 48)
PREPASS_WAVES = 48

DEFAULT_ADDRESS = 0x901D573B8CE8C997DE5F19173C32D966B4FA55FE

def resolve_prepass_budget_s(
    n_contracts: int,
    execution_timeout: Optional[float] = None,
    ownership: bool = True,
) -> float:
    """Default ACTIVE-time budget (waves + flip solving) for the striped
    corpus prepass.

    With `ownership`, every contract the exploration completes refunds
    its whole host walk (up to execution_timeout each), so the budget
    scales with the walk ceiling: up to half the refundable wall,
    bounded per corpus size. Early exits (per-contract parking, frontier
    exhaustion, coverage plateau) stop the spend well short of the
    budget on corpora that converge. Without ownership, or with no walk
    ceiling, the JAX package's witness-injection curve stands: small
    corpora 1s/contract, large corpora 0.5s/contract capped at 120s."""
    n = max(1, n_contracts)
    if ownership and execution_timeout:
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


def corpus_shard(items, shard_index: int, shard_count: int, identity=None):
    """Deterministic multi-host partition of a corpus (the JAX
    package's `corpus_shard`): contracts are embarrassingly parallel
    across hosts, so scale-out is a stable partition plus a report
    merge. Assignment hashes each item's CONTENT (name + runtime code),
    not its position, so every host computes the same partition however
    its filesystem enumerates the inputs. `identity` maps an item to its
    identity string; the default fits the analyze_corpus row shape
    (code, creation, name)."""
    import hashlib

    if shard_count < 1:
        raise ValueError(f"shard count must be >= 1, got {shard_count}")
    if not 0 <= shard_index < shard_count:
        raise ValueError(
            f"shard index {shard_index} outside 0..{shard_count - 1}"
        )
    if shard_count == 1:
        return list(items)
    if identity is None:
        identity = lambda row: f"{row[2]}:{row[0]}"  # noqa: E731
    out = []
    for item in items:
        digest = hashlib.sha256(identity(item).encode()).digest()
        if int.from_bytes(digest[:8], "big") % shard_count == shard_index:
            out.append(item)
    return out


def corpus_device_prepass(
    contracts: List[Tuple[str, str, str]],
    budget_s: Optional[float] = None,
    address: int = DEFAULT_ADDRESS,
    transaction_count: int = 1,
    host_lock=None,
    stop_event=None,
    publish=None,
    lock_wanted=None,
    execution_timeout: Optional[float] = None,
    deadline=None,
    mesh_groups: Optional[int] = None,
    waves: int = PREPASS_WAVES,
    device=None,
    ownership: bool = True,
    selector_masks: Optional[Dict[int, Tuple]] = None,
) -> Dict[int, Dict]:
    """One striped device exploration over the corpus, on `device`
    (None: the card); returns {contract_index: single-contract prepass
    outcome} (indexed, not named: corpus rows may share names). A
    failure of the exploration raises, after a PREPASS_FAILED record.
    `host_lock`, `publish` and `lock_wanted` are the overlapped mode's
    (`OverlappedPrepass`): `publish(contract_index, outcome)` receives
    every track's outcome after each wave.

    `selector_masks` ({contract index: (unchanged selector bytes, entry
    directions)}, store/) restricts those contracts' exploration to their
    CHANGED functions: the verdict store's incremental tier.

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
        budget_s = resolve_prepass_budget_s(
            len(runnable), execution_timeout, ownership=ownership
        )
    mem_cap, storage_cap = (
        LEAN_CAPS if len(runnable) >= OVERLAP_MIN_CORPUS else ROOMY_CAPS
    )
    translate = (
        None
        if publish is None
        else (lambda ti, outcome: publish(runnable[ti][0], outcome))
    )
    # contract-index masks as track indices (the explorer sees only the
    # runnable rows)
    track_masks = {
        ti: selector_masks[idx]
        for ti, (idx, _code) in enumerate(runnable)
        if idx in (selector_masks or {})
    } or None
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
            host_lock=host_lock,
            stop_event=stop_event,
            publish=translate,
            deadline=deadline,
            device=device,
            selector_masks=track_masks,
        )
        if lock_wanted is not None:
            explorer.lock_wanted = lock_wanted
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


#: how long `drain` waits for the prepass thread, and `finish` for it to
#: stop at its next wave boundary, before a hung device call is given up
DRAIN_TIMEOUT_S = 120.0
FINISH_TIMEOUT_S = 90.0


class OverlappedPrepass:
    """Own the striped device prepass thread beside a sequence of host
    analyses in THIS process (the JAX package's `OverlappedPrepass`).

    The prepass explores the whole corpus on `device` (None: the card)
    while the caller analyzes contracts one by one; both sides serialize
    host symbolic state on HOST_SYMBOLIC_LOCK (support/host_lock.py).
    Per-contract outcomes are published after every wave, so analyses
    that start mid-prepass still get witness/coverage injection, and
    `finish()` returns the final outcomes for a post-merge.

    Usage:
        pre = OverlappedPrepass(contracts, address, transaction_count)
        for i, c in enumerate(contracts):
            outcome, device_ok = pre.outcome_for(i)
            with pre.lock:
                ...analyze c with prepass_outcome=outcome, device off
                   unless device_ok...
            pre.yield_lock()
        final = pre.finish()

    Unlike the JAX one, a prepass that raised does not leave the walks
    to go on without the card: `outcome_for`, `drain` and `finish`
    re-raise the thread's exception once it is known (the exploration's
    failure is recorded PREPASS_FAILED by `corpus_device_prepass`), and a
    drain or finish that gives up on a hung thread is recorded in the
    DegradationLog (`prepass-drain-timed-out`). The JAX mesh argument is
    left out (the mesh is not ported); `selector_masks` are the verdict
    store's, as in the JAX package; `waves` caps the explorer's waves a
    phase, as `analyze_corpus(waves=)` does."""

    def __init__(
        self,
        contracts: List[Tuple[str, str, str]],
        address: int,
        transaction_count: int,
        budget_s: Optional[float] = None,
        execution_timeout: Optional[float] = None,
        ownership: bool = False,
        deadline=None,
        device=None,
        waves: int = PREPASS_WAVES,
        selector_masks: Optional[Dict[int, Tuple]] = None,
    ) -> None:
        import threading

        from mythril_tpu_torch.support.host_lock import HOST_SYMBOLIC_LOCK

        self.lock = HOST_SYMBOLIC_LOCK
        self._final: Dict[int, Dict] = {}
        self._published: Dict[int, Dict] = {}
        self._stop = threading.Event()
        self._lock_wanted = threading.Event()
        self._error: Optional[BaseException] = None
        self._deviceless = 0
        self._finished = False
        self._drain_abandoned = False

        def _work():
            try:
                self._final.update(
                    corpus_device_prepass(
                        contracts,
                        budget_s=budget_s,
                        address=address,
                        transaction_count=transaction_count,
                        host_lock=self.lock,
                        stop_event=self._stop,
                        publish=self._published.__setitem__,
                        lock_wanted=self._lock_wanted,
                        execution_timeout=execution_timeout,
                        ownership=ownership,
                        deadline=deadline,
                        device=device,
                        waves=waves,
                        selector_masks=selector_masks,
                    )
                )
            except BaseException as why:  # kept for the owner to raise
                self._error = why

        self._thread = threading.Thread(
            target=_work, name="corpus-prepass", daemon=True
        )
        self._thread.start()

    @property
    def drain_abandoned(self) -> bool:
        """True once a drain timed out on a hung device call — no
        further outcomes will ever be published."""
        return self._drain_abandoned

    @property
    def deviceless(self) -> int:
        """How many outcomes were handed out with the device off (the
        analyses that ran while the prepass owned the card)."""
        return self._deviceless

    def _done(self) -> bool:
        if self._thread is not None and not self._thread.is_alive():
            self._thread.join()
            self._thread = None
        return self._thread is None

    def _raise_failure(self) -> None:
        """Re-raise the prepass thread's exception, once it ended."""
        if self._error is not None and self._done():
            raise self._error

    def _abandon(self, what: str, waited_s: float) -> None:
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        self._drain_abandoned = True
        DegradationLog().record(
            DegradationReason.PREPASS_DRAIN_TIMED_OUT,
            site="corpus-prepass",
            detail=f"{what} gave up on the prepass thread after {waited_s:.0f} s; "
            "its banked witnesses are lost",
        )
        log.warning(
            "corpus device prepass %s timed out after %.0f s", what, waited_s
        )

    def drain(self) -> None:
        """Block until the prepass finishes its remaining active
        budget, without stopping it early. While the caller waits here
        the lock stays free, so the drain runs at full speed. The join is
        bounded AND paid once: a device call hung on a faulted card must
        cost the corpus DRAIN_TIMEOUT_S in total, not per remaining
        contract — after a timed-out drain every later call is a no-op."""
        if self._drain_abandoned:
            return
        if self._thread is not None:
            self._thread.join(timeout=DRAIN_TIMEOUT_S)
            if not self._done():
                self._abandon("drain", DRAIN_TIMEOUT_S)
                return
        self._raise_failure()

    def outcome_for(self, i: int):
        """(outcome to inject for contract i, device allowed).

        While the prepass runs, analyses get the latest PUBLISHED
        partial outcome with the device off — the card belongs to the
        prepass thread, and an injected outcome bypasses the
        device_prepass mode check anyway. Once it's done, the device
        comes back for everyone: covered contracts get the final
        outcome (which skips their own per-contract prepass), missed
        ones take the normal per-contract device path. A prepass that
        raised raises here."""
        if self._done():
            self._raise_failure()
            return self._final.get(i), True
        self._deviceless += 1
        return self._published.get(i), False

    def yield_lock(self) -> None:
        """Hand the lock to the prepass thread between analyses:
        CPython locks are unfair and a tight loop would reacquire
        within microseconds, rationing the prepass to one reseed per
        contract (lock convoy). Only yields when a flip burst is
        actually waiting."""
        if (
            self._thread is not None
            and self._thread.is_alive()
            and self._lock_wanted.is_set()
        ):
            time.sleep(0.05)

    def finish(self) -> Dict[int, Dict]:
        """Stop the exploration at its next wave boundary and return
        the final per-contract outcomes; re-raise the thread's exception
        if the prepass failed. Idempotent — callers invoke it from
        finally blocks so an exception escaping the analysis loop cannot
        orphan the thread."""
        if not self._finished:
            self._finished = True
            if self._thread is not None:
                self._stop.set()
                # stop is honored between waves; a thread a drain
                # already waited on is known hung, so it gets no more
                grace = 0.1 if self._drain_abandoned else FINISH_TIMEOUT_S
                self._thread.join(timeout=grace)
                if not self._done():
                    if not self._drain_abandoned:
                        self._abandon("finish", grace)
                    self._thread = None  # left to run out as a daemon
                    return self._final
        self._raise_failure()
        return self._final


def _ownership_enabled(use_device: bool) -> bool:
    """Resolve --device-ownership (auto = follow the device axis)."""
    from mythril_tpu_torch.support.support_args import args

    mode = getattr(args, "device_ownership", "auto")
    if mode == "never":
        return False
    if mode == "always":
        return True
    return bool(use_device)


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
    False the moment a published outcome shows a hard ownership failure
    (degraded lanes, dropped carries, saturated event bank): those gates
    only ever get worse, so the host walk should start at once instead
    of waiting out the prepass."""
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


def _static_answer_result(name: str, summary, wall_s: float) -> Dict:
    """The result slot for a statically-answered contract: the
    semantic screen (analysis/static taint + sink predicates) proved
    that NO detection module can fire, so the empty issue set IS the
    analysis: no device wave, no host walk, no solver. Same shape as
    an analyzed result so report builders need no special case; the
    `static_answered` flag marks it (`analyze` names it on stderr)."""
    return {
        "name": name,
        "issues": [],
        "issue_objects": [],
        "states": 0,
        "device_prepass": None,
        "phases": {},
        "precovered_skips": 0,
        "wall_s": round(wall_s, 6),
        "owned": False,
        "error": None,
        "static_answered": True,
        "static_analysis": {
            "code_hash": summary.code_hash,
            "static_answerable": True,
            "modules_applicable": 0,
            "wall_ms": summary.wall_ms,
        },
    }


def _static_triage(contracts: List[Tuple[str, str, str]]) -> Dict[int, Dict]:
    """{index: static-answer result} for every corpus row the
    semantic screen settles outright. Runs BEFORE the device prepass
    so answered contracts never occupy a lane; a per-contract failure
    keeps that contract on the full path and is recorded
    (`static-prepass-failed`)."""
    from mythril_tpu_torch.analysis.static import summary_for
    from mythril_tpu_torch.observe.registry import registry
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    out: Dict[int, Dict] = {}
    counter = registry().counter(
        "mtpu_static_answered_total",
        "contracts settled by the static-answer triage tier",
    )
    for i, (code, creation_code, name) in enumerate(contracts):
        if creation_code:
            # a deploying row executes creation code too: the
            # runtime-only proof does not cover it
            continue
        norm = code[2:] if code.startswith("0x") else code
        if len(norm) < 4:
            continue
        t0 = time.perf_counter()
        try:
            summary = summary_for(norm)
            if summary.static_answerable:
                out[i] = _static_answer_result(
                    name, summary, time.perf_counter() - t0
                )
                counter.inc()
        except Exception as why:
            DegradationLog().record(
                DegradationReason.STATIC_PREPASS_FAILED,
                site="corpus-triage",
                detail=f"{type(why).__name__}: {why}; full path",
                contract=name,
            )
    if out:
        log.info(
            "Static triage answered %d/%d contract(s) without dispatch",
            len(out),
            len(contracts),
        )
    return out


def _issue_objects(code: str, rows: List[Dict]) -> list:
    """`Issue`s rebuilt from banked issue dicts (a store entry's), so a
    store-settled result carries `issue_objects` as every port result
    does; their `as_dict` gives the banked dicts back."""
    from mythril_tpu_torch.analysis.report import Issue

    out = []
    for row in rows:
        head, _, tail = (row.get("description") or "").partition("\n")
        issue = Issue(
            contract=row.get("contract"),
            function_name=row.get("function"),
            address=row.get("address"),
            swc_id=row.get("swc-id"),
            title=row.get("title"),
            bytecode=code,
            gas_used=(row.get("min_gas_used"), row.get("max_gas_used")),
            severity=row.get("severity"),
            description_head=head,
            description_tail=tail,
            transaction_sequence=row.get("tx_sequence"),
        )
        issue.source_mapping = row.get("sourceMap")
        issue.filename = row.get("filename")
        issue.lineno = row.get("lineno")
        issue.code = row.get("code")
        issue.provenance = row.get("provenance")
        out.append(issue)
    return out


def _store_hit_result(name: str, code: str, entry, wall_s: float) -> Dict:
    """The result slot for an exact verdict-store hit: the banked issue
    set IS the analysis (no device wave, no host walk, no solver). Same
    shape as an analyzed result; the `store_hit` flag marks it."""
    return {
        "name": name,
        "issues": entry.issues,
        "issue_objects": _issue_objects(code, entry.issues),
        "states": 0,
        "device_prepass": None,
        "phases": {},
        "precovered_skips": 0,
        "wall_s": round(wall_s, 6),
        "owned": False,
        "error": None,
        "store_hit": True,
        "store": {
            "code_hash": entry.code_hash,
            "config_fingerprint": entry.config_fp,
            "provenance": entry.provenance,
        },
    }


def _store_triage(
    contracts: List[Tuple[str, str, str]],
    vstore,
    config_fp: str,
    linkset=None,
) -> Tuple[Dict[int, Dict], Dict[int, object]]:
    """({index: exact-hit result}, {index: IncrementalPlan}) from the
    verdict store (store/). Runs BEFORE the static triage and the device
    prepass, so hit contracts never occupy a lane and incremental
    contracts explore only their changed selectors. Every doubt bails
    that contract to the full path: a store problem can cost speed,
    never correctness.

    With a corpus `linkset`, an exact codehash hit is also checked
    against its stored CALL-GRAPH fingerprints: byte-identical code
    whose resolved callee closure moved (an implementation upgrade
    behind an unchanged proxy) is NOT served the stale verdict; it
    downgrades to a linked incremental plan re-analyzing only the
    selectors whose closure changed, or to full analysis when the
    linked diff cannot be trusted (link-unresolved / link-cycle). A
    lookup that raises is recorded `store-unavailable`."""
    answers: Dict[int, Dict] = {}
    plans: Dict[int, object] = {}
    if vstore is None:
        return answers, plans
    from mythril_tpu_torch.analysis.static import static_prune_enabled, summary_for
    from mythril_tpu_torch.store import (
        IncrementalBail,
        code_hash_hex,
        plan_incremental,
    )
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    for i, (code, creation_code, name) in enumerate(contracts):
        if creation_code:
            # a deploying row executes creation code too: the
            # runtime-keyed verdict does not cover it
            continue
        norm = code[2:] if code.startswith("0x") else code
        if len(norm) < 8:
            continue
        t0 = time.perf_counter()
        code_hash = code_hash_hex(norm)
        try:
            entry = vstore.get(code_hash, config_fp)
        except Exception as why:
            DegradationLog().record(
                DegradationReason.STORE_UNAVAILABLE,
                site="corpus-store",
                detail=f"{type(why).__name__}: {why}; full path",
                contract=name,
            )
            continue
        if entry is not None:
            if linkset is not None and entry.linked_fingerprints:
                verdict = _linked_hit_verdict(norm, name, entry, linkset, config_fp)
                if verdict == "stale":
                    continue  # full analysis; serving the hit is wrong
                if verdict is not None:
                    plans[i] = verdict
                    continue
            answers[i] = _store_hit_result(name, norm, entry, time.perf_counter() - t0)
            continue
        if not static_prune_enabled():
            continue  # the diff needs the static layer's fingerprints
        try:
            summary = summary_for(norm, config_fp=config_fp)
            nearest = vstore.nearest(
                config_fp,
                summary.function_fingerprints,
                exclude_code_hash=code_hash,
            )
            if nearest is None:
                continue
            plans[i] = plan_incremental(summary, nearest)
            log.info(
                "Store incremental plan for %s: %d changed / %d "
                "unchanged selector(s), %d banked issue(s)",
                name,
                len(plans[i].changed),
                len(plans[i].unchanged),
                len(plans[i].banked_issues),
            )
        except IncrementalBail as bail:
            log.info(
                "Store incremental bail for %s: %s (full analysis)",
                name,
                bail.reason,
            )
        except Exception:
            log.warning(
                "store incremental planning failed for %s; full analysis",
                name,
                exc_info=True,
            )
    if answers:
        log.info(
            "Verdict store settled %d/%d contract(s) at admission",
            len(answers),
            len(contracts),
        )
    return answers, plans


def _linked_hit_verdict(norm: str, name: str, entry, linkset, config_fp: str):
    """Check an exact store hit against its call-graph fingerprints.
    Returns None (the hit stands), an IncrementalPlan (only the
    selectors whose callee closure moved re-run; the rest is banked), or
    the sentinel "stale" (the closure moved but the diff cannot be
    trusted: full analysis, never the stale verdict)."""
    from mythril_tpu_torch.analysis.static import summary_for
    from mythril_tpu_torch.store import IncrementalBail, plan_linked_incremental

    try:
        summary = summary_for(norm, config_fp=config_fp)
    except Exception:
        log.warning("summary failed for linked hit %s", name, exc_info=True)
        return None
    if summary.code_hash not in linkset.nodes:
        return None  # row not linked: pre-link behavior
    linked_now, problems = linkset.linked_fingerprints(summary.code_hash)
    if linked_now == entry.linked_fingerprints and not problems:
        return None  # closure identical everywhere
    try:
        plan = plan_linked_incremental(summary, entry, linked_now, problems)
    except IncrementalBail as bail:
        log.info(
            "Linked store hit for %s cannot be diffed: %s (full analysis)",
            name,
            bail.reason,
        )
        return "stale"
    except Exception:
        log.warning(
            "linked incremental planning failed for %s; full analysis",
            name,
            exc_info=True,
        )
        return "stale"
    if plan is None:
        return None
    log.info(
        "Linked store hit for %s: callee closure moved for %d selector(s); "
        "%d banked",
        name,
        len(plan.changed),
        len(plan.unchanged),
    )
    return plan


def _apply_incremental(result: Optional[Dict], plan, code: str) -> Optional[Dict]:
    """Fold one incremental plan's banked issues into the fresh
    (changed-selector-restricted) result and flag the route."""
    if result is None or result.get("error"):
        return result
    from mythril_tpu_torch.store import merge_banked_issues

    issues = result.setdefault("issues", [])
    before = len(issues)
    added = merge_banked_issues(issues, plan.banked_issues)
    result.setdefault("issue_objects", []).extend(
        _issue_objects(code, issues[before:])
    )
    result["store_incremental"] = True
    result["store"] = dict(plan.as_dict(), banked_merged=added)
    return result


def _store_writeback(
    results: List[Optional[Dict]],
    contracts: List[Tuple[str, str, str]],
    prepass: Dict[int, Dict],
    vstore,
    config_fp: str,
    linkset=None,
) -> int:
    """Tier 3: persist every COMPLETE full analysis (incremental ones
    too: a fork's merged verdict is a first-class entry for the next
    fork). Store-hit and statically-answered rows are not re-written;
    partial, skipped and errored rows never are. A write that fails is
    recorded `store-writeback-failed` (by the store, or here when the
    export raises)."""
    if vstore is None:
        return 0
    from mythril_tpu_torch.analysis.static import static_prune_enabled, summary_for
    from mythril_tpu_torch.store import (
        banks_from_outcome,
        code_hash_hex,
        provenance,
        static_export,
    )
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    written = 0
    for i, (code, creation_code, name) in enumerate(contracts):
        result = results[i] if i < len(results) else None
        if (
            result is None
            or creation_code
            or not result.get("complete")
            or result.get("store_hit")
            or result.get("static_answered")
            or result.get("skipped")
        ):
            continue
        norm = code[2:] if code.startswith("0x") else code
        if len(norm) < 8:
            continue
        summary = None
        if static_prune_enabled():
            try:
                summary = summary_for(norm, config_fp=config_fp)
            except Exception:
                summary = None
        try:
            path = vstore.put(
                code_hash_hex(norm),
                config_fp,
                issues=result.get("issues") or [],
                static=static_export(summary, linkset=linkset),
                banks=banks_from_outcome(prepass.get(i)),
                provenance=provenance(
                    wall_s=result.get("wall_s"),
                    computed_by="corpus",
                    incremental=bool(result.get("store_incremental")),
                ),
            )
            written += bool(path)
        except Exception as why:
            DegradationLog().record(
                DegradationReason.STORE_WRITEBACK_FAILED,
                site="corpus-store",
                detail=f"{type(why).__name__}: {why}",
                contract=name,
            )
    if written:
        log.info("Verdict store banked %d verdict(s)", written)
    return written


def _attach_link_meta(
    results: List[Optional[Dict]],
    contracts: List[Tuple[str, str, str]],
    linkset,
) -> None:
    """Per-result cross-contract link facts (the jsonv2 report meta and
    anyone reading the raw result dicts): the compact node block plus
    the corpus-level stats on every row, so the consumers of one
    contract's report still see the resolve rate the graph achieved."""
    import hashlib

    run_stats = linkset.stats()
    for (code, _creation, _name), result in zip(contracts, results):
        if result is None:
            continue
        try:
            norm = code[2:] if code.startswith("0x") else code
            code_hash = "0x" + hashlib.sha256(bytes.fromhex(norm)).hexdigest()
        except ValueError:
            continue
        meta = linkset.node_meta(code_hash)
        if meta is None:
            continue
        result["link"] = meta
        result["link_run"] = dict(run_stats)


def _link_pass(contracts: List[Tuple[str, str, str]]):
    """The corpus link pass (analysis/static/linkset.py), or None when
    static pruning is off, the corpus is empty, or the pass raised
    (recorded `static-prepass-failed`, site `corpus-link`)."""
    from mythril_tpu_torch.analysis.static import link_corpus, static_prune_enabled
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    if not (static_prune_enabled() and contracts):
        return None
    try:
        linkset = link_corpus(contracts)
        stats = linkset.stats()
    except Exception as why:
        DegradationLog().record(
            DegradationReason.STATIC_PREPASS_FAILED,
            site="corpus-link",
            detail=f"{type(why).__name__}: {why}; corpus unlinked",
        )
        return None
    log.info(
        "Link pass: %d node(s), %d/%d edge(s) resolved, %d proxy pair(s) "
        "in %.1fms",
        stats["nodes"],
        stats["edges_resolved"],
        stats["edges"],
        stats["proxy_pairs"],
        stats["wall_ms"],
    )
    return linkset


def _analyze_one(
    code: str,
    creation_code: str,
    name: str,
    address: int,
    prepass_outcome: Optional[Dict],
    strategy: str = "bfs",
    transaction_count: int = 2,
    execution_timeout: int = 60,
    create_timeout: int = 10,
    max_depth: int = 128,
    loop_bound: int = 3,
    modules: Optional[List[str]] = None,
    solver_timeout: Optional[int] = None,
    disable_dependency_pruning: bool = False,
    device=None,
    use_device: bool = True,
) -> Dict:
    """The host walk of one contract (SymExecWrapper + fire_lasers) on
    `device`, with the corpus prepass's outcome injected. Returns the
    JAX package's result keys (issues, states, device_prepass, phases,
    precovered_skips, wall_s, error), `issue_objects`, the `Issue`s
    the report is built from, and `static_screen`, the modules the
    static screen mounted. A walk that raises is recorded in `error`
    with its traceback, and no issues.

    With `use_device` False the walk runs with `args.device_prepass`
    and `args.device_solving` at "never" (no prepass of its own, no
    solver race), restored on every exit path, as the JAX worker does."""
    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.observe.spans import trace
    from mythril_tpu_torch.support.phase_profile import PhaseProfile
    from mythril_tpu_torch.support.support_args import args

    t_start = time.perf_counter()
    restore_timeout = args.solver_timeout
    restore_device_args = (args.device_prepass, args.device_solving)
    if solver_timeout:
        args.solver_timeout = solver_timeout
    if not use_device:
        args.device_prepass = "never"
        args.device_solving = "never"
    try:
        contract = EVMContract(
            code=code or "", creation_code=creation_code or "", name=name
        )
        with trace("contract.analyze", contract=name):
            sym = SymExecWrapper(
                contract,
                address,
                strategy,
                max_depth=max_depth,
                execution_timeout=execution_timeout,
                loop_bound=loop_bound,
                create_timeout=create_timeout,
                transaction_count=transaction_count,
                modules=modules,
                compulsory_statespace=False,
                prepass_outcome=prepass_outcome,
                disable_dependency_pruning=disable_dependency_pruning,
                device=device,
            )
            issues = fire_lasers(sym, modules)
        exploration = sym.device_exploration
        return {
            "name": name,
            "issues": [issue.as_dict for issue in issues],
            "issue_objects": issues,
            "states": sym.laser.total_states,
            "device_prepass": exploration["stats"] if exploration else None,
            "phases": PhaseProfile().as_dict(),
            "precovered_skips": sym.laser.device_precovered_skips,
            "wall_s": round(time.perf_counter() - t_start, 3),
            "error": None,
            # port-only: the modules the static screen mounted (None:
            # all, static pruning off or failed)
            "static_screen": (
                sorted(sym.static_screen) if sym.static_screen is not None else None
            ),
        }
    except Exception:
        return {
            "name": name,
            "issues": [],
            "issue_objects": [],
            "states": 0,
            "wall_s": round(time.perf_counter() - t_start, 3),
            "error": traceback.format_exc(),
        }
    finally:
        args.solver_timeout = restore_timeout
        args.device_prepass, args.device_solving = restore_device_args


def analyze_corpus(
    contracts: List[Tuple[str, str, str]],
    address: int = DEFAULT_ADDRESS,
    strategy: str = "bfs",
    transaction_count: int = 2,
    execution_timeout: int = 60,
    create_timeout: int = 10,
    max_depth: int = 128,
    loop_bound: int = 3,
    modules: Optional[List[str]] = None,
    solver_timeout: Optional[int] = None,
    processes: Optional[int] = None,
    use_device: Optional[bool] = None,
    disable_dependency_pruning: bool = False,
    device_budget_s: Optional[float] = None,
    deterministic_solving: Optional[bool] = None,
    deadline_s: Optional[float] = None,
    on_timeout: str = "partial",
    devices: Optional[int] = None,
    waves: int = PREPASS_WAVES,
    device=None,
    store_dir: Optional[str] = None,
    store: Optional[bool] = None,
    router_dir: Optional[str] = None,
    router: Optional[bool] = None,
) -> List[Dict]:
    """Analyze `contracts` = [(runtime_code_hex, creation_code_hex,
    name), ...]: one striped device prepass on `device` (None: the
    card), overlapped with the walks or run first (the module
    docstring's schedule), and, contract by contract, the owned result
    or the host walk with the contract's outcome injected. Returns one
    result dict per contract ({name, issues, issue_objects, owned,
    error, complete, device_prepass, ...}).

    `use_device` False is the host-only leg: no prepass, and every walk
    with the device prepass and the solver race off (ownership then
    follows `--device-ownership`, auto meaning off); None or True runs
    the device axis on `device`. `deterministic_solving` (None: leave
    `args.deterministic_solving` as it is) holds for this call and is
    restored on every exit path.

    With `deadline_s` (falling back to the process-global run deadline)
    an expired budget, or a SIGINT/SIGTERM under
    `resilience.graceful_shutdown()`, marks the contracts not yet walked
    as skipped; owned contracts still report in full; `on_timeout`
    "fail" then raises DeadlineExpiredError instead of returning the
    partial list. `waves` caps the explorer's waves a phase (tests and
    chip_smoke.py pass a small cap so that a run does not depend on the
    wall clock; `device_budget_s` then still applies). `processes` above
    1 (the JAX package's pooled walk) raises: the port walks in this
    process.

    `store_dir` (falling back to `args.store_dir`, MYTHRIL_STORE_DIR) is
    the verdict store's directory; `store` False (or `args.store` off,
    `--no-store`) turns the tier off: no lookup, no incremental plan, no
    write-back. Exact hits carry `store_hit`, incremental results
    `store_incremental` and the plan under `store`.

    `router_dir` (falling back to the process router,
    routing/router.py `configured_router`: MYTHRIL_ROUTER_DIR) holds the
    learned router's artifacts; `router` False turns it off. With no
    verifying artifact, or without the device axis, the ladder is the
    router-less one, bit for bit. A routed result carries `routed`, a
    promoted one `promoted`."""
    from mythril_tpu_torch.analysis.static import static_answer_enabled
    from mythril_tpu_torch.analysis.static.summary import (
        analysis_config_fingerprint,
    )
    from mythril_tpu_torch.store import configured_store
    from mythril_tpu_torch.support import resilience

    if processes is not None and processes > 1:
        raise NotImplementedError(
            "the pooled host walk (processes > 1) is not ported: the port "
            "walks the corpus in one process"
        )
    use_device = use_device is None or bool(use_device)
    deadline = (
        resilience.run_deadline()
        if deadline_s is None
        else resilience.Deadline(deadline_s, label="corpus")
    )
    own = _ownership_enabled(use_device)
    walk_kw = dict(
        strategy=strategy,
        transaction_count=transaction_count,
        execution_timeout=execution_timeout,
        create_timeout=create_timeout,
        max_depth=max_depth,
        loop_bound=loop_bound,
        modules=modules,
        solver_timeout=solver_timeout,
        disable_dependency_pruning=disable_dependency_pruning,
        device=device,
    )
    prepass_kw = dict(
        address=address,
        transaction_count=transaction_count,
        execution_timeout=execution_timeout,
        ownership=own,
        deadline=deadline,
        device=device,
        waves=waves,
    )

    def walk(i, outcome, walk_device):
        code, creation_code, name = contracts[i]
        result = _analyze_one(
            code, creation_code, name, address, outcome,
            use_device=walk_device, **walk_kw,
        )
        result["owned"] = False
        return result

    config_fp = analysis_config_fingerprint(
        modules=modules,
        transaction_count=transaction_count,
        solver_timeout=solver_timeout,
        create_timeout=create_timeout,
    )

    with _scoped_deterministic_solving(deterministic_solving):
        # the corpus link pass, BEFORE the store triage: its resolved
        # call graph feeds the linked-fingerprint diff (same proxy
        # bytes, upgraded implementation) and every result's link meta
        linkset = _link_pass(contracts)
        # the verdict store's tiers 1 and 2: exact hits settle here,
        # near-duplicates get a plan that masks their unchanged
        # selectors out of the device exploration
        vstore = None if store is False else configured_store(store_dir)
        store_answers, store_plans = _store_triage(
            contracts, vstore, config_fp, linkset=linkset
        )
        selector_masks = {
            i: (plan.mask_selectors, plan.mask_directions)
            for i, plan in store_plans.items()
        } or None
        prepass_kw["selector_masks"] = selector_masks
        # the static-answer triage tier: contracts the semantic screen
        # settles are answered HERE (microseconds) and excluded from the
        # device prepass, which sees their rows (and the store's hits)
        # as non-runnable so the index mapping every consumer shares
        # stays intact; it never re-examines a store hit
        prepass_rows = [
            ("", row[1], row[2]) if i in store_answers else row
            for i, row in enumerate(contracts)
        ]
        static_answers = (
            _static_triage(prepass_rows) if static_answer_enabled() else {}
        )
        settled = {**static_answers, **store_answers}
        for i in static_answers:
            prepass_rows[i] = ("", contracts[i][1], contracts[i][2])
        # the learned tier-ladder router: every contract the triage
        # tiers did not settle is priced host-walk against device-waves,
        # and host-routed rows leave the device prepass (whose budget
        # scales with the runnable row count); mis-routes are repaired
        # after the walks by _promote_overruns
        corpus_router = (
            _load_corpus_router(router_dir)
            if router is not False and use_device
            else None
        )
        route_plan, route_decisions = _route_plan(
            corpus_router, contracts, settled, linkset
        )
        for i, planned in route_plan.items():
            if planned == "host-walk":
                prepass_rows[i] = ("", contracts[i][1], contracts[i][2])

        def incremental(i, result):
            plan = store_plans.get(i)
            return result if plan is None else _apply_incremental(
                result, plan, contracts[i][0]
            )
        if use_device and len(contracts) > 1 and (
            _effective_cpus() > 1
            or len(_runnable_rows(prepass_rows)) >= OVERLAP_MIN_CORPUS
        ):
            if devices is not None and devices > 1:
                raise NotImplementedError(
                    "the multi-chip corpus scheduler is not ported: the "
                    "prepass runs one engine on one card"
                )
            results, prepass = _overlapped_schedule(
                contracts, prepass_rows, settled, store_plans, own, deadline,
                device_budget_s, prepass_kw, walk, incremental,
            )
        else:
            prepass = (
                corpus_device_prepass(
                    prepass_rows,
                    budget_s=device_budget_s,
                    stop_event=resilience.shutdown_event(),
                    mesh_groups=devices,
                    **prepass_kw,
                )
                if use_device
                else {}
            )
            results = []
            halt_reason = None
            for i, (code, creation_code, name) in enumerate(contracts):
                resilience.inject("corpus.contract")
                if i in settled:
                    # a store hit or a static answer: the banked or the
                    # empty issue set is the analysis; it even survives
                    # a deadline halt (it costs microseconds)
                    results.append(settled[i])
                    continue
                outcome = prepass.get(i)
                if own and _outcome_owns(outcome):
                    # synthesis is cheap (no walk, no solver), so an
                    # owned contract reports in full even after a halt
                    results.append(incremental(i, _owned_result(
                        code, creation_code, name, outcome, address)))
                    continue
                if halt_reason is None:
                    halt_reason = resilience.interrupted_reason(deadline)
                if halt_reason is not None:
                    results.append(_skipped_result(name, halt_reason))
                    continue
                if outcome is None and i in store_plans:
                    # no device outcome: the store's banked coverage of
                    # the unchanged selectors pre-empts walk queries
                    outcome = store_plans[i].injected_outcome
                results.append(incremental(i, walk(i, outcome, use_device)))
        if prepass:
            _merge_prepass_witnesses(results, contracts, prepass, address)
        if route_plan:
            _promote_overruns(
                results, contracts, route_plan, route_decisions,
                corpus_router, prepass_kw, use_device,
            )
    skipped = 0
    for i, result in enumerate(results):
        # per-contract completion status, first-class in the result
        # (and from there in the json/jsonv2 report meta)
        result["complete"] = (
            not result.get("skipped") and result.get("error") is None
        )
        result["device_complete"] = bool(
            (prepass.get(i) or {}).get("device_complete")
        )
        skipped += bool(result.get("skipped"))
    # tier 3: every completed full analysis becomes a store entry
    if vstore is not None:
        _store_writeback(
            results, contracts, prepass, vstore, config_fp, linkset=linkset
        )
    if linkset is not None:
        _attach_link_meta(results, contracts, linkset)
    # router decisions feed their own training data: planned rows
    # settle as routed-<tier> / promoted-<tier> in the routing log,
    # stamped AFTER the store write-back so that banked verdicts stay
    # route-free (a store hit replays as store-hit)
    for i, planned in route_plan.items():
        result = results[i]
        if result.get("skipped") or result.get("promoted"):
            continue
        result["routed"] = planned
    _emit_routing_records(results, contracts, linkset=linkset)
    if skipped and on_timeout == "fail":
        from mythril_tpu_torch.exceptions import DeadlineExpiredError

        raise DeadlineExpiredError(
            f"{skipped}/{len(contracts)} contract(s) unanalyzed at the "
            "deadline (--on-timeout=fail)"
        )
    return results


def _load_corpus_router(router_dir: Optional[str]):
    """The router for this corpus: `router_dir`'s newest verifying
    artifact, else the process router; None keeps the built-in ladder.
    A refused artifact is counted by the artifact layer; a load that
    raises is recorded `router-failed`."""
    from mythril_tpu_torch.routing import router as _routing_rt

    try:
        return (
            _routing_rt.load_router(router_dir)
            if router_dir
            else _routing_rt.configured_router()
        )
    except Exception as why:
        _routing_rt.record_failure("corpus-router-load", why)
        return None


def _route_plan(corpus_router, contracts, settled, linkset):
    """({row: route}, {row: RouteDecision}) for every runnable row the
    triage tiers did not settle, as the JAX corpus plan prices them
    (the corpus link block rides into the features)."""
    from mythril_tpu_torch import observe
    from mythril_tpu_torch.routing.router import record_failure

    route_plan: Dict[int, str] = {}
    route_decisions: Dict[int, object] = {}
    if corpus_router is None:
        return route_plan, route_decisions
    for i, (code, _creation, name) in enumerate(contracts):
        if i in settled:
            continue
        code_norm = code[2:] if code.startswith("0x") else code
        if len(code_norm) < 8:
            continue  # not a runnable prepass row anyway
        try:
            link_meta = None
            if linkset is not None:
                link_meta = linkset.node_meta(
                    "0x" + hashlib.sha256(bytes.fromhex(code_norm)).hexdigest()
                )
            decision = corpus_router.decide(
                observe.routing_features_for(code, link=link_meta),
                tiers=["host-walk", "device-waves"],
            )
        except Exception as why:
            record_failure("corpus-route-decision", why, contract=name)
            continue
        if decision is None:
            continue
        route_plan[i] = decision.route
        route_decisions[i] = decision
    if route_plan:
        log.info(
            "Router v%d: %d host-walk / %d device-waves of %d routable "
            "contract(s)",
            corpus_router.version,
            sum(1 for r in route_plan.values() if r == "host-walk"),
            sum(1 for r in route_plan.values() if r == "device-waves"),
            len(route_plan),
        )
    return route_plan, route_decisions


def _promote_overruns(
    results: List[Dict],
    contracts: List[Tuple[str, str, str]],
    route_plan: Dict[int, str],
    route_decisions: Dict[int, object],
    corpus_router,
    prepass_kw: Dict,
    use_device: bool,
) -> None:
    """The router's in-flight repair tier: a host-routed contract whose
    walk errored or overran the decision's predicted budget
    (`RouteDecision.budget_s`, slack times the predicted wall) was
    mis-routed, so it gets the device waves it was denied: one prepass
    over just the overrun rows (ownership off), witnesses merged in
    place, the result stamped ``promoted`` (its routing record settles
    as ``promoted-device-waves``). Regret, the wall burnt beyond the
    budget, feeds mtpu_router_regret_seconds_total. A promotion prepass
    that fails raises."""
    from mythril_tpu_torch.support import resilience

    deadline = prepass_kw["deadline"]
    if not use_device or resilience.interrupted_reason(deadline) is not None:
        return
    overrun: List[int] = []
    for i, planned in route_plan.items():
        if planned != "host-walk":
            continue
        result = results[i]
        if result.get("skipped"):
            continue
        decision = route_decisions.get(i)
        budget = decision.budget_s() if decision is not None else 0.0
        wall = result.get("wall_s") or 0.0
        if result.get("error") is not None or (budget and wall > budget):
            overrun.append(i)
            if budget and wall > budget:
                corpus_router.note_regret(wall - budget)
    if not overrun:
        return
    promo_rows = [
        (contracts[i][0] if i in overrun else "", contracts[i][1], contracts[i][2])
        for i in range(len(contracts))
    ]
    promo = corpus_device_prepass(
        promo_rows,
        stop_event=resilience.shutdown_event(),
        **dict(prepass_kw, ownership=False, selector_masks=None),
    )
    _merge_prepass_witnesses(results, contracts, promo, prepass_kw["address"])
    for i in overrun:
        results[i]["promoted"] = "device-waves"
        corpus_router.note_promotion("host-walk", "device-waves")


def _emit_routing_records(
    results: List[Dict],
    contracts: List[Tuple[str, str, str]],
    linkset=None,
) -> None:
    """One routing-feature record per analyzed contract
    (observe/routing.py): static features joined with the route taken
    and the outcome, with a journey skeleton under a fresh journey id
    (admission, route, settle), as the JAX corpus driver writes them. A
    record that cannot be built is recorded `routing-record-failed`;
    the run goes on."""
    from mythril_tpu_torch import observe
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    if not observe.enabled():
        return
    for (code, _creation, name), result in zip(contracts, results):
        try:
            code_norm = code[2:] if code.startswith("0x") else code
            try:
                digest = hashlib.sha256(bytes.fromhex(code_norm or "")).hexdigest()
            except ValueError:
                digest = ""
            outcome = observe.routing_outcome_for(result)
            journey_id = observe.new_journey_id()
            observe.journey_event(journey_id, "admission", "corpus", contract=name)
            observe.journey_event(
                journey_id, outcome.get("route", "?"), "routed",
                wall_s=outcome.get("wall_s"),
            )
            observe.journey_event(
                journey_id, "settle",
                "done" if not outcome.get("error") else "failed",
                issues=outcome.get("issues"),
            )
            link_meta = (
                linkset.node_meta("0x" + digest) if linkset is not None else None
            )
            observe.routing_log().record(
                contract=name,
                code_hash=digest,
                features=observe.routing_features_for(code_norm, link=link_meta),
                outcome=outcome,
                journey_id=journey_id,
            )
        except Exception as why:
            log.warning("routing record failed for %s: %s", name, why)
            DegradationLog().record(
                DegradationReason.ROUTING_RECORD_FAILED,
                site="corpus-routing-record",
                detail=str(why),
                contract=name,
            )


@contextmanager
def _scoped_deterministic_solving(value: Optional[bool]):
    """`args.deterministic_solving` set to `value` inside (None: left as
    it is) and restored on every exit path."""
    from mythril_tpu_torch.support.support_args import args

    restore = args.deterministic_solving
    if value is not None:
        args.deterministic_solving = value
    try:
        yield
    finally:
        args.deterministic_solving = restore


def _overlapped_schedule(
    contracts, prepass_rows, settled, store_plans, own, deadline,
    device_budget_s, prepass_kw, walk, incremental,
) -> Tuple[List[Dict], Dict[int, Dict]]:
    """The JAX package's overlapped single-process schedule: the prepass
    on its own thread (`OverlappedPrepass`) while this thread walks the
    contracts smallest code first. A walk that starts while the prepass
    runs gets its latest published outcome with the card off; a
    contract the running prepass may still own is deferred rather than
    walked; past the overlap window (1.25x the prepass budget, 2x from
    OVERLAP_MIN_CORPUS rows) one drain lets the prepass finish alone.
    `settled` holds the store's hits and the static answers; a contract
    with a store plan (`store_plans`) walks with the plan's banked
    coverage when no device outcome is out yet, and `incremental` folds
    the plan's banked issues into its result. Returns (results in corpus
    order, the final outcomes)."""
    from mythril_tpu_torch.support import resilience

    execution_timeout = prepass_kw["execution_timeout"]
    address = prepass_kw["address"]
    pre = OverlappedPrepass(prepass_rows, budget_s=device_budget_s, **prepass_kw)
    # smallest code first: cheap walks soak up the prepass's busy
    # window, so the budget-bound heavyweights run after it finishes,
    # uncontended and with the FINAL outcome
    order = sorted(range(len(contracts)), key=lambda i: len(contracts[i][0]))
    n_run = max(1, len(_runnable_rows(prepass_rows)))
    overlap_window_s = (
        2.0 if n_run >= OVERLAP_MIN_CORPUS else 1.25
    ) * (
        device_budget_s
        if device_budget_s is not None
        else resolve_prepass_budget_s(n_run, execution_timeout, ownership=own)
    )
    t_overlap = time.perf_counter()
    slots: List[Optional[Dict]] = [None] * len(contracts)
    halt_reason: Optional[str] = None
    try:
        pending = list(order)
        while pending:
            progressed = False
            deferred: List[int] = []
            for i in pending:
                # the supervisor boundary: an expired deadline or a
                # delivered signal stops LAUNCHING work
                resilience.inject("corpus.contract")
                if halt_reason is None:
                    halt_reason = resilience.interrupted_reason(deadline)
                code, creation_code, name = contracts[i]
                if i in settled:
                    slots[i] = settled[i]
                    progressed = True
                    continue
                if halt_reason is not None:
                    slots[i] = _skipped_result(name, halt_reason)
                    progressed = True
                    continue
                if time.perf_counter() - t_overlap > overlap_window_s:
                    pre.drain()
                outcome, device_ok = pre.outcome_for(i)
                if outcome is None and i in store_plans:
                    # no device outcome (yet): the store's banked
                    # coverage of the unchanged selectors pre-empts the
                    # walk's feasibility queries instead
                    outcome = store_plans[i].injected_outcome
                if own and _outcome_owns(outcome):
                    # device-complete contract: the evidence IS the
                    # analysis; no walk, no lock, no solver
                    slots[i] = incremental(i, _owned_result(
                        code, creation_code, name, outcome, address
                    ))
                    progressed = True
                    continue
                if (
                    not device_ok
                    and own
                    and _maybe_ownable(outcome)
                    and not pre.drain_abandoned
                ):
                    # a hung prepass (abandoned drain) never publishes
                    # finality: deferring past it would spin forever
                    deferred.append(i)
                    continue
                with pre.lock:
                    slots[i] = incremental(i, walk(i, outcome, device_ok))
                pre.yield_lock()
                progressed = True
            pending = deferred
            if pending and not progressed:
                # only deferred work left: let the prepass run alone and
                # poll its published finality
                time.sleep(1.0)
    finally:
        # an exception (a caller's deadline included) must not orphan
        # the prepass thread mid-wave; a prepass that raised raises here
        prepass = pre.finish()
    return slots, prepass


def _merge_prepass_witnesses(
    results: List[Dict],
    contracts: List[Tuple[str, str, str]],
    prepass: Dict[int, Dict],
    address: int,
) -> None:
    """Fold the device prepass's banked witnesses into the walked
    results: per contract, attach the prepass counters and append
    witness issues for locations the walk did not report (a walk that
    raised, or a contract the deadline skipped, keeps the device's
    findings)."""
    from mythril_tpu_torch.analysis.prepass import witness_issues
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract

    for i, (code, _creation, name) in enumerate(contracts):
        outcome = prepass.get(i)
        result = results[i]
        if outcome is None or result.get("owned"):
            continue
        result["device_prepass"] = outcome["stats"]
        fresh = witness_issues(EVMContract(code=code or "", name=name), outcome, address)
        seen = {(i.get("address"), i.get("swc-id")) for i in result["issues"]}
        extra = [
            issue for issue in fresh if (issue.address, issue.swc_id) not in seen
        ]
        if extra:
            log.info(
                "Device prepass contributed %d issue(s) to %s that the "
                "host walk did not find",
                len(extra),
                name,
            )
            result["issues"].extend(issue.as_dict for issue in extra)
            result["issue_objects"].extend(extra)
            outcome["stats"]["witness_issues"] = len(extra)


