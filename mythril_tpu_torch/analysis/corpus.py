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
injected, after the exploration has finished, so that the walk's solver
races have the card to themselves.

Where the port differs, and how it says so:

- a prepass failure raises (the JAX package returns no outcomes so that
  its host walk carries on without the card);
- a walk that raises is recorded in the result's `error`, and the
  contract is `complete: False`, as in the JAX package;
- the multi-chip scheduler (`mesh_groups > 1`) raises, as the explorer's
  other unported options do;
- the pooled walk (`processes > 1`) raises; the verdict store (and with
  it the selector masks), the corpus link pass and the routing triage
  are not ported and have no switch here;
- `OverlappedPrepass`, the corpus prepass on a thread of its own beside
  the analyzer facade's walks (mythril/mythril_analyzer.py), is the JAX
  one, with two departures: an exception in the prepass thread is kept
  and re-raised (by `outcome_for`, `drain` and `finish`, after the
  PREPASS_FAILED record), where the JAX `finish` returns no outcomes and
  the walks go on without the card; and a drain or finish that times out
  on a hung device call is recorded in the DegradationLog
  (`prepass-drain-timed-out`), not only logged;
- the static-answer triage (`_static_triage`, on unless
  `args.static_answer` or `args.static_prune` is off) is the JAX one,
  but a static pass that raises on a contract is recorded in the
  DegradationLog (`static-prepass-failed`), not only logged: the
  contract takes the full path, as in the JAX package.
"""

from __future__ import annotations

import logging
import time
import traceback
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
) -> Dict[int, Dict]:
    """One striped device exploration over the corpus, on `device`
    (None: the card); returns {contract_index: single-contract prepass
    outcome} (indexed, not named: corpus rows may share names). A
    failure of the exploration raises, after a PREPASS_FAILED record.
    `host_lock`, `publish` and `lock_wanted` are the overlapped mode's
    (`OverlappedPrepass`): `publish(contract_index, outcome)` receives
    every track's outcome after each wave.

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
    DegradationLog (`prepass-drain-timed-out`). The JAX budget and mesh
    arguments are left out: the facade passes neither, and the mesh is
    not ported."""

    def __init__(
        self,
        contracts: List[Tuple[str, str, str]],
        address: int,
        transaction_count: int,
        execution_timeout: Optional[float] = None,
        ownership: bool = False,
        deadline=None,
        device=None,
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
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    out: Dict[int, Dict] = {}
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
) -> Dict:
    """The host walk of one contract (SymExecWrapper + fire_lasers) on
    `device`, with the corpus prepass's outcome injected. Returns the
    JAX package's result keys (issues, states, device_prepass, phases,
    precovered_skips, wall_s, error), `issue_objects`, the `Issue`s
    the report is built from, and `static_screen`, the modules the
    static screen mounted. A walk that raises is recorded in `error`
    with its traceback, and no issues."""
    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.observe.spans import trace
    from mythril_tpu_torch.support.phase_profile import PhaseProfile
    from mythril_tpu_torch.support.support_args import args

    t_start = time.perf_counter()
    restore_timeout = args.solver_timeout
    if solver_timeout:
        args.solver_timeout = solver_timeout
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
    disable_dependency_pruning: bool = False,
    device_budget_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    devices: Optional[int] = None,
    waves: int = PREPASS_WAVES,
    device=None,
) -> List[Dict]:
    """Analyze `contracts` = [(runtime_code_hex, creation_code_hex,
    name), ...]: one striped device prepass on `device` (None: the
    card), then, contract by contract, the owned result or the host
    walk with the contract's outcome injected. Returns one result dict
    per contract ({name, issues, issue_objects, owned, error, complete,
    device_prepass, ...}).

    With `deadline_s` (falling back to the process-global run deadline)
    an expired budget, or a SIGINT/SIGTERM under
    `resilience.graceful_shutdown()`, marks the contracts not yet walked
    as skipped; owned contracts still report in full. `waves` caps the
    explorer's waves a phase (tests and chip_smoke.py pass a small cap
    so that a run does not depend on the wall clock; `device_budget_s`
    then still applies). `processes` above 1 (the JAX package's pooled
    walk) raises: the port walks in this process."""
    from mythril_tpu_torch.analysis.static import static_answer_enabled
    from mythril_tpu_torch.support import resilience

    if processes is not None and processes > 1:
        raise NotImplementedError(
            "the pooled host walk (processes > 1) is not ported: the port "
            "walks the corpus in one process"
        )
    deadline = (
        resilience.run_deadline()
        if deadline_s is None
        else resilience.Deadline(deadline_s, label="corpus")
    )
    own = _ownership_enabled()
    # the static-answer triage tier: contracts the semantic screen
    # settles are answered HERE (microseconds) and excluded from the
    # device prepass, which sees their rows as non-runnable so the
    # index mapping every consumer shares stays intact
    static_answers = _static_triage(contracts) if static_answer_enabled() else {}
    prepass_rows = list(contracts)
    for i in static_answers:
        prepass_rows[i] = ("", contracts[i][1], contracts[i][2])
    prepass = corpus_device_prepass(
        prepass_rows,
        budget_s=device_budget_s,
        address=address,
        transaction_count=transaction_count,
        execution_timeout=execution_timeout,
        deadline=deadline,
        stop_event=resilience.shutdown_event(),
        mesh_groups=devices,
        waves=waves,
        device=device,
        ownership=own,
    )
    results = []
    halt_reason = None
    for i, (code, creation_code, name) in enumerate(contracts):
        if i in static_answers:
            # statically answered: the empty issue set is the analysis;
            # it even survives a deadline halt (it costs microseconds)
            results.append(static_answers[i])
            continue
        outcome = prepass.get(i)
        if own and _outcome_owns(outcome):
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
        result = _analyze_one(
            code,
            creation_code,
            name,
            address,
            outcome,
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
        result["owned"] = False
        results.append(result)
    _merge_prepass_witnesses(results, contracts, prepass, address)
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


