"""`python -m mythril_tpu_torch solverlab`: the offline solver replay lab.

A corpus captured with ``--capture-queries DIR`` (observe/querylog.py)
holds every solved SMT query as a content-addressed, replayable
artifact. This module re-runs such a corpus against any engine matrix
— host CDCL, the on-chip portfolio per shape bucket, or the full
production race funnel — and reports per-engine verdict/wall/agreement
tables plus the funnel-loss waterfall. Portfolio tuning iterates here
in seconds on a fixed query set instead of re-running full corpus
analyses in minutes.

Engines:

- ``host``    native CDCL alone (device gate closed), conflict-budgeted
              so the replay verdict is a pure function of the query —
              this leg must reproduce the live verdicts
- ``device``  the device funnel alone: compile to the shape bucket,
              exhaustively enumerate small complete spaces (a genuine
              unsat verdict), else the diversified stochastic local
              search plus the cube-and-conquer fan; any witness is
              validated by concrete evaluation ("unknown" proves
              nothing and counts as *incomplete*, not disagreement)
- ``race``    the production funnel with the device gate forced open
              (sprint -> race -> marathon), answering "would the race
              win this query today?"

``--shard I/N`` replays only the content-hash shard ``I`` — the same
deterministic partition the corpus driver uses, so a mesh of N hosts
replays a large corpus in parallel with no coordination.

The port's copy of the JAX package's analysis/solverlab.py. The
device and race engines, the sweep and `run` take a `device` (None:
the card, which must be there; "cpu" runs the plain versions of the
portfolio kernels): the device engine's search runs the hand-written
`portfolio_eval` and `portfolio_sls` kernels there. The portfolio
knobs are arguments of the search kernel, read at each dispatch
(laser/smt/solver/portfolio.py `portfolio_overrides`), so a sweep
trial recompiles nothing, where the JAX sweep drops its kernel cache
on every trial. A corpus either package captured replays in the
other: the artifacts share one schema and one content address.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.observe import querylog

log = logging.getLogger(__name__)

REPORT_SCHEMA_VERSION = 1

ENGINES = ("host", "device", "race")

#: replay verdicts beyond the solver's sat/unsat/unknown
UNSUPPORTED = "unsupported"  # outside the device language / limb cap
INVALID = "invalid"  # witness failed the concrete soundness gate
ERROR = "error"  # engine raised; the artifact names the query

_DECIDED = ("sat", "unsat")


def parse_shard(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``I/N`` -> (I, N); validates bounds."""
    if not spec:
        return None
    try:
        index_s, count_s = spec.split("/", 1)
        index, count = int(index_s), int(count_s)
    except ValueError:
        raise ValueError(f"--shard wants I/N, got {spec!r}")
    if count < 1 or not 0 <= index < count:
        raise ValueError(f"--shard index out of range: {spec!r}")
    return index, count


def shard_corpus(
    corpus: List[Dict], shard: Optional[Tuple[int, int]]
) -> List[Dict]:
    """The deterministic content-hash partition (mesh replay)."""
    if shard is None:
        return corpus
    index, count = shard
    return [
        a for a in corpus if int(a["sha"][:16], 16) % count == index
    ]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _rebuild(artifact: Dict) -> List:
    return querylog.deserialize_terms(artifact["program"])


def _replay_host(lowered: List, timeout_ms: int) -> str:
    """The CDCL alone, conflict-budgeted: deterministic given the
    query whenever the wall valve doesn't fire (same contract as
    --deterministic-solving)."""
    from mythril_tpu_torch.laser.smt.solver.solver import check_terms
    from mythril_tpu_torch.support.support_args import args as _args

    restore = (_args.device_solving, _args.parallel_solving)
    _args.device_solving = "never"
    _args.parallel_solving = False
    try:
        verdict, _model = check_terms(
            lowered, timeout_ms=timeout_ms, conflict_budget=timeout_ms * 8
        )
    finally:
        _args.device_solving, _args.parallel_solving = restore
    return verdict


def _replay_device(
    lowered: List, candidates: int, steps: int, device=None
) -> Tuple[str, Optional[str]]:
    """The device funnel alone (enumeration + diversified SLS +
    cube-and-conquer, no host rungs); returns (verdict, loss_reason).
    A found witness is believed only after concretely satisfying every
    root — the same validation gate production models pass — and a
    complete enumeration's unsat is a genuine device-owned verdict."""
    from mythril_tpu_torch.laser.smt.evalterm import eval_term
    from mythril_tpu_torch.laser.smt.solver import portfolio

    prog, compile_loss = portfolio.compile_program_ex(lowered)
    if prog is None:
        return UNSUPPORTED, compile_loss
    if not prog.var_slots:
        return UNSUPPORTED, querylog.LOSS_QUERY_TRIVIAL
    verdict = portfolio.device_solve_batch(
        [lowered], candidates=candidates, steps=steps, device=device
    )[0]
    if verdict.status == "unsat":
        return "unsat", None
    if verdict.status != "sat":
        return "unknown", verdict.loss
    assignment = verdict.assignment
    try:
        if all(eval_term(c, assignment) for c in lowered):
            return "sat", None
    except Exception:
        log.debug("witness evaluation failed", exc_info=True)
    return INVALID, querylog.LOSS_WITNESS_INVALID


def _replay_race(lowered: List, timeout_ms: int, device=None) -> str:
    """The production funnel with the device gate forced open."""
    from mythril_tpu_torch.laser.smt.solver.solver import check_terms
    from mythril_tpu_torch.support.support_args import args as _args

    restore = (_args.device_solving, _args.parallel_solving)
    _args.device_solving = "always"
    _args.parallel_solving = True
    try:
        verdict, _model = check_terms(
            lowered, timeout_ms=timeout_ms, device=device
        )
    finally:
        _args.device_solving, _args.parallel_solving = restore
    return verdict


def _classify(live: str, replayed: str) -> str:
    if replayed == live:
        return "agree"
    if replayed in _DECIDED and live in _DECIDED:
        return "disagree"
    return "incomplete"


# ---------------------------------------------------------------------------
# the lab
# ---------------------------------------------------------------------------


def waterfall(corpus: Sequence[Dict]) -> Dict:
    """The funnel-loss report of a corpus as CAPTURED: loss reasons
    overall and restricted to host-WON (sat) queries, origins,
    shape-bucket population, per-engine live verdicts."""
    losses: Dict[str, int] = {}
    losses_sat: Dict[str, int] = {}
    origins: Dict[str, int] = {}
    buckets: Dict[str, int] = {}
    verdicts: Dict[str, int] = {}
    for artifact in corpus:
        verdict = artifact.get("verdict", "unknown")
        verdicts[verdict] = verdicts.get(verdict, 0) + 1
        origin = artifact.get("origin", "?")
        origins[origin] = origins.get(origin, 0) + 1
        reason = artifact.get("loss_reason")
        if reason:
            losses[reason] = losses.get(reason, 0) + 1
            if verdict == "sat":
                losses_sat[reason] = losses_sat.get(reason, 0) + 1
        bucket = artifact.get("bucket")
        key = (
            "n{nodes}/c{consts}/r{roots}/v{vars}/L{limbs}".format(**bucket)
            if bucket
            else artifact.get("compile_loss") or "uncompiled"
        )
        buckets[key] = buckets.get(key, 0) + 1
    return {
        "queries": len(corpus),
        "live_verdicts": verdicts,
        "origins": origins,
        "buckets": buckets,
        "loss_waterfall": losses,
        "loss_waterfall_sat": losses_sat,
    }


def replay_corpus(
    corpus: Sequence[Dict],
    engines: Sequence[str] = ("host", "device"),
    timeout_ms: int = 10_000,
    candidates: int = 64,
    steps: int = 512,
    device=None,
) -> Dict:
    """Re-run every artifact against `engines`; returns the report
    dict (waterfall + per-engine verdict/wall/agreement tables +
    disagreement details). Capture is disarmed for the duration so the
    replay never mutates the corpus it reads."""
    for engine in engines:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (have {ENGINES})")
    report = waterfall(corpus)
    report["schema_version"] = REPORT_SCHEMA_VERSION
    report["engines"] = list(engines)
    tables: Dict[str, Dict] = {
        engine: {
            "verdicts": {},
            "wall_s": 0.0,
            "agreement": {"agree": 0, "disagree": 0, "incomplete": 0},
        }
        for engine in engines
    }
    disagreements: List[Dict] = []

    prev_capture = querylog.capture_dir()
    querylog.configure_capture(None)
    try:
        for artifact in corpus:
            live = artifact.get("verdict", "unknown")
            try:
                lowered = _rebuild(artifact)
            except Exception as why:
                log.warning(
                    "artifact %s did not rebuild: %s", artifact["sha"], why
                )
                for engine in engines:
                    table = tables[engine]
                    table["verdicts"][ERROR] = (
                        table["verdicts"].get(ERROR, 0) + 1
                    )
                    table["agreement"]["incomplete"] += 1
                continue
            row = {"sha": artifact["sha"], "live": live}
            for engine in engines:
                t0 = time.perf_counter()
                try:
                    if engine == "host":
                        verdict = _replay_host(lowered, timeout_ms)
                    elif engine == "device":
                        verdict, _loss = _replay_device(
                            lowered, candidates, steps, device=device
                        )
                    else:
                        verdict = _replay_race(
                            lowered, timeout_ms, device=device
                        )
                except Exception as why:
                    log.debug(
                        "engine %s failed on %s: %s",
                        engine, artifact["sha"], why, exc_info=True,
                    )
                    verdict = ERROR
                wall = time.perf_counter() - t0
                table = tables[engine]
                table["verdicts"][verdict] = (
                    table["verdicts"].get(verdict, 0) + 1
                )
                table["wall_s"] += wall
                outcome = _classify(live, verdict)
                table["agreement"][outcome] += 1
                row[engine] = verdict
                if outcome == "disagree":
                    row["disagree"] = True
            if row.get("disagree") and len(disagreements) < 32:
                disagreements.append(row)
    finally:
        querylog.configure_capture(prev_capture)

    for engine, table in tables.items():
        table["wall_s"] = round(table["wall_s"], 3)
        n = len(corpus)
        table["agreement_pct"] = (
            round(100.0 * table["agreement"]["agree"] / n, 1) if n else 100.0
        )
    report["replay"] = tables
    report["disagreements"] = disagreements
    return report


# ---------------------------------------------------------------------------
# portfolio tuning: `solverlab tune`
# ---------------------------------------------------------------------------

#: the tunable diversified-portfolio knobs and their sweep axes. The
#: committed winners live in portfolio.PORTFOLIO_DEFAULTS — re-run the
#: tune against a fresh capture before changing them by hand.
TUNE_GRID: Dict[str, List] = {
    "noise_lo": [0.0, 0.02, 0.08],
    "noise_hi": [0.2, 0.4, 0.6],
    "greedy_frac": [0.25, 0.5, 0.75],
    "restart_base": [12, 24, 48],
    "seeded_frac": [0.0, 0.25, 0.5],
    "cube_depth": [0, 2, 3, 4],
    "first_pass_steps": [96, 192, 384],
}


def _tune_trial(
    lowered_queries: List[List], candidates: int, knobs: Dict, device=None
) -> Dict:
    """One sweep point: replay the device funnel over the corpus under
    `portfolio_overrides(**knobs)`. Scored on decided queries (sat +
    device-owned unsat, witnesses validated inside device_solve_batch)
    then wall — more verdicts first, faster second."""
    from mythril_tpu_torch.laser.smt.solver import portfolio

    t0 = time.perf_counter()
    with portfolio.portfolio_overrides(**knobs):
        verdicts = portfolio.device_solve_batch(
            lowered_queries, candidates=candidates, device=device
        )
    wall = time.perf_counter() - t0
    sat_n = sum(1 for v in verdicts if v.status == "sat")
    unsat_n = sum(1 for v in verdicts if v.status == "unsat")
    return {
        "knobs": dict(knobs),
        "sat": sat_n,
        "unsat": unsat_n,
        "decided": sat_n + unsat_n,
        "unknown": len(verdicts) - sat_n - unsat_n,
        "wall_s": round(wall, 3),
    }


def tune_corpus(
    corpus: Sequence[Dict],
    trials: int = 12,
    sweep: str = "random",
    seed: int = 1,
    candidates: int = 64,
    device=None,
) -> Dict:
    """Sweep the portfolio knobs over a captured corpus and rank the
    results — the offline lab that derives PORTFOLIO_DEFAULTS.

    ``sweep="grid"`` walks one knob at a time off the current defaults
    (a coordinate sweep: len(axis) trials per knob, `trials` ignored);
    ``sweep="random"`` samples `trials` random grid combinations.
    The knobs are arguments of the search kernel, read at each
    dispatch, so a trial recompiles nothing; run the sweep offline and
    commit the winner."""
    import random as _random

    from mythril_tpu_torch.laser.smt.solver import portfolio

    lowered_queries: List[List] = []
    for artifact in corpus:
        try:
            lowered_queries.append(_rebuild(artifact))
        except Exception as why:
            log.warning(
                "artifact %s did not rebuild: %s", artifact["sha"], why
            )
    report: Dict = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "queries": len(lowered_queries),
        "sweep": sweep,
        "defaults": dict(portfolio.PORTFOLIO_DEFAULTS),
    }
    results: List[Dict] = []
    if not lowered_queries:
        report["trials"] = results
        return report
    # the committed defaults are always trial 0 — the bar to beat
    baseline = _tune_trial(lowered_queries, candidates, {}, device=device)
    baseline["baseline"] = True
    results.append(baseline)
    if sweep == "grid":
        for knob, axis in sorted(TUNE_GRID.items()):
            for value in axis:
                if value == portfolio.PORTFOLIO_DEFAULTS.get(knob):
                    continue  # the baseline already covers it
                results.append(
                    _tune_trial(
                        lowered_queries, candidates, {knob: value},
                        device=device,
                    )
                )
    elif sweep == "random":
        rng = _random.Random(seed)
        seen = set()
        for _ in range(max(0, trials)):
            knobs = {
                knob: rng.choice(axis)
                for knob, axis in sorted(TUNE_GRID.items())
            }
            key = tuple(sorted(knobs.items()))
            if key in seen:
                continue
            seen.add(key)
            results.append(
                _tune_trial(lowered_queries, candidates, knobs, device=device)
            )
    else:
        raise ValueError(f"unknown sweep {sweep!r} (grid|random)")
    ranked = sorted(
        results, key=lambda r: (-r["decided"], r["wall_s"])
    )
    report["trials"] = ranked
    report["best"] = ranked[0]
    report["beats_baseline"] = (
        ranked[0] is not baseline
        and ranked[0]["decided"] > baseline["decided"]
    )
    return report


def run(
    corpus_dir: str,
    mode: str = "replay",
    engines: Sequence[str] = ("host", "device"),
    timeout_ms: int = 10_000,
    candidates: int = 64,
    steps: int = 512,
    reason: Optional[str] = None,
    origin: Optional[str] = None,
    shard: Optional[str] = None,
    trials: int = 12,
    sweep: str = "random",
    tune_seed: int = 1,
    watch: bool = False,
    watch_out: Optional[str] = None,
    watch_interval_s: float = 30.0,
    watch_min_new: int = 8,
    watch_rounds: int = 0,
    device=None,
) -> Dict:
    """Load + filter + shard a corpus, then replay, tune, or report.

    ``mode="tune", watch=True`` is the continuous-self-tuning loop
    (`solverlab tune --watch`): instead of one sweep it delegates
    to routing/tuning.py's watcher, which re-tunes as the capture
    corpus grows and promotes gate-passing winners as versioned
    ``tuned-v<N>.json`` override artifacts in `watch_out`."""
    if watch:
        if mode != "tune":
            raise ValueError("--watch only applies to `solverlab tune`")
        from mythril_tpu_torch.routing import tuning as _tuning

        return _tuning.tune_watch(
            corpus_dir,
            watch_out or corpus_dir,
            interval_s=watch_interval_s,
            min_new=watch_min_new,
            rounds=watch_rounds,
            trials=trials,
            sweep=sweep,
            tune_seed=tune_seed,
            candidates=candidates,
            timeout_ms=timeout_ms,
            reason=reason,
            origin=origin,
            device=device,
        )
    corpus = querylog.load_corpus(corpus_dir, reason=reason, origin=origin)
    corpus = shard_corpus(corpus, parse_shard(shard))
    if mode == "report":
        report = waterfall(corpus)
        report["schema_version"] = REPORT_SCHEMA_VERSION
    elif mode == "tune":
        report = tune_corpus(
            corpus,
            trials=trials,
            sweep=sweep,
            seed=tune_seed,
            candidates=candidates,
            device=device,
        )
    else:
        report = replay_corpus(
            corpus,
            engines=engines,
            timeout_ms=timeout_ms,
            candidates=candidates,
            steps=steps,
            device=device,
        )
    report["corpus_dir"] = corpus_dir
    report["mode"] = mode
    if reason or origin:
        report["filter"] = {"reason": reason, "origin": origin}
    if shard:
        report["shard"] = shard
    return report


def render_tune_text(report: Dict) -> str:
    """The human view of a tune sweep: the ranked knob table."""
    lines = [
        "solverlab tune: {q} quer{y} from {d} ({s} sweep)".format(
            q=report.get("queries", 0),
            y="y" if report.get("queries") == 1 else "ies",
            d=report.get("corpus_dir", "?"),
            s=report.get("sweep", "?"),
        )
    ]
    trials = report.get("trials") or []
    if not trials:
        lines.append("  (no replayable queries in the corpus)")
        return "\n".join(lines)
    lines.append(
        f"  {'rank':<5}{'decided':<9}{'sat':<6}{'unsat':<7}"
        f"{'wall_s':<9}knobs"
    )
    for rank, row in enumerate(trials, 1):
        tag = " (baseline: committed defaults)" if row.get("baseline") else ""
        knobs = (
            " ".join(
                f"{k}={v}" for k, v in sorted(row["knobs"].items())
            )
            or "-"
        )
        lines.append(
            f"  {rank:<5}{row['decided']:<9}{row['sat']:<6}"
            f"{row['unsat']:<7}{row['wall_s']:<9}{knobs}{tag}"
        )
    if report.get("beats_baseline"):
        lines.append(
            "  -> the winner BEATS the committed defaults: consider "
            "updating portfolio.PORTFOLIO_DEFAULTS"
        )
    else:
        lines.append("  -> the committed defaults hold")
    return "\n".join(lines)


def render_watch_text(report: Dict) -> str:
    """The human view of a tune-watch run: one row per round."""
    lines = [
        "solverlab tune --watch: {d} -> {o}".format(
            d=report.get("corpus_dir", "?"), o=report.get("out_dir", "?")
        )
    ]
    for row in report.get("rounds") or []:
        bits = [
            f"round {row['round']}: {row['queries']} queries "
            f"({row['new']} new)"
        ]
        if "beats_baseline" in row:
            bits.append(
                "winner beats baseline"
                if row["beats_baseline"]
                else "defaults hold"
            )
        gate = row.get("gate")
        if gate:
            bits.append(
                "gate {}: agree {} / disagree {} / incomplete {}".format(
                    "PASS" if gate["pass"] else "FAIL",
                    gate["agree"], gate["disagree"], gate["incomplete"],
                )
            )
        if row.get("promoted"):
            bits.append(f"promoted -> {row['promoted']}")
        lines.append("  " + "; ".join(bits))
    lines.append(
        f"  promoted artifact: {report.get('promoted') or '(none)'}"
    )
    return "\n".join(lines)


def render_text(report: Dict) -> str:
    """The human view: waterfall + agreement tables."""
    if report.get("mode") == "tune-watch":
        return render_watch_text(report)
    if report.get("mode") == "tune" or "trials" in report:
        return render_tune_text(report)
    lines = [
        "solverlab: {queries} quer{y} from {dir}".format(
            queries=report["queries"],
            y="y" if report["queries"] == 1 else "ies",
            dir=report.get("corpus_dir", "?"),
        )
    ]
    if report.get("filter"):
        lines.append(f"  filter: {report['filter']}")
    if report.get("shard"):
        lines.append(f"  shard: {report['shard']}")
    lines.append("  live verdicts: " + _fmt_counts(report["live_verdicts"]))
    lines.append("  origins:       " + _fmt_counts(report["origins"]))
    lines.append("  loss waterfall (device-lost verdicts):")
    losses = report["loss_waterfall"]
    sat_losses = report.get("loss_waterfall_sat", {})
    for reason in sorted(losses, key=losses.get, reverse=True):
        lines.append(
            f"    {reason:<22} {losses[reason]:>6}"
            f"   (host-won: {sat_losses.get(reason, 0)})"
        )
    if not losses:
        lines.append("    (none recorded)")
    lines.append("  shape buckets: " + _fmt_counts(report["buckets"]))
    for engine, table in (report.get("replay") or {}).items():
        agreement = table["agreement"]
        lines.append(
            f"  engine {engine:<7} verdicts "
            f"{_fmt_counts(table['verdicts'])}  wall {table['wall_s']}s"
        )
        lines.append(
            f"         {'':<7} agreement {table['agreement_pct']}% "
            f"(agree {agreement['agree']} / disagree "
            f"{agreement['disagree']} / incomplete "
            f"{agreement['incomplete']})"
        )
    for row in report.get("disagreements") or []:
        lines.append(f"  DISAGREE {row}")
    return "\n".join(lines)


def _fmt_counts(table: Dict[str, int]) -> str:
    if not table:
        return "(none)"
    return " ".join(
        f"{key}={table[key]}"
        for key in sorted(table, key=table.get, reverse=True)
    )
