"""Solver query telemetry: per-origin attribution of every SAT/SMT
verdict.

Which engine answered which query, at what cost, after how many
escalation hops: `SolverStatistics` keeps two global sat counts; this
module tags every query with its **origin** and **verdict** and
aggregates them into the attribution table that lands in the jsonv2
report meta (`solver_attribution`).

Origins, in escalation-ladder order:

    memo              the get_model verdict cache pre-empted the solve
    host-cdcl         native CDCL (sprint or marathon)
    device-portfolio  the on-chip portfolio (flip batches, race wins,
                      the --parallel-solving escape hatch) — hop >= 1
    host-z3           reserved: an external-solver escalation rung
                      (not wired in this build; the label is part of
                      the stable schema so downstream dashboards don't
                      churn when it lands)

Backing store is the metrics registry (mtpu_solver_* series), so the
table is also scraped at /metrics and per-run deltas ride the same
marker machinery everything else uses.

The port's copy of the JAX package's observe/solverstats.py, on the
port's registry: ``mtpu_solver_queries_total{origin,verdict}`` is the
series the health machine's `solver-escalation-share` objective
(observe/slo.py) reads, so that objective fires in the port as it does
in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

from mythril_tpu_torch.observe.registry import SOLVER_WALL_BUCKETS, registry

#: the stable origin labels (see module docstring)
ORIGIN_MEMO = "memo"
ORIGIN_HOST_CDCL = "host-cdcl"
ORIGIN_DEVICE = "device-portfolio"
ORIGIN_Z3 = "host-z3"

_QUERIES = None
_WALL = None
_WALL_HIST = None
_ESCALATIONS = None
_METRICS_REG = None


def _metrics():
    # handles re-resolve when the registry instance changes
    # (reset_registry in tests) — a cached child writing to an
    # orphaned registry is a silent telemetry sink
    global _QUERIES, _WALL, _WALL_HIST, _ESCALATIONS, _METRICS_REG
    if _QUERIES is None or _METRICS_REG is not registry():
        reg = _METRICS_REG = registry()
        _QUERIES = reg.counter(
            "mtpu_solver_queries_total",
            "SAT/SMT queries by answering origin and verdict",
        )
        _WALL = reg.counter(
            "mtpu_solver_wall_seconds_total",
            "solver wall seconds by answering origin",
        )
        # per-query wall distribution on its own ladder: memo hits
        # are microseconds, CDCL marathons tens of seconds — the
        # default bucket ladder crushes the warm end into one bucket
        _WALL_HIST = reg.histogram(
            "mtpu_solver_query_seconds",
            "per-query solver wall by answering origin",
            buckets=SOLVER_WALL_BUCKETS,
        )
        _ESCALATIONS = reg.counter(
            "mtpu_solver_escalations_total",
            "queries that climbed past the first ladder rung, by origin",
        )
    return _QUERIES, _WALL, _ESCALATIONS


def record_query(
    origin: str, verdict: str, wall_s: float = 0.0, hop: int = 0
) -> None:
    """Tag one solver query: `origin` answered it with `verdict`
    ("sat"/"unsat"/"unknown"/"timeout") after `wall_s` seconds and
    `hop` escalation rungs. Honors the global observe switch."""
    from mythril_tpu_torch import observe

    if not observe.enabled():
        return
    queries, wall, escalations = _metrics()
    queries.labels(origin=origin, verdict=verdict).inc()
    if wall_s:
        wall.labels(origin=origin).inc(wall_s)
        _WALL_HIST.labels(origin=origin).observe(wall_s)
    if hop > 0:
        escalations.labels(origin=origin).inc(hop)


def marker() -> Dict:
    """Registry snapshot for per-run attribution deltas."""
    _metrics()
    return registry().marker()


def attribution(since: Optional[Dict] = None) -> Dict[str, Dict]:
    """The per-origin attribution table:

        {origin: {"queries": n, "verdicts": {verdict: n},
                  "wall_s": seconds, "escalations": n}}

    Over the whole process, or as a delta when `since` (a `marker()`)
    is given — the per-run form the report meta embeds."""
    _metrics()
    reg = registry()
    snap = reg.since(since) if since is not None else reg.snapshot()
    out: Dict[str, Dict] = {}

    def row(origin: str) -> Dict:
        entry = out.get(origin)
        if entry is None:
            entry = out[origin] = {
                "queries": 0,
                "verdicts": {},
                "wall_s": 0.0,
                "escalations": 0,
            }
        return entry

    for key, value in (snap.get("mtpu_solver_queries_total") or {}).items():
        labels = dict(key)
        entry = row(labels.get("origin", "?"))
        verdict = labels.get("verdict", "?")
        entry["queries"] += int(value)
        entry["verdicts"][verdict] = (
            entry["verdicts"].get(verdict, 0) + int(value)
        )
    for key, value in (
        snap.get("mtpu_solver_wall_seconds_total") or {}
    ).items():
        row(dict(key).get("origin", "?"))["wall_s"] = round(value, 3)
    for key, value in (
        snap.get("mtpu_solver_escalations_total") or {}
    ).items():
        row(dict(key).get("origin", "?"))["escalations"] = int(value)
    return out
