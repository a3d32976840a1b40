"""Solver query telemetry: per-origin attribution of every SAT/SMT
verdict.

The port's copy of the JAX package's observe/solverstats.py: every
query is tagged with its **origin** (which engine answered it), its
**verdict**, its wall and its escalation hops, and the counts aggregate
into the attribution table (`attribution()`).

Origins, in escalation-ladder order:

    memo              the get_model verdict cache pre-empted the solve
    host-cdcl         native CDCL (sprint or marathon)
    device-portfolio  the card's portfolio (race wins, the
                      --parallel-solving escape) — hop >= 1
    host-z3           reserved: an external-solver escalation rung
                      (not wired; the label is part of the schema)

The JAX package backs these counts with ``mtpu_solver_*`` series of its
metrics registry (scraped at /metrics, with a per-query wall
histogram); the port keeps them in a plain in-process table until the
registry is ported (ROADMAP Queue 1 item 9). `marker()` and
`attribution(since)` give per-run deltas as the JAX ones do.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: the stable origin labels (see module docstring)
ORIGIN_MEMO = "memo"
ORIGIN_HOST_CDCL = "host-cdcl"
ORIGIN_DEVICE = "device-portfolio"
ORIGIN_Z3 = "host-z3"

_MU = threading.Lock()
#: (origin, verdict) -> queries
_QUERIES: Dict[Tuple[str, str], int] = {}
#: origin -> wall seconds
_WALL: Dict[str, float] = {}
#: origin -> escalation hops
_ESCALATIONS: Dict[str, int] = {}


def record_query(
    origin: str, verdict: str, wall_s: float = 0.0, hop: int = 0
) -> None:
    """Tag one solver query: `origin` answered it with `verdict`
    ("sat"/"unsat"/"unknown"/"timeout") after `wall_s` seconds and
    `hop` escalation rungs. Honors the global observe switch."""
    from mythril_tpu_torch import observe

    if not observe.enabled():
        return
    with _MU:
        key = (origin, verdict)
        _QUERIES[key] = _QUERIES.get(key, 0) + 1
        if wall_s:
            _WALL[origin] = _WALL.get(origin, 0.0) + wall_s
        if hop > 0:
            _ESCALATIONS[origin] = _ESCALATIONS.get(origin, 0) + hop


def marker() -> Dict:
    """A snapshot of the tables, for per-run attribution deltas."""
    with _MU:
        return {"queries": dict(_QUERIES), "wall": dict(_WALL),
                "escalations": dict(_ESCALATIONS)}


def attribution(since: Optional[Dict] = None) -> Dict[str, Dict]:
    """The per-origin attribution table:

        {origin: {"queries": n, "verdicts": {verdict: n},
                  "wall_s": seconds, "escalations": n}}

    Over the whole process, or as a delta when `since` (a `marker()`)
    is given."""
    now = marker()
    base = since or {"queries": {}, "wall": {}, "escalations": {}}
    out: Dict[str, Dict] = {}

    def row(origin: str) -> Dict:
        return out.setdefault(origin, {"queries": 0, "verdicts": {},
                                       "wall_s": 0.0, "escalations": 0})

    for (origin, verdict), n in now["queries"].items():
        n -= base["queries"].get((origin, verdict), 0)
        if n:
            entry = row(origin)
            entry["queries"] += n
            entry["verdicts"][verdict] = entry["verdicts"].get(verdict, 0) + n
    for origin, wall in now["wall"].items():
        wall -= base["wall"].get(origin, 0.0)
        if wall > 0:
            row(origin)["wall_s"] = round(wall, 3)
    for origin, hops in now["escalations"].items():
        hops -= base["escalations"].get(origin, 0)
        if hops:
            row(origin)["escalations"] = hops
    return out
