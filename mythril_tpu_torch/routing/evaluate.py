"""Offline evaluation of a router against a routing JSONL log:
``route eval`` (per-route regret vs the model oracle) and
``route explain`` (per-feature attributions for one contract).

Regret here is the standard logged-policy estimate: for every record
whose observed route is trainable, the model prices every tier; the
oracle takes the cheapest, the logged policy paid the model's price
for the route it actually took.  The gap, summed, is how many
predicted seconds uniform routing left on the table — the number the
bench's ``routing_regret`` field carries."""

from __future__ import annotations

from typing import Dict, List, Optional

from mythril_tpu_torch.routing import model as _model
from mythril_tpu_torch.routing.router import P_SUCCESS_FLOOR, Router


def _cost(wall: float, p: float) -> float:
    return wall / max(p, P_SUCCESS_FLOOR)


def evaluate_log(records: List[Dict], router: Router) -> Dict:
    """Per-route counts + regret-vs-oracle over parsed records."""
    per_route: Dict[str, Dict] = {}
    total_regret = 0.0
    scored = 0
    agreements = 0
    for rec in records:
        out = rec.get("outcome") or {}
        logged = _model.normalize_route(out.get("route"))
        if logged is None:
            continue
        expected = router.predict(rec.get("features") or {})
        if logged not in expected or not expected:
            continue
        costs = {r: _cost(w, p) for r, (w, p) in expected.items()}
        oracle_route = min(costs, key=lambda r: (costs[r], r))
        regret = max(0.0, costs[logged] - costs[oracle_route])
        scored += 1
        total_regret += regret
        if oracle_route == logged:
            agreements += 1
        row = per_route.setdefault(
            logged,
            {"n": 0, "regret_s": 0.0, "oracle_agrees": 0,
             "observed_wall_s": 0.0},
        )
        row["n"] += 1
        row["regret_s"] += regret
        row["oracle_agrees"] += 1 if oracle_route == logged else 0
        wall = out.get("wall_s")
        if isinstance(wall, (int, float)):
            row["observed_wall_s"] += float(wall)
    for row in per_route.values():
        row["regret_s"] = round(row["regret_s"], 6)
        row["observed_wall_s"] = round(row["observed_wall_s"], 6)
    return {
        "router_version": router.version,
        "records": len(records),
        "scored": scored,
        "regret_s": round(total_regret, 6),
        "oracle_agreement": round(agreements / scored, 4) if scored else None,
        "per_route": per_route,
    }


def explain_record(
    rec: Dict, router: Router, top: int = 10
) -> Dict:
    """The route the model would pick for one record, with the top
    per-feature wall-head attributions for every priced tier."""
    features = rec.get("features") or {}
    decision = router.decide(features)
    expected = router.predict(features)
    out: Dict = {
        "contract": rec.get("contract"),
        "code_hash": rec.get("code_hash"),
        "logged_route": (rec.get("outcome") or {}).get("route"),
        "chosen_route": decision.route if decision else None,
        "router_version": router.version,
        "expected": {
            r: {"wall_s": round(w, 6), "p_success": round(p, 4),
                "cost": round(_cost(w, p), 6)}
            for r, (w, p) in sorted(expected.items())
        },
        "attributions": {},
    }
    for route in sorted(expected):
        rows = _model.attributions(router.model, features, route)[:top]
        out["attributions"][route] = [
            {"feature": name, "wall_contribution": round(v, 6)}
            for name, v in rows
        ]
    return out


def find_record(records: List[Dict], selector: Optional[str]) -> Optional[Dict]:
    """The record `route explain` targets: by contract name or
    code-hash prefix; default the last record."""
    if not records:
        return None
    if not selector:
        return records[-1]
    for rec in reversed(records):
        if rec.get("contract") == selector:
            return rec
        if str(rec.get("code_hash") or "").startswith(selector):
            return rec
    return None
