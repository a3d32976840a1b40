"""The router's cost model: regularized linear/logistic heads per
route over the routing-JSONL v4 feature columns.

Deliberately tiny and dependency-free (numpy only, closed-form ridge
+ fixed-iteration logistic descent) so training is deterministic on
any box and the artifact stays a page of JSON: per route the model
predicts ``log1p(wall_s)`` and a success probability; the router
picks the minimum expected cost ``exp(wall) / max(p_success, floor)``
across the tiers a call site actually offers.

Only the routes the router can CHOOSE between are trainable classes
(`TRAINABLE_ROUTES`).  The microsecond triage tiers — store hit,
static answer, quarantine, skip — settle before any routing decision
and are excluded from training; ``routed-<tier>`` / ``promoted-
<tier>`` records (the router's own decisions feeding back) normalize
onto the tier they named, so the flywheel trains on its own traffic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the numeric feature columns the model reads, in artifact order —
#: the full v4 routing-record vector minus the non-numeric columns
#: (`phase_bucket` is an opaque key; `link_proxy_kind` collapses to a
#: presence flag). Absent/None entries impute to the training mean.
FEATURE_COLUMNS = (
    "code_bytes",
    "storage_op_density",
    "call_op_density",
    "cfg_blocks",
    "cfg_reachable_blocks",
    "instructions",
    "selectors",
    "dead_selectors",
    "dead_directions",
    "modules_screened",
    "taint_density",
    "tainted_sinks",
    "resolved_call_targets",
    "fingerprints",
    "static_answerable",
    "link_out_degree",
    "link_resolved_degree",
    "link_is_proxy",
    "link_proxy_kind",  # presence flag: 1.0 when a proxy kind named
    "link_delegatecall_sites",
    "link_escape_density",
    "phase_bucket_pruned",
    "fuse_profitable",
)

#: the route classes the router chooses between (ladder order)
TRAINABLE_ROUTES = ("host-walk", "device-waves")

#: observed-route -> trainable class; None = excluded from training
_ROUTE_CLASS = {
    "host-walk": "host-walk",
    "device-owned": "device-waves",
    # an incremental store re-analysis still paid device waves for the
    # changed selectors — cost-wise it is a (cheap) device-waves row
    "store-incremental": "device-waves",
}


def normalize_route(route: Optional[str]) -> Optional[str]:
    """The trainable class for an observed route string, or None for
    the pre-router triage tiers. ``routed-X`` / ``promoted-X`` (the
    router's own vocabulary) normalize onto X."""
    if not route:
        return None
    for prefix in ("routed-", "promoted-"):
        if route.startswith(prefix):
            route = route[len(prefix):]
            break
    if route in TRAINABLE_ROUTES:
        return route
    return _ROUTE_CLASS.get(route)


def _coerce(column: str, value) -> Optional[float]:
    if value is None:
        return None
    if column == "link_proxy_kind":
        return 1.0 if value else 0.0
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    try:
        out = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(out):
        return None
    return out


def feature_vector(features: Dict) -> List[Optional[float]]:
    """One record's features -> per-column float-or-None row."""
    features = features or {}
    return [_coerce(col, features.get(col)) for col in FEATURE_COLUMNS]


def _design_matrix(
    rows: Sequence[Sequence[Optional[float]]],
    impute: Sequence[float],
    scale: Sequence[float],
) -> np.ndarray:
    x = np.empty((len(rows), len(FEATURE_COLUMNS)), dtype=np.float64)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            x[i, j] = impute[j] if v is None else v
    return (x - np.asarray(impute)) / np.asarray(scale)


def _fit_ridge(x: np.ndarray, y: np.ndarray, lam: float) -> Tuple[np.ndarray, float]:
    """Closed-form ridge with an unpenalized intercept."""
    n, d = x.shape
    xb = np.hstack([x, np.ones((n, 1))])
    reg = lam * np.eye(d + 1)
    reg[d, d] = 0.0
    w = np.linalg.solve(xb.T @ xb + reg, xb.T @ y)
    return w[:d], float(w[d])


def _fit_logistic(
    x: np.ndarray, y: np.ndarray, lam: float, iters: int = 200, lr: float = 0.5
) -> Tuple[np.ndarray, float]:
    """Fixed-iteration full-batch gradient descent — deterministic by
    construction (no shuffling, no early stop)."""
    n, d = x.shape
    w = np.zeros(d)
    b = 0.0
    for _ in range(iters):
        z = np.clip(x @ w + b, -30.0, 30.0)
        p = 1.0 / (1.0 + np.exp(-z))
        grad_w = x.T @ (p - y) / n + lam * w
        grad_b = float(np.mean(p - y))
        w -= lr * grad_w
        b -= lr * grad_b
    return w, b


def train_model(records: Sequence[Dict], lam: float = 1.0) -> Dict:
    """Fit the per-route heads from parsed routing records.

    Returns the model dict the artifact layer serializes: shared
    impute/scale plus, per trainable route, ridge weights on
    ``log1p(wall_s)`` and logistic weights on success. Routes with no
    rows are simply absent — the router treats a missing head as "no
    opinion" and falls back to heuristics for that tier. Raises
    ValueError when NO route has a single trainable row."""
    rows: List[List[Optional[float]]] = []
    walls: List[float] = []
    succ: List[float] = []
    routes: List[str] = []
    for rec in records:
        out = rec.get("outcome") or {}
        cls = normalize_route(out.get("route"))
        wall = out.get("wall_s")
        if cls is None or wall is None:
            continue
        try:
            wall = float(wall)
        except (TypeError, ValueError):
            continue
        if not math.isfinite(wall) or wall < 0:
            continue
        rows.append(feature_vector(rec.get("features")))
        walls.append(wall)
        succ.append(
            1.0
            if (out.get("complete") and not out.get("error"))
            else 0.0
        )
        routes.append(cls)
    if not rows:
        raise ValueError("no trainable routing records (wall_s + route)")

    d = len(FEATURE_COLUMNS)
    # column means over PRESENT values (imputation targets) + scales
    sums = np.zeros(d)
    counts = np.zeros(d)
    for row in rows:
        for j, v in enumerate(row):
            if v is not None:
                sums[j] += v
                counts[j] += 1
    impute = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    filled = np.empty((len(rows), d))
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            filled[i, j] = impute[j] if v is None else v
    scale = np.std(filled, axis=0)
    scale = np.where(scale > 1e-9, scale, 1.0)

    x = _design_matrix(rows, impute, scale)
    walls_a = np.asarray(walls)
    succ_a = np.asarray(succ)
    routes_a = np.asarray(routes)

    per_route: Dict[str, Dict] = {}
    for route in TRAINABLE_ROUTES:
        mask = routes_a == route
        n = int(np.sum(mask))
        if n == 0:
            continue
        xr = x[mask]
        yr = np.log1p(walls_a[mask])
        wall_w, wall_b = _fit_ridge(xr, yr, lam)
        sr = succ_a[mask]
        if sr.min() == sr.max():
            # degenerate label column: pin the head to the constant
            succ_w = np.zeros(d)
            succ_b = 30.0 if sr[0] > 0.5 else -30.0
        else:
            succ_w, succ_b = _fit_logistic(xr, sr, lam / max(n, 1))
        per_route[route] = {
            "n": n,
            "mean_wall_s": float(np.mean(walls_a[mask])),
            "wall_w": [float(v) for v in wall_w],
            "wall_b": wall_b,
            "succ_w": [float(v) for v in succ_w],
            "succ_b": float(succ_b),
        }
    return {
        "features": list(FEATURE_COLUMNS),
        "impute": [float(v) for v in impute],
        "scale": [float(v) for v in scale],
        "routes": per_route,
        "trained_rows": len(rows),
    }


def predict(model: Dict, features: Dict) -> Dict[str, Tuple[float, float]]:
    """Per-route ``(wall_s, p_success)`` predictions for one feature
    dict, for every route the model carries a head for."""
    impute = model["impute"]
    scale = model["scale"]
    row = feature_vector(features)
    x = np.array(
        [
            (impute[j] if v is None else v - 0.0)
            for j, v in enumerate(row)
        ],
        dtype=np.float64,
    )
    x = (x - np.asarray(impute)) / np.asarray(scale)
    out: Dict[str, Tuple[float, float]] = {}
    for route, head in (model.get("routes") or {}).items():
        wall = math.expm1(
            float(np.dot(x, np.asarray(head["wall_w"])) + head["wall_b"])
        )
        wall = max(0.0, wall)
        z = float(np.dot(x, np.asarray(head["succ_w"])) + head["succ_b"])
        z = max(-30.0, min(30.0, z))
        p = 1.0 / (1.0 + math.exp(-z))
        out[route] = (wall, p)
    return out


def attributions(model: Dict, features: Dict, route: str) -> List[Tuple[str, float]]:
    """Per-feature ``w_i * x_i`` wall-head contributions for one route
    (``route explain``), sorted by absolute weight."""
    head = (model.get("routes") or {}).get(route)
    if head is None:
        return []
    impute = model["impute"]
    scale = model["scale"]
    row = feature_vector(features)
    out = []
    for j, col in enumerate(FEATURE_COLUMNS):
        v = impute[j] if row[j] is None else row[j]
        xj = (v - impute[j]) / scale[j]
        out.append((col, float(head["wall_w"][j]) * xj))
    out.sort(key=lambda kv: -abs(kv[1]))
    return out
