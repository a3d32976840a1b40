"""The runtime face of the cost model: load-once Router objects plus
the process-wide configured router the three mount points share.

A ``Router`` answers one question — given a contract's routing
features and the tiers a call site can actually offer, which tier has
the minimum expected cost ``predicted_wall / max(p_success, floor)``?
Every decision, promotion and regret estimate is counted
(``mtpu_router_*``).  When no artifact is configured (or the latest
one is refused) ``configured_router()`` returns None and every mount
point keeps today's heuristics bit-for-bit — the router is an
overlay, never a dependency."""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.routing import artifact as _artifact
from mythril_tpu_torch.routing import model as _model

log = logging.getLogger(__name__)

#: success-probability floor: a route the model thinks always fails
#: still gets a finite (large) expected cost instead of an inf that
#: would NaN comparisons
P_SUCCESS_FLOOR = 0.05

#: env override for the artifact directory (the CLI flags win)
ENV_DIR = "MYTHRIL_ROUTER_DIR"


def _counters():
    from mythril_tpu_torch.observe.registry import registry

    reg = registry()
    return {
        "decisions": reg.counter(
            "mtpu_router_decisions_total",
            "cost-model routing decisions, by chosen route",
        ),
        "promotions": reg.counter(
            "mtpu_router_promotions_total",
            "in-flight promotions after a routed tier overran its budget",
        ),
        "regret": reg.counter(
            "mtpu_router_regret_seconds_total",
            "predicted-cost gap between chosen route and model oracle "
            "(0 while the router itself chooses)",
        ),
        "version": reg.gauge(
            "mtpu_router_artifact_version",
            "version of the loaded router artifact (0 = heuristics)",
        ),
    }


class RouteDecision:
    """One routing verdict: the chosen tier plus the per-tier
    ``(wall_s, p_success)`` table that justified it."""

    __slots__ = ("route", "expected", "version")

    def __init__(
        self,
        route: str,
        expected: Dict[str, Tuple[float, float]],
        version: int,
    ) -> None:
        self.route = route
        self.expected = expected
        self.version = version

    def cost(self, route: str) -> Optional[float]:
        pair = self.expected.get(route)
        if pair is None:
            return None
        wall, p = pair
        return wall / max(p, P_SUCCESS_FLOOR)

    def budget_s(self, slack: float = 3.0, floor: float = 0.25) -> float:
        """The promotion trigger for the chosen route: `slack` times
        the predicted wall (a routed tier that overruns its own
        prediction by that much was mis-routed)."""
        pair = self.expected.get(self.route)
        wall = pair[0] if pair else 0.0
        return max(floor, slack * wall)


class Router:
    """A loaded artifact, ready to decide."""

    def __init__(self, doc: Dict) -> None:
        self.version = int(doc.get("version", 0))
        self.model = doc["model"]
        self._c = _counters()
        self._c["version"].set(self.version)

    def routes(self) -> List[str]:
        return sorted(self.model.get("routes") or {})

    def predict(self, features: Dict) -> Dict[str, Tuple[float, float]]:
        return _model.predict(self.model, features)

    def decide(
        self, features: Dict, tiers: Optional[List[str]] = None
    ) -> Optional[RouteDecision]:
        """Minimum-expected-cost tier among `tiers` (default: every
        tier the model has a head for). None when no offered tier has
        a head — the call site keeps its heuristic."""
        expected = self.predict(features)
        offered = {
            r: wp
            for r, wp in expected.items()
            if tiers is None or r in tiers
        }
        if not offered:
            return None
        route = min(
            offered,
            key=lambda r: (
                offered[r][0] / max(offered[r][1], P_SUCCESS_FLOOR),
                r,
            ),
        )
        self._c["decisions"].labels(route=route).inc()
        return RouteDecision(route, expected, self.version)

    def note_promotion(self, from_route: str, to_route: str) -> None:
        self._c["promotions"].inc()
        log.info("router promoted %s -> %s (budget overrun)",
                 from_route, to_route)

    def note_regret(self, seconds: float) -> None:
        if seconds > 0:
            self._c["regret"].inc(seconds)


def record_failure(site: str, why: Exception, contract: str = "") -> None:
    """A router that raised while it loaded or decided a route: recorded
    in the DegradationLog (`router-failed`), where the JAX package only
    logs it; the caller keeps the built-in ladder, as in the JAX
    package."""
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    log.warning("router failed at %s: %s", site, why)
    DegradationLog().record(
        DegradationReason.ROUTER_FAILED,
        site=site,
        detail=f"{type(why).__name__}: {why}",
        contract=contract,
    )


def load_router(directory: Optional[str]) -> Optional[Router]:
    """The newest verifying artifact in `directory` as a Router, or
    None (refusals counted by the artifact layer)."""
    doc = _artifact.latest_router(directory)
    if doc is None:
        if directory:
            _counters()["version"].set(0)
        return None
    return Router(doc)


# ---------------------------------------------------------------------------
# the process-wide configured router (corpus + serve + fleet mounts)
# ---------------------------------------------------------------------------
_MU = threading.Lock()
_CONFIGURED: Optional[Router] = None
_CONFIGURED_DIR: Optional[str] = None
_RESOLVED = False


def configure_router(directory: Optional[str]) -> Optional[Router]:
    """Point the process at an artifact directory (None clears back to
    heuristics). Returns the loaded Router, if any."""
    global _CONFIGURED, _CONFIGURED_DIR, _RESOLVED
    with _MU:
        _CONFIGURED_DIR = directory
        _CONFIGURED = load_router(directory) if directory else None
        _RESOLVED = True
        return _CONFIGURED


def configured_router() -> Optional[Router]:
    """The process router: whatever configure_router installed, else a
    one-shot resolve of $MYTHRIL_ROUTER_DIR, else None (heuristics)."""
    global _CONFIGURED, _RESOLVED
    with _MU:
        if not _RESOLVED:
            env_dir = os.environ.get(ENV_DIR)
            if env_dir:
                _CONFIGURED = load_router(env_dir)
            _RESOLVED = True
        return _CONFIGURED
