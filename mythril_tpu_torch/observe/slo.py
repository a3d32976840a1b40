"""The tier-ladder SLO engine: declarative latency/availability
objectives evaluated over registry histograms, multi-window burn-rate
accounting, and the health state machine a fleet front routes on.

ROADMAP item 2 (federated serving) wants "draining/red-lining driven
by each replica's Prometheus /metrics" — which presumes a replica can
score its own health. PR 7 built the raw series; this module is the
control plane on top, the same pattern production inference stacks
use:

- An **Objective** declares an error budget over registry series:
  either a *latency* objective (fraction of histogram observations
  above a threshold must stay under the budget — "p95 settle < 5s" is
  budget 0.05 at threshold 5s) or a *ratio* objective (bad-event
  counter over total-event counter must stay under the budget).
- The **SloEngine** samples the registry on a clock, keeps a bounded
  ring of timestamped snapshots, and evaluates every objective over a
  SHORT and a LONG window. The **burn rate** is bad-fraction /
  budget: 1.0 means the budget is being spent exactly as fast as
  allowed; 10x means the budget dies in a tenth of the window.
  Multi-window gating (both windows burning) is the standard
  flap-damper: a one-sample spike trips the short window but not the
  long one.
- The **HealthMonitor** folds the objective states with lifecycle
  facts (arena warming, background kernel compiles, draining) into
  one machine — ``ok -> degraded -> redlined`` — exported as the
  ``mtpu_health_state`` gauge plus per-objective
  ``mtpu_health_burn_rate{objective=,window=}`` gauges, and into the
  reasoned readiness split `/healthz` serves: *liveness* ("the
  process answers") vs *readiness* ("route new work here").

Redline/not-ready reasons are an enumerated, stable vocabulary
(`REDLINE_REASONS`, `NOT_READY_REASONS`): the future federation front
switches on them, so they are wire schema, not log strings.

The port's copy of the JAX package's observe/slo.py. The port publishes
every default objective's series: the service's admissions, job
latencies and waves, the degradation counts, and the solver's query and
escalation counters (observe/solverstats.py), which
`solver-escalation-share` reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.observe.registry import MetricsRegistry, _label_key, registry

#: health states in severity order; the gauge value is the index
STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_REDLINED = "redlined"
HEALTH_STATES = (STATE_OK, STATE_DEGRADED, STATE_REDLINED)

#: the enumerated redline vocabulary (stable wire schema — the
#: federation front switches on these)
REDLINE_SLO_BURN = "slo-burn"
REDLINE_QUEUE_SATURATED = "queue-saturated"
REDLINE_DEVICE_SATURATED = "device-saturated"
#: prefix form `breaker-open:<tier>`: a tier circuit breaker
#: (support/breaker.py) is OPEN and the replica is serving through
#: its fallback ladder — the federation front should route around it
#: until the breaker's half-open probe recovers
REDLINE_BREAKER_OPEN = "breaker-open"
#: the analysis service's arena warmup failed (a kernel library did not
#: build or load, or its warmup wave faulted): the replica cannot serve
#: waves and stays redlined
REDLINE_WARMUP_FAILED = "arena-warmup-failed"
#: fleet-front vocabulary (fleet/front.py): prefix form
#: `replica-lost:<name>` — a replica's death breaker tripped open
#: (probe timeouts / connection-refused streak) and its in-flight
#: jobs were failed over to survivors; `fleet-degraded` — at least
#: one replica is unroutable but the fleet still has ready capacity;
#: `fleet-saturated` — NO replica is accepting work and the front is
#: shedding submissions with Retry-After
REDLINE_REPLICA_LOST = "replica-lost"
REDLINE_FLEET_DEGRADED = "fleet-degraded"
REDLINE_FLEET_SATURATED = "fleet-saturated"
#: chainstream vocabulary (chainstream/watcher.py): `rpc-endpoints-
#: down` — every configured execution-client endpoint's death breaker
#: is open and the head stream is stalled; `head-lag` — the cursor
#: has fallen more than the configured block budget behind the quorum
#: chain head; `backfill-saturated` — the gap between cursor and head
#: exceeds the backfill window (alerting latency can no longer meet
#: the block-time SLO until the backlog drains)
REDLINE_RPC_ENDPOINTS_DOWN = "rpc-endpoints-down"
REDLINE_HEAD_LAG = "head-lag"
REDLINE_BACKFILL_SATURATED = "backfill-saturated"
REDLINE_REASONS = (
    REDLINE_SLO_BURN,
    REDLINE_QUEUE_SATURATED,
    REDLINE_DEVICE_SATURATED,
    REDLINE_BREAKER_OPEN,
    REDLINE_WARMUP_FAILED,
    REDLINE_REPLICA_LOST,
    REDLINE_FLEET_DEGRADED,
    REDLINE_FLEET_SATURATED,
    REDLINE_RPC_ENDPOINTS_DOWN,
    REDLINE_HEAD_LAG,
    REDLINE_BACKFILL_SATURATED,
)

#: the enumerated not-ready vocabulary for the readiness half of
#: /healthz (liveness stays true through all of these)
NOT_READY_WARMING = "arena-warming"
NOT_READY_KERNEL_WARMUP = "kernel-warmup"
NOT_READY_DRAINING = "draining"
NOT_READY_REDLINED = "redlined"
NOT_READY_REASONS = (
    NOT_READY_WARMING,
    NOT_READY_KERNEL_WARMUP,
    NOT_READY_DRAINING,
    NOT_READY_REDLINED,
)


class Objective:
    """One declarative service-level objective over registry series.

    kind="latency": `metric` names a histogram; an observation above
    `threshold_s` is a bad event; the bad fraction must stay under
    `budget` (0.05 = "p95 under the threshold").

    kind="ratio": `numerator` (name, label-filter) counts bad events,
    `denominator` counts all events; bad/total must stay under
    `budget`. A label filter of {} sums every series of the family;
    given labels must match exactly (extra labels on the series are
    ignored).
    """

    def __init__(
        self,
        name: str,
        kind: str,
        budget: float,
        description: str = "",
        metric: Optional[str] = None,
        threshold_s: Optional[float] = None,
        numerator: Optional[Tuple[str, Dict[str, str]]] = None,
        denominator: Optional[Tuple[str, Dict[str, str]]] = None,
        min_events: int = 1,
    ) -> None:
        if kind not in ("latency", "ratio"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if kind == "latency" and (metric is None or threshold_s is None):
            raise ValueError("latency objective wants metric + threshold_s")
        if kind == "ratio" and (numerator is None or denominator is None):
            raise ValueError("ratio objective wants numerator + denominator")
        self.name = name
        self.kind = kind
        self.budget = float(budget)
        self.description = description
        self.metric = metric
        self.threshold_s = threshold_s
        self.numerator = numerator
        self.denominator = denominator
        #: windows with fewer total events than this report burn 0 —
        #: an idle replica is healthy, not divide-by-zero degraded
        self.min_events = min_events

    def as_dict(self) -> Dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "budget": self.budget,
            "description": self.description,
        }
        if self.kind == "latency":
            out["metric"] = self.metric
            out["threshold_s"] = self.threshold_s
        else:
            out["numerator"] = [self.numerator[0], dict(self.numerator[1])]
            out["denominator"] = [
                self.denominator[0], dict(self.denominator[1]),
            ]
        return out


def default_objectives() -> List[Objective]:
    """The service's shipped objective set (docs/observability.md has
    the schema table). Budgets are serving-shaped defaults; embedders
    pass their own list to HealthMonitor."""
    return [
        Objective(
            name="warm-settle-p95",
            kind="latency",
            metric="mtpu_service_job_latency_seconds",
            threshold_s=10.0,
            budget=0.05,
            description="95% of jobs settle within 10s",
            min_events=4,
        ),
        Objective(
            name="admission-availability",
            kind="ratio",
            numerator=("mtpu_service_admissions_total",
                       {"outcome": "rejected-full"}),
            denominator=("mtpu_service_admissions_total", {}),
            budget=0.05,
            description="under 5% of submissions refused on backpressure",
            min_events=4,
        ),
        Objective(
            name="wave-abandon",
            kind="ratio",
            numerator=("mtpu_degradations_total",
                       {"reason": "wave-abandoned"}),
            denominator=("mtpu_service_waves_total", {}),
            budget=0.02,
            description="under 2% of waves die past the resilience ladder",
            min_events=2,
        ),
        Objective(
            name="solver-escalation-share",
            kind="ratio",
            numerator=("mtpu_solver_escalations_total", {}),
            denominator=("mtpu_solver_queries_total", {}),
            budget=0.5,
            description=(
                "under half of solver queries climb past the first "
                "ladder rung"
            ),
            min_events=16,
        ),
    ]


def _sum_family(snap: Dict, name: str, labels: Dict[str, str]) -> float:
    """Sum every series of `name` whose label set CONTAINS `labels`."""
    want = set(_label_key(labels))
    total = 0.0
    for key, value in (snap.get(name) or {}).items():
        if isinstance(value, dict):
            value = value.get("count", 0)
        if want <= set(key):
            total += float(value)
    return total


def _hist_family(snap: Dict, name: str) -> Tuple[List[int], int]:
    """Element-wise summed bucket counts + total count over every
    series of histogram `name` in one snapshot."""
    buckets: List[int] = []
    count = 0
    for value in (snap.get(name) or {}).values():
        if not isinstance(value, dict):
            continue
        row = value.get("buckets") or []
        if len(row) > len(buckets):
            buckets.extend([0] * (len(row) - len(buckets)))
        for i, n in enumerate(row):
            buckets[i] += n
        count += int(value.get("count", 0))
    return buckets, count


def quantile_from_buckets(
    bounds: Sequence[float], counts: Sequence[int], q: float
) -> Optional[float]:
    """Prometheus-style linear interpolation of quantile `q` from
    cumulative-izable bucket counts (`counts` has len(bounds)+1, the
    last being the overflow). None when empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    lo = 0.0
    for bound, n in zip(bounds, counts):
        if cum + n >= rank and n > 0:
            return lo + (bound - lo) * (rank - cum) / n
        cum += n
        lo = bound
    return float(bounds[-1]) if bounds else None


class ObjectiveStatus:
    """One objective's evaluation: per-window burn rates + the state
    the multi-window gate assigns."""

    __slots__ = ("objective", "burn_short", "burn_long", "state",
                 "bad", "total", "p95")

    def __init__(self, objective, burn_short, burn_long, state,
                 bad, total, p95=None) -> None:
        self.objective = objective
        self.burn_short = burn_short
        self.burn_long = burn_long
        self.state = state
        self.bad = bad
        self.total = total
        self.p95 = p95

    def as_dict(self) -> Dict:
        out = {
            "objective": self.objective.name,
            "state": self.state,
            "burn_short": round(self.burn_short, 3),
            "burn_long": round(self.burn_long, 3),
            "bad": self.bad,
            "total": self.total,
            "budget": self.objective.budget,
        }
        if self.p95 is not None:
            out["p95_s"] = round(self.p95, 6)
        return out


class SloEngine:
    """Registry sampler + objective evaluator.

    `sample()` snapshots the registry, appends to the bounded
    snapshot ring, and evaluates every objective over the short and
    long windows (delta between the newest snapshot and the oldest
    one inside each window). Degraded needs BOTH windows burning
    (>= 1.0); redlined needs both windows past `redline_burn`.
    """

    def __init__(
        self,
        objectives: Optional[List[Objective]] = None,
        short_window_s: float = 60.0,
        long_window_s: float = 600.0,
        redline_burn: float = 10.0,
        reg: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.objectives = (
            list(objectives) if objectives is not None
            else default_objectives()
        )
        self.short_window_s = short_window_s
        self.long_window_s = long_window_s
        self.redline_burn = redline_burn
        self._reg = reg
        self._clock = clock
        self._mu = threading.Lock()
        # enough samples to cover the long window at a 1s cadence
        self._ring: "deque[Tuple[float, Dict]]" = deque(maxlen=1024)
        self._last: List[ObjectiveStatus] = []
        self._start_t = self._clock()

    @property
    def reg(self) -> MetricsRegistry:
        return self._reg if self._reg is not None else registry()

    def _window_delta(self, now_t, now_snap, window_s):
        """(old_snap, span_s): the baseline is the oldest sample
        inside `window_s`; with only out-of-window history, the
        newest predecessor (the closest boundary). The very FIRST
        sample has no window at all — old_snap is None and the
        evaluation reports zero burn rather than scoring the entire
        process history (which in an embedding process may predate
        this engine entirely) as one window."""
        oldest: Optional[Tuple[float, Dict]] = None
        for t, snap in self._ring:
            if now_t - t <= window_s:
                oldest = (t, snap)
                break
        if oldest is None:
            if not self._ring:
                return None, max(1e-9, now_t - self._start_t)
            oldest = self._ring[-1]
        return oldest[1], max(1e-9, now_t - oldest[0])

    def _evaluate_one(self, objective, now_snap, old_short, old_long):
        def bad_total(old_snap):
            if objective.kind == "ratio":
                num_name, num_labels = objective.numerator
                den_name, den_labels = objective.denominator
                bad = _sum_family(now_snap, num_name, num_labels) - \
                    _sum_family(old_snap, num_name, num_labels)
                total = _sum_family(now_snap, den_name, den_labels) - \
                    _sum_family(old_snap, den_name, den_labels)
                return max(0.0, bad), max(0.0, total), None
            bounds = self.reg.buckets_of(objective.metric)
            now_b, now_n = _hist_family(now_snap, objective.metric)
            old_b, old_n = _hist_family(old_snap, objective.metric)
            counts = [
                a - (old_b[i] if i < len(old_b) else 0)
                for i, a in enumerate(now_b)
            ]
            total = now_n - old_n
            bad = 0.0
            for i, bound in enumerate(bounds):
                if bound > objective.threshold_s and i < len(counts):
                    bad += counts[i]
            if len(counts) > len(bounds):
                bad += counts[-1]  # the overflow bucket
            p95 = quantile_from_buckets(bounds, counts, 0.95)
            return max(0.0, bad), max(0.0, float(total)), p95

        def burn(old_snap):
            if old_snap is None:  # the first sample: no window yet
                return 0.0, 0.0, 0.0, None
            bad, total, p95 = bad_total(old_snap)
            if total < objective.min_events:
                return 0.0, bad, total, p95
            fraction = bad / total if total else 0.0
            return fraction / objective.budget, bad, total, p95

        burn_short, bad, total, p95 = burn(old_short)
        burn_long, _bad_l, _total_l, _ = burn(old_long)
        if (
            burn_short >= self.redline_burn
            and burn_long >= self.redline_burn
        ):
            state = STATE_REDLINED
        elif burn_short >= 1.0 and burn_long >= 1.0:
            state = STATE_DEGRADED
        else:
            state = STATE_OK
        return ObjectiveStatus(
            objective, burn_short, burn_long, state, bad, total, p95
        )

    def sample(self) -> List[ObjectiveStatus]:
        now_t = self._clock()
        now_snap = self.reg.snapshot()
        with self._mu:
            old_short, _ = self._window_delta(
                now_t, now_snap, self.short_window_s
            )
            old_long, _ = self._window_delta(
                now_t, now_snap, self.long_window_s
            )
            statuses = [
                self._evaluate_one(o, now_snap, old_short, old_long)
                for o in self.objectives
            ]
            self._ring.append((now_t, now_snap))
            self._last = statuses
        burn_gauge = self.reg.gauge(
            "mtpu_health_burn_rate",
            "SLO error-budget burn rate by objective and window "
            "(1.0 = budget spent exactly at the allowed rate)",
        )
        for status in statuses:
            burn_gauge.labels(
                objective=status.objective.name, window="short"
            ).set(status.burn_short)
            burn_gauge.labels(
                objective=status.objective.name, window="long"
            ).set(status.burn_long)
        return statuses

    def statuses(self) -> List[ObjectiveStatus]:
        with self._mu:
            return list(self._last)


class HealthMonitor:
    """The replica's health state machine.

    Folds the SLO engine's objective states with lifecycle facts the
    embedder injects as callables:

    - `warming_fn`    True while the arena warmup compile is in flight
    - `compiling_fn`  True while background kernel warmups are running
    - `draining_fn`   True once the drain began
    - `saturation_fn` optional extra redline reasons (queue/device
                      saturation) -> list of REDLINE_REASONS entries

    `state()`: ok | degraded | redlined from the worst objective plus
    saturation reasons. `ready()`: route-new-work-here — False while
    warming, compiling, draining, or redlined, each with its
    enumerated reason. Exports `mtpu_health_state` / `mtpu_health_ready`
    gauges on every sample.
    """

    def __init__(
        self,
        slo: Optional[SloEngine] = None,
        warming_fn: Optional[Callable[[], bool]] = None,
        compiling_fn: Optional[Callable[[], bool]] = None,
        draining_fn: Optional[Callable[[], bool]] = None,
        saturation_fn: Optional[Callable[[], List[str]]] = None,
        reg: Optional[MetricsRegistry] = None,
    ) -> None:
        self.slo = slo if slo is not None else SloEngine(reg=reg)
        self._warming = warming_fn or (lambda: False)
        self._compiling = compiling_fn or (lambda: False)
        self._draining = draining_fn or (lambda: False)
        self._saturation = saturation_fn or (lambda: [])
        self._reg = reg

    @property
    def reg(self) -> MetricsRegistry:
        return self._reg if self._reg is not None else registry()

    # -- evaluation ----------------------------------------------------
    def sample(self) -> Dict:
        """One sampler tick: evaluate the objectives, fold the state,
        export the gauges, return the healthz payload."""
        self.slo.sample()
        payload = self.healthz_payload()
        self.reg.gauge(
            "mtpu_health_state",
            "replica health state (0=ok, 1=degraded, 2=redlined)",
        ).set(HEALTH_STATES.index(payload["state"]))
        self.reg.gauge(
            "mtpu_health_ready",
            "replica readiness (1 = route new work here)",
        ).set(1.0 if payload["ready"] else 0.0)
        return payload

    def state(self) -> Tuple[str, List[str]]:
        """(state, redline/degrade reasons) from the last evaluation
        plus live saturation facts."""
        reasons: List[str] = []
        worst = STATE_OK
        for status in self.slo.statuses():
            if status.state == STATE_REDLINED:
                worst = STATE_REDLINED
                reasons.append(
                    f"{REDLINE_SLO_BURN}:{status.objective.name}"
                )
            elif status.state == STATE_DEGRADED:
                if worst == STATE_OK:
                    worst = STATE_DEGRADED
                reasons.append(f"slo-degraded:{status.objective.name}")
        for reason in self._saturation():
            worst = STATE_REDLINED
            reasons.append(reason)
        return worst, reasons

    def ready(self) -> Tuple[bool, List[str]]:
        reasons: List[str] = []
        if self._draining():
            reasons.append(NOT_READY_DRAINING)
        if self._warming():
            reasons.append(NOT_READY_WARMING)
        if self._compiling():
            reasons.append(NOT_READY_KERNEL_WARMUP)
        state, _ = self.state()
        if state == STATE_REDLINED:
            reasons.append(NOT_READY_REDLINED)
        return not reasons, reasons

    def healthz_payload(self) -> Dict:
        """The upgraded /healthz body: liveness ("ok", always true
        when this code runs), the health state + reasons, and the
        readiness split with its enumerated reasons."""
        state, state_reasons = self.state()
        ready, ready_reasons = self.ready()
        return {
            "ok": True,  # liveness: the process answered
            "state": state,
            "reasons": state_reasons,
            "ready": ready,
            "not_ready_reasons": ready_reasons,
            "objectives": [
                s.as_dict() for s in self.slo.statuses()
            ],
        }

