"""The process-wide metrics registry: typed counters, gauges and
histograms with label sets.

Every layer of the stack used to keep its own ad-hoc counters —
`ExploreStats` ints, hand-assembled `/stats` dicts in the service
engine, the `phase_profile` wall-clock singleton — none sharing a
schema or a consistency boundary. This registry is the single backing
store they register into:

- **Counters** — monotone floats; `inc(n)`. The explorer publishes its
  per-run `ExploreStats` here (``mtpu_explore_*``), the solver stack
  its per-origin query attribution (``mtpu_solver_*``), the service
  its wave/pipeline/kernel series (``mtpu_service_*``).
- **Gauges** — last-writer-wins floats (`set`) plus `set_max` for
  high-water marks.
- **Histograms** — fixed log-spaced buckets, per-label `sum`/`count`;
  `support/phase_profile.py` is a delta view over these.
- **Snapshot** — `snapshot()` returns every series under ONE lock
  acquisition, so a reader (the service `/stats` assembly) sees a
  point-in-time-consistent view instead of field-by-field reads racing
  the wave loop. `marker()`/`since(marker)` give per-run deltas on the
  same snapshot machinery.
- **Exposition** — `prometheus_text()` renders the whole registry in
  the Prometheus text format (0.0.4): the service serves it at
  ``/metrics``.

Metric mutation is a dict update under one process lock: cheap enough
for every call site in this codebase (the hot device loop never
touches the registry — instrumentation lives at wave/query/contract
granularity). The spans/solver/routing layers additionally honor the
global enable switch (`mythril_tpu_torch.observe.set_enabled`); registry
arithmetic itself stays on so legacy views (ExploreStats, /stats,
phase profile) never change behavior with telemetry off.

The port's copy of the JAX package's observe/registry.py. In the port
the analysis service (``mtpu_service_*``, ``mtpu_health_*``,
``mtpu_device_*``), the solver's loss waterfall and captured queries,
the degradation counts and the tier breakers register here.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

#: bumped when the snapshot/exposition schema changes shape; surfaced
#: in /stats, /trace, and the routing JSONL so smoke tools can pin it
SCHEMA_VERSION = 1

#: default histogram buckets (seconds-ish log spacing; callers with a
#: different unit pass their own)
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0,
)

#: job-latency ladder: the settle spectrum spans ~1.9ms verdict-store
#: hits to ~21s cold host walks (BENCH_r06), so the warm tiers need
#: sub-5ms resolution the default ladder crushes into one bucket
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

#: solver-wall ladder: memo hits are microseconds, CDCL marathons tens
#: of seconds — two extra decades below the default ladder's floor
SOLVER_WALL_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
    1.0, 5.0, 10.0, 30.0,
)

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: Tuple[Tuple[str, str], ...], extra=()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs
    )
    return "{" + body + "}"


class _Child:
    """One (metric, label set) series. Handles are cached on the
    parent, so hot call sites resolve labels once and keep the
    handle."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Metric", key) -> None:
        self._metric = metric
        self._key = key

    # counters / gauges
    def inc(self, n: float = 1.0) -> None:
        self._metric._inc(self._key, n)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def set_max(self, value: float) -> None:
        self._metric._set_max(self._key, value)

    @property
    def value(self) -> float:
        return self._metric._value(self._key)

    # histograms
    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)

    def add_raw(self, sum_delta: float, count_delta: int) -> None:
        """Fold pre-aggregated wall into the histogram (sum/count move,
        bucket counts take one observation of the mean) — the
        phase-profile `add(phase, seconds, n)` path."""
        self._metric._add_raw(self._key, sum_delta, count_delta)

    @property
    def sum(self) -> float:
        return self._metric._hist_sum(self._key)

    @property
    def count(self) -> int:
        return self._metric._hist_count(self._key)


class Metric:
    """One named family; all state guarded by the registry lock."""

    def __init__(
        self,
        name: str,
        kind: str,
        help_text: str,
        lock: threading.RLock,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self._lock = lock
        self.buckets = tuple(buckets)
        #: label key -> float (counter/gauge) or [bucket_counts, sum,
        #: count] (histogram)
        self._series: Dict = {}
        self._children: Dict = {}

    def labels(self, **labels) -> _Child:
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _Child(self, key)
        return child

    # default (label-less) conveniences
    def inc(self, n: float = 1.0) -> None:
        self._inc((), n)

    def set(self, value: float) -> None:
        self._set((), value)

    def set_max(self, value: float) -> None:
        self._set_max((), value)

    def observe(self, value: float) -> None:
        self._observe((), value)

    @property
    def value(self) -> float:
        return self._value(())

    # -- guarded primitives -------------------------------------------
    def _inc(self, key, n: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def _set(self, key, value: float) -> None:
        with self._lock:
            self._series[key] = float(value)

    def _set_max(self, key, value: float) -> None:
        with self._lock:
            self._series[key] = max(self._series.get(key, 0.0), float(value))

    def _value(self, key) -> float:
        with self._lock:
            if self.kind == HISTOGRAM:
                row = self._series.get(key)
                return row[1] if row else 0.0
            return self._series.get(key, 0.0)

    def _hist_row(self, key):
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        return row

    def _observe(self, key, value: float) -> None:
        with self._lock:
            row = self._hist_row(key)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    row[0][i] += 1
                    break
            else:
                row[0][-1] += 1
            row[1] += value
            row[2] += 1

    def _add_raw(self, key, sum_delta: float, count_delta: int) -> None:
        with self._lock:
            row = self._hist_row(key)
            mean = sum_delta / count_delta if count_delta else 0.0
            for i, bound in enumerate(self.buckets):
                if mean <= bound:
                    row[0][i] += count_delta
                    break
            else:
                row[0][-1] += count_delta
            row[1] += sum_delta
            row[2] += count_delta

    def _hist_sum(self, key) -> float:
        with self._lock:
            row = self._series.get(key)
            return row[1] if row else 0.0

    def _hist_count(self, key) -> int:
        with self._lock:
            row = self._series.get(key)
            return row[2] if row else 0


class MetricsRegistry:
    """Name -> Metric, with one lock for every mutation and snapshot.

    `collector(fn)` registers a scrape-time callback yielding
    ``(name, labels_dict, value)`` gauge samples — the bridge for
    state that lives behind another object's lock (queue depth, cache
    size) without double bookkeeping."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: "Dict[str, Metric]" = {}
        self._collectors: List[Callable] = []

    # -- registration --------------------------------------------------
    def _metric(self, name, kind, help_text, buckets=DEFAULT_BUCKETS):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = Metric(
                    name, kind, help_text, self._lock, buckets
                )
            elif metric.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {metric.kind}"
                )
            elif (
                kind == HISTOGRAM
                and tuple(buckets) != metric.buckets
                and tuple(buckets) != DEFAULT_BUCKETS
            ):
                # per-metric bucket override on re-registration: adopt
                # the explicit ladder while the series is still empty
                # (bucket counts would be meaningless across a switch);
                # once observations exist the first ladder wins
                if not metric._series:
                    metric.buckets = tuple(buckets)
            return metric

    def counter(self, name: str, help_text: str = "") -> Metric:
        return self._metric(name, COUNTER, help_text)

    def gauge(self, name: str, help_text: str = "") -> Metric:
        return self._metric(name, GAUGE, help_text)

    def histogram(
        self, name: str, help_text: str = "",
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Metric:
        return self._metric(name, HISTOGRAM, help_text, buckets)

    def collector(self, fn: Callable) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- reading -------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Every series, read under ONE lock acquisition: a consistent
        point-in-time view for /stats assembly and delta markers.
        Histograms snapshot as {"sum": s, "count": n, "buckets":
        [...]}; counters/gauges as floats. Collector samples are
        merged in afterwards (they guard their own state)."""
        with self._lock:
            out: Dict[str, Dict] = {}
            for name, metric in self._metrics.items():
                series = {}
                for key, value in metric._series.items():
                    if metric.kind == HISTOGRAM:
                        series[key] = {
                            "sum": value[1],
                            "count": value[2],
                            "buckets": list(value[0]),
                        }
                    else:
                        series[key] = value
                out[name] = series
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                for name, labels, value in fn():
                    out.setdefault(name, {})[_label_key(labels)] = value
            except Exception:  # a broken collector must not sink /stats
                pass
        return out

    def buckets_of(self, name: str) -> Tuple[float, ...]:
        """A histogram's bucket bounds (DEFAULT_BUCKETS for unknown
        names) — snapshot consumers (the SLO engine) pair these with
        the snapshot's bucket counts."""
        with self._lock:
            metric = self._metrics.get(name)
            return metric.buckets if metric is not None else DEFAULT_BUCKETS

    def value(self, name: str, **labels) -> float:
        metric = self._metrics.get(name)
        if metric is None:
            return 0.0
        return metric._value(_label_key(labels))

    def marker(self) -> Dict:
        """Snapshot for delta accounting (per-run attribution over
        process-cumulative series)."""
        return self.snapshot()

    def since(self, marker: Dict) -> Dict[str, Dict]:
        """Counter/histogram deltas since `marker` (gauges report the
        current value — a high-water mark has no meaningful delta)."""
        now = self.snapshot()
        out: Dict[str, Dict] = {}
        for name, series in now.items():
            metric = self._metrics.get(name)
            base = marker.get(name, {})
            for key, value in series.items():
                if isinstance(value, dict):  # histogram
                    prev = base.get(key, {"sum": 0.0, "count": 0})
                    delta = {
                        "sum": value["sum"] - prev.get("sum", 0.0),
                        "count": value["count"] - prev.get("count", 0),
                    }
                    if delta["count"] or delta["sum"]:
                        out.setdefault(name, {})[key] = delta
                elif metric is not None and metric.kind == GAUGE:
                    out.setdefault(name, {})[key] = value
                else:
                    delta = value - base.get(key, 0.0)
                    if delta:
                        out.setdefault(name, {})[key] = delta
        return out

    # -- exposition ----------------------------------------------------
    def prometheus_text(self) -> str:
        """The whole registry in the Prometheus text exposition format
        (0.0.4): HELP/TYPE headers, label-sorted series, histogram
        cumulative buckets + _sum/_count."""
        snap = self.snapshot()
        with self._lock:
            kinds = {n: m.kind for n, m in self._metrics.items()}
            helps = {n: m.help for n, m in self._metrics.items()}
            bucket_bounds = {
                n: m.buckets
                for n, m in self._metrics.items()
                if m.kind == HISTOGRAM
            }
        lines: List[str] = []
        for name in sorted(snap):
            kind = kinds.get(name, GAUGE)
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kind}")
            series = snap[name]
            for key in sorted(series):
                value = series[key]
                if isinstance(value, dict):  # histogram
                    bounds = bucket_bounds.get(name, DEFAULT_BUCKETS)
                    cum = 0
                    for bound, n in zip(bounds, value["buckets"]):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(key, (('le', _fmt(bound)),))}"
                            f" {cum}"
                        )
                    cum += value["buckets"][-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(key, (('le', '+Inf'),))} {cum}"
                    )
                    lines.append(
                        f"{name}_sum{_render_labels(key)} {_fmt(value['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_render_labels(key)} {value['count']}"
                    )
                else:
                    lines.append(
                        f"{name}{_render_labels(key)} {_fmt(value)}"
                    )
        return "\n".join(lines) + "\n"


def _fmt(value: float) -> str:
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide registry (lazily created; tests may swap it
    with `reset_registry` for isolation)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Replace the process registry with a fresh one (test isolation).
    Handles held by long-lived objects keep writing to the OLD
    registry; production code never calls this."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY
