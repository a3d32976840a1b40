"""Telemetry of the port.

The port's copy of the JAX package's observe/ API:

- **Metrics registry** (registry.py): typed counters, gauges and
  histograms with labels under one lock; the analysis service's series
  (``mtpu_service_*``), the solver's loss waterfall and captured
  queries (querylog.py), the degradation counts, the breaker board and
  the health and device gauges live here. Exposed as Prometheus text at
  the service's ``/metrics``.
- **Structured spans** (spans.py): ``trace(name, **attrs)`` nested spans
  in a bounded flight recorder, exported as Chrome/Perfetto trace JSON
  (``/trace?format=perfetto``, the drain's final flush).
- **Solver query telemetry** (solverstats.py): every verdict tagged with
  the engine that answered it, in the registry's ``mtpu_solver_*``
  series.
- **Routing feature log** (routing.py): one record per analyzed
  contract, its static features joined with the route it took and its
  outcome: the learned router's (routing/) training set, written to
  ``<out_dir>/routing_features.jsonl``.
- **Journeys** (journey.py), **health** (slo.py) and **device
  saturation** (devicemon.py): the service's per-job timelines, its
  readiness machine and its `mtpu_device_*` gauges.

`set_enabled(False)` (the JAX package's `--no-observe`) turns span,
solver, routing-record and journey recording into near-zero-cost no-ops; registry
arithmetic that backs `/stats` stays on. `configure(out_dir=...)` points
file outputs (degradation flight dumps) at a directory.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from mythril_tpu_torch.observe.querylog import (  # noqa: F401
    LOSS_REASONS,
    capture_enabled as query_capture_enabled,
    captured_total,
    configure_capture,
    loss_reasons,
    query_context,
    record_loss,
)
from mythril_tpu_torch.observe.devicemon import (  # noqa: F401
    DeviceMonitor,
    device_monitor,
)
from mythril_tpu_torch.observe.journey import (  # noqa: F401
    JourneyLog,
    assemble as assemble_journey,
    journey_event,
    journey_log,
    new_journey_id,
    tier_sequence,
)
from mythril_tpu_torch.observe.registry import (  # noqa: F401 (public API)
    LATENCY_BUCKETS,
    SCHEMA_VERSION,
    SOLVER_WALL_BUCKETS,
    MetricsRegistry,
    registry,
    reset_registry,
)
from mythril_tpu_torch.observe.slo import (  # noqa: F401
    HealthMonitor,
    Objective,
    SloEngine,
    default_objectives,
)
from mythril_tpu_torch.observe.routing import (  # noqa: F401
    features_for as routing_features_for,
)
from mythril_tpu_torch.observe.routing import outcome_for as routing_outcome_for  # noqa: F401,E501
from mythril_tpu_torch.observe.routing import (  # noqa: F401
    parse_record as parse_routing_record,
)
from mythril_tpu_torch.observe.routing import (  # noqa: F401
    read_records as read_routing_records,
)
from mythril_tpu_torch.observe.routing import (  # noqa: F401
    tail_records as tail_routing_records,
)
from mythril_tpu_torch.observe.routing import routing_log  # noqa: F401
from mythril_tpu_torch.observe.solverstats import (  # noqa: F401
    ORIGIN_DEVICE,
    ORIGIN_HOST_CDCL,
    ORIGIN_MEMO,
    attribution as solver_attribution,
    marker as solver_marker,
    record_query,
)
from mythril_tpu_torch.observe.spans import (  # noqa: F401
    FlightRecorder,
    export_trace,
    flight_recorder,
    overlap_fraction,
    to_perfetto,
    trace,
)

log = logging.getLogger(__name__)

_ENABLED = True
_OUT_DIR: Optional[str] = None
_DUMP_MU = threading.Lock()
_DUMPS = 0
#: bound on automatic degradation dumps per process: a degrading run
#: can log hundreds of events, and each dump serializes the whole ring
MAX_AUTO_DUMPS = 8


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """The --no-observe switch: gates span recording, solver query
    telemetry, routing records, journeys and automatic flight dumps."""
    global _ENABLED
    _ENABLED = bool(on)


def out_dir() -> Optional[str]:
    return _OUT_DIR


def configure(out_dir: Optional[str] = None) -> None:
    """Point file outputs at `out_dir` (created if missing); None
    clears. Also arms the degradation auto-dump hook."""
    global _OUT_DIR
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _OUT_DIR = out_dir or None
    _install_degradation_hook()


#: degradation reasons that dump the flight recorder: the failure
#: classes where "what was in flight" is the question
_DUMP_REASONS = ("deadline-expired", "wave-abandoned")

_HOOKED = False


def _degradation_dump(reason: str, site: str) -> None:
    """resilience.DegradationLog hook: flush the flight recorder to the
    observe directory so the timeline that led to the degradation
    survives the run."""
    global _DUMPS
    if not _ENABLED or _OUT_DIR is None or reason not in _DUMP_REASONS:
        return
    with _DUMP_MU:
        if _DUMPS >= MAX_AUTO_DUMPS:
            return
        _DUMPS += 1
        n = _DUMPS
    try:
        path = os.path.join(_OUT_DIR, f"flight-{reason}-{n}.trace.json")
        export_trace(path)
        log.info("flight recorder dumped to %s (%s at %s)", path, reason, site)
    except Exception:
        log.debug("flight-recorder dump failed", exc_info=True)


def _install_degradation_hook() -> None:
    global _HOOKED
    if _HOOKED:
        return
    from mythril_tpu_torch.support import resilience

    resilience.add_degradation_hook(_degradation_dump)
    _HOOKED = True
