"""The port's telemetry (mythril_tpu_torch/observe) against the JAX
package's, on the CPU.

- The JAX suite's own cases, their source with the package renamed, run
  against the port's modules: every case of tests/observe/test_slo.py
  (the SLO engine and the health machine), the registry and span cases
  of tests/observe/test_observe.py (OBSERVE_CASES), and the device
  monitor's cases of tests/observe/test_devicemon.py that hold on the
  CPU (DEVICEMON_CASES; the port's monitor reads no device memory off a
  CPU device, below).
- `prometheus_text()` of the port's registry equals the JAX registry's
  after the same counter, gauge and histogram operations.
- The solver's loss waterfall and its captured queries count in the
  registry, and the service's /stats solver block reads them as the
  JAX engine's does.
- The device monitor reports no device memory and no device count for
  a CPU device, and the degradation log and the tier breakers publish
  into the registry.
"""

import importlib
import types
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def port_copy(relpath: str) -> types.ModuleType:
    """The JAX test module at `relpath`, its source with the package
    renamed, as a module of its own."""
    path = ROOT / relpath
    src = path.read_text().replace("mythril_tpu.", "mythril_tpu_torch.")
    src = src.replace("from mythril_tpu import", "from mythril_tpu_torch import")
    mod = types.ModuleType(f"port_copy_{path.stem}")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


SLO = "tests/observe/test_slo.py"
OBSERVE = "tests/observe/test_observe.py"
DEVICEMON = "tests/observe/test_devicemon.py"
#: test_observe.py's cases of the registry and the spans (its others drive
#: the explorer's registry publication, the routing log and the mesh,
#: which the port does not have)
OBSERVE_CASES = (
    "test_counter_gauge_histogram_semantics",
    "test_snapshot_and_since_deltas",
    "test_snapshot_is_single_lock_consistent_under_writers",
    "test_prometheus_exposition_golden",
    "test_collector_samples_merge_into_snapshot",
    "test_histogram_bucket_override_semantics",
    "test_job_latency_rebucket_exposition_golden",
    "test_span_nesting_and_ordering_under_threads",
    "test_trace_disabled_records_nothing",
    "test_flight_recorder_is_bounded",
    "test_perfetto_trace_event_schema",
)
#: test_devicemon.py's cases that hold on the CPU (its first reads the
#: CPU backend as a device, which the port's monitor does not)
DEVICEMON_CASES = (
    "test_arena_source_occupancy_gauges",
    "test_wave_fractions_recomputed_from_explore_counters",
    "test_process_monitor_is_shared",
    "test_kernel_cache_gauges_present",
)
CASES = (
    [(SLO, name) for name in sorted(vars(port_copy(SLO))) if name.startswith("test_")]
    + [(OBSERVE, name) for name in OBSERVE_CASES]
    + [(DEVICEMON, name) for name in DEVICEMON_CASES]
)


@pytest.mark.parametrize("relpath, name", CASES, ids=lambda v: v.rsplit("/", 1)[-1])
def test_jax_observe_case_on_the_port(relpath, name):
    mod = port_copy(relpath)
    imported = [v for v in vars(mod).values()
                if isinstance(v, type) and v.__module__.startswith("mythril_tpu")]
    assert imported and all(v.__module__.startswith("mythril_tpu_torch.") for v in imported)
    getattr(mod, name)()


def exercise(reg, buckets):
    """The same counter, gauge and histogram operations on `reg`."""
    c = reg.counter("mtpu_x_total", "a counter")
    c.inc()
    c.labels(route="/stats", engine="e1").inc(2.5)
    c.labels(route="/metrics", engine="e1").inc(0)
    g = reg.gauge("mtpu_x_depth", "a gauge")
    g.set(7)
    g.labels(device="0").set_max(3)
    g.labels(device="0").set_max(11)
    h = reg.histogram("mtpu_x_seconds", "a histogram", buckets=buckets)
    for v in (0.0004, 0.002, 0.3, 21.0, 500.0):
        h.observe(v)
    h.labels(state="done").observe(0.01)
    reg.collector(lambda: [("mtpu_x_ext", {"q": "main"}, 4)])


def test_prometheus_text_equals_the_jax_registry():
    # the packages re-export the function `registry` over the module name
    jax_registry = importlib.import_module("mythril_tpu.observe.registry")
    port_registry = importlib.import_module("mythril_tpu_torch.observe.registry")

    jax_reg, port_reg = jax_registry.MetricsRegistry(), port_registry.MetricsRegistry()
    exercise(jax_reg, jax_registry.LATENCY_BUCKETS)
    exercise(port_reg, port_registry.LATENCY_BUCKETS)
    assert port_reg.prometheus_text() == jax_reg.prometheus_text()
    assert port_reg.snapshot() == jax_reg.snapshot()
    assert port_registry.LATENCY_BUCKETS == jax_registry.LATENCY_BUCKETS
    assert port_registry.SCHEMA_VERSION == jax_registry.SCHEMA_VERSION


def test_loss_waterfall_and_captures_count_in_the_registry(tmp_path):
    """record_loss and a captured query land in mtpu_solver_loss_total and
    mtpu_solver_captured_queries_total; the engine's /stats solver block
    reads them as the JAX engine's _solver_stats does."""
    from mythril_tpu.service.engine import AnalysisEngine as JaxEngine
    from mythril_tpu_torch.laser.smt import symbol_factory
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower
    from mythril_tpu_torch.observe import querylog
    from mythril_tpu_torch.observe.registry import registry
    from mythril_tpu_torch.service.engine import AnalysisEngine

    marker = querylog.loss_marker()
    querylog.record_loss(querylog.LOSS_SLS_NONCONVERGED, "sat")
    querylog.record_loss(querylog.LOSS_SLS_NONCONVERGED, "unsat")
    querylog.record_loss(None, "sat")
    assert querylog.loss_reasons(since=marker) == {
        querylog.LOSS_SLS_NONCONVERGED: 2, querylog.LOSS_UNCLASSIFIED: 1}
    assert querylog.loss_reasons(since=marker, verdict="sat") == {
        querylog.LOSS_SLS_NONCONVERGED: 1, querylog.LOSS_UNCLASSIFIED: 1}
    x, y = symbol_factory.BitVecSym("x", 8), symbol_factory.BitVecSym("y", 8)
    querylog.configure_capture(str(tmp_path))
    try:
        path = querylog.capture_query(lower([(x * y == 6).raw])[0], "host-cdcl", "sat")
    finally:
        querylog.configure_capture(None)
    assert path is not None
    assert querylog.captured_total(since=marker) == 1
    snap = registry().since(marker)
    assert AnalysisEngine._solver_stats(snap) == dict(
        JaxEngine._solver_stats(snap), capture_dir=None)
    stats = AnalysisEngine._solver_stats(snap)
    assert stats["loss"] == {"SLS_NONCONVERGED": 2, "UNCLASSIFIED": 1}
    assert stats["loss_sat"] == {"SLS_NONCONVERGED": 1, "UNCLASSIFIED": 1}
    assert stats["captured_queries"] == 1


def test_device_monitor_reads_no_device_memory_off_the_card():
    """A CPU device (or none) is not a card: no device count, no device
    memory; the host's RSS is always there."""
    from mythril_tpu_torch.observe.devicemon import DeviceMonitor
    from mythril_tpu_torch.observe.registry import MetricsRegistry

    reg = MetricsRegistry()
    monitor = DeviceMonitor(reg=reg)
    for device in (None, torch.device("cpu")):
        monitor.set_device(device)
        sample = monitor.sample()
        assert "devices" not in sample and "memory" not in sample
        assert sample["host_rss_bytes"] > 0
    assert "mtpu_device_count" not in reg.snapshot()
    assert "mtpu_device_mem_bytes_in_use" not in reg.snapshot()


def test_degradations_and_breakers_publish_into_the_registry():
    from mythril_tpu_torch.observe.registry import registry
    from mythril_tpu_torch.observe.slo import REDLINE_BREAKER_OPEN
    from mythril_tpu_torch.support import breaker, resilience

    marker = registry().marker()
    resilience.DegradationLog().record(resilience.DegradationReason.WAVE_ABANDONED,
                                       site="test")
    delta = registry().since(marker)
    assert delta["mtpu_degradations_total"][(("reason", "wave-abandoned"),)] == 1
    br = breaker.breaker("test-tier")
    try:
        br.force_open()
        assert f"{breaker.REASON_PREFIX}:test-tier" in breaker.open_reasons()
        assert breaker.REASON_PREFIX == REDLINE_BREAKER_OPEN
        assert breaker.board_stats()["test-tier"]["state"] == breaker.STATE_OPEN
        assert registry().value("mtpu_breaker_state", tier="test-tier") == 2
    finally:
        br.reset()
    assert "breaker-open:test-tier" not in breaker.open_reasons()
