"""Device saturation telemetry: the periodic sampler behind the
``mtpu_device_*`` gauges.

The wave counters say what the engine *did*; nothing said how full
the hardware *is* — which is exactly what a federation front needs to
red-line a replica before it falls over. One `DeviceMonitor.sample()`
publishes:

- **Device memory** — the card's bytes in use by PyTorch's caching
  allocator (``torch.cuda.memory_stats``: allocated and reserved) and
  its total (``torch.cuda.mem_get_info``), for the device an embedder
  registers (`set_device`: the analysis service's engine device). A
  CPU device, or none, reports no device memory and no device count:
  the CPU is not a card. The process RSS from /proc is the
  device-independent floor every container can alarm on.
- **Arena occupancy** — lanes/stripes busy and jobs resident from the
  service lane allocator (an embedder registers the source).
- **Kernel cache** — pinned buckets and compiles in flight from the
  specialization cache (a compile storm is a saturation signal).
- **Wave overlap / idle fractions** — promoted from per-run
  `ExploreStats` derived fields to live gauges, recomputed from the
  registry's cumulative ``mtpu_explore_*`` counters.

Sources are registered as callables (the same collector idiom the
registry uses) so the monitor never imports the service layer; the
serve sampler thread calls `sample()` on a clock.

The port's copy of the JAX package's observe/devicemon.py; the device
memory probe reads PyTorch's allocator instead of jax's devices.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, Optional

from mythril_tpu_torch.observe.registry import MetricsRegistry, registry

log = logging.getLogger(__name__)


def _host_rss_bytes() -> Optional[int]:
    """Resident set size from /proc (Linux); None elsewhere — the
    sampler publishes what it can observe, never guesses."""
    try:
        with open("/proc/self/statm") as fp:
            fields = fp.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class DeviceMonitor:
    """The mtpu_device_* gauge publisher. `sample()` is cheap (no
    device work beyond memory_stats) and safe to call from any
    thread; `latest()` hands the last sample back as a plain dict for
    /stats and the bench record."""

    def __init__(self, reg: Optional[MetricsRegistry] = None) -> None:
        self._reg = reg
        self._mu = threading.Lock()
        self._arena_source: Optional[Callable[[], Dict]] = None
        self._device = None
        self._latest: Dict = {}
        self.samples = 0

    @property
    def reg(self) -> MetricsRegistry:
        return self._reg if self._reg is not None else registry()

    def set_arena_source(self, fn: Optional[Callable[[], Dict]]) -> None:
        """Register the lane-allocator occupancy source (the service
        engine's `alloc.occupancy`); None unregisters."""
        with self._mu:
            self._arena_source = fn

    def set_device(self, device) -> None:
        """Register the device whose memory the sample reads (the
        service engine's); None, or a CPU device, reads none."""
        with self._mu:
            self._device = device

    # -- the sample ----------------------------------------------------
    def _sample_device_memory(self, out: Dict) -> None:
        with self._mu:
            device = self._device
        if device is None or getattr(device, "type", None) != "cuda":
            return
        import torch

        index = device.index if device.index is not None else (
            torch.cuda.current_device()
        )
        out["devices"] = torch.cuda.device_count()
        self.reg.gauge(
            "mtpu_device_count", "visible accelerator devices"
        ).set(out["devices"])
        stats = torch.cuda.memory_stats(index)
        used = int(stats.get("allocated_bytes.all.current", 0))
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        _free, total = torch.cuda.mem_get_info(index)
        label = str(index)
        self.reg.gauge(
            "mtpu_device_mem_bytes_in_use",
            "per-device bytes in use (PyTorch's caching allocator)",
        ).labels(device=label).set(float(used))
        self.reg.gauge(
            "mtpu_device_mem_bytes_limit",
            "per-device memory (the card's total)",
        ).labels(device=label).set(float(total))
        out["memory"] = {
            label: {
                "bytes_in_use": used,
                "bytes_reserved": reserved,
                "bytes_limit": int(total),
            }
        }

    def _sample_host(self, out: Dict) -> None:
        rss = _host_rss_bytes()
        if rss is not None:
            out["host_rss_bytes"] = rss
            self.reg.gauge(
                "mtpu_device_host_rss_bytes",
                "analyzer process resident set size",
            ).set(float(rss))

    def _sample_arena(self, out: Dict) -> None:
        with self._mu:
            source = self._arena_source
        if source is None:
            return
        try:
            occ = source()
        except Exception:
            log.debug("arena occupancy source failed", exc_info=True)
            return
        lanes = max(1, int(occ.get("lanes", 1)))
        busy = int(occ.get("lanes_busy", 0))
        out["arena"] = {
            "lanes": lanes,
            "lanes_busy": busy,
            "occupancy": round(busy / lanes, 4),
            "jobs_resident": int(occ.get("jobs_resident", 0)),
        }
        self.reg.gauge(
            "mtpu_device_arena_lanes", "arena lane capacity"
        ).set(lanes)
        self.reg.gauge(
            "mtpu_device_arena_lanes_busy", "arena lanes owned by jobs"
        ).set(busy)
        self.reg.gauge(
            "mtpu_device_arena_occupancy",
            "arena lane occupancy fraction (busy/capacity)",
        ).set(busy / lanes)
        self.reg.gauge(
            "mtpu_device_arena_jobs_resident",
            "jobs currently resident in the arena",
        ).set(int(occ.get("jobs_resident", 0)))

    def _sample_kernel_cache(self, out: Dict) -> None:
        try:
            from mythril_tpu_torch.laser.batch.specialize import (
                kernel_cache_stats,
            )

            stats = kernel_cache_stats()
        except Exception:
            return
        out["kernel_cache"] = {
            "size": stats.get("size", 0),
            "pinned": stats.get("pinned", 0),
            "compiles_in_flight": stats.get("compiles_in_flight", 0),
        }
        self.reg.gauge(
            "mtpu_device_kernel_cache_size",
            "specialized-kernel buckets resident in the compile cache",
        ).set(stats.get("size", 0))
        self.reg.gauge(
            "mtpu_device_kernel_cache_pinned",
            "kernel buckets pinned by resident contracts",
        ).set(stats.get("pinned", 0))
        self.reg.gauge(
            "mtpu_device_kernel_compiles_in_flight",
            "specialized-kernel compiles currently running",
        ).set(stats.get("compiles_in_flight", 0))

    def _sample_wave_fractions(self, out: Dict) -> None:
        """wave overlap / device idle, live from the cumulative
        explore counters (the per-run ExploreStats derived ratios,
        promoted to process gauges)."""
        snap = self.reg.snapshot()

        def total(name: str) -> float:
            return float(sum((snap.get(name) or {}).values()))

        busy = total("mtpu_explore_device_busy_s_total")
        overlap = total("mtpu_explore_wave_overlap_s_total")
        wall = total("mtpu_explore_wall_s_total")
        if busy > 0:
            frac = min(1.0, overlap / busy)
            out["wave_overlap_frac"] = round(frac, 4)
            self.reg.gauge(
                "mtpu_device_wave_overlap_frac",
                "fraction of device execution covered by concurrent "
                "host work (cumulative)",
            ).set(frac)
        if wall > 0:
            idle = max(0.0, min(1.0, 1.0 - busy / wall))
            out["idle_frac"] = round(idle, 4)
            self.reg.gauge(
                "mtpu_device_idle_frac",
                "fraction of exploration wall with no wave in flight "
                "(cumulative)",
            ).set(idle)

    def sample(self) -> Dict:
        out: Dict = {}
        for step in (
            self._sample_device_memory,
            self._sample_host,
            self._sample_arena,
            self._sample_kernel_cache,
            self._sample_wave_fractions,
        ):
            try:
                step(out)
            except Exception:  # one broken probe must not sink the rest
                log.debug("device sample step failed", exc_info=True)
        with self._mu:
            self._latest = out
            self.samples += 1
        return out

    def latest(self) -> Dict:
        with self._mu:
            return dict(self._latest)


_MONITOR = DeviceMonitor()


def device_monitor() -> DeviceMonitor:
    return _MONITOR
