"""The persistent analysis engine: warm device arena + continuous
lane-level batching + overlapped host analysis.

One-shot `analyze` pays process startup, the kernels' build and first
loads, and arena allocation on every invocation. This engine owns the
device for its lifetime and amortizes all three:

- **Warm arena** — ONE fixed batch shape (`stripes x lanes_per_stripe`
  lanes, one code-table row per stripe plus a halt row). Contracts
  longer than the current code capacity re-bucket it (power of two,
  seeds.code_cap_bucket), counted in /stats.
- **Continuous batching** — the wave loop admits queued jobs into free
  stripes *between waves* and finished jobs release their stripes the
  wave they complete, so concurrent requests coalesce into shared
  dispatches instead of queuing behind a whole corpus drain
  (service/lane_allocator.py holds the packing logic).
- **Code LRU** — disassembled dense code rows cached by code hash:
  resubmitted or popular contracts skip `to_dense`.
- **Host pool** — finished device phases hand off to a host worker
  (analysis/corpus.py:_analyze_one, outcome injected) so device waves
  and host `fire_lasers` overlap continuously. Host symbolic state is
  process-global, so in-process workers serialize on
  HOST_SYMBOLIC_LOCK.
- **Drain** — `drain()` (wired to SIGTERM by the server) finishes the
  in-flight wave, then checkpoints every unfinished job's seeded
  frontier to a replayable npz (laser/batch/checkpoint.py, shape
  metadata included): accepted work is completed or checkpointed,
  never dropped.

The port's copy of the JAX package's service/engine.py, the single
arena (`devices=1`), with its device half in PyTorch on the engine's
device (`ServiceConfig.device`: None is the card, which raises where
there is none; "cpu" runs the plain versions of the kernels):

- A wave's device work — its batch, its run (the specialized loop with
  its substep kernel launches, or the generic `wave_run`) and its
  readback through `support/hostsync.fetch` — runs on ONE wave thread
  and ONE CUDA stream of the engine's own (the serving stream), start
  to end (`_wave_job`). Pipelined, the loop thread dispatches wave N+1
  to that thread and harvests wave N meanwhile, as the JAX engine's
  asynchronous dispatch does; lock-step, it waits for each wave. The
  code tables are built on the loop thread (a blocking upload) and
  handed to the wave, which marks them in use on its stream.
- The wave updates its batch in place, so nothing of it is read after
  the run: a faulted wave is rebuilt from the host inputs that ride its
  record (`_rebuild_batch`) and retried through `run_resilient`, on
  the wave thread, on the engine's device (never the CPU).
- Arena warmup builds (nvcc) and loads every kernel library a wave
  launches and lands one all-halt wave of the dispatch shape;
  `/healthz?ready=1` reports `arena-warming` until then. A bucket's
  background warmup runs one all-halt launch of its loop. Both run on
  side streams of their own over tables of their own, never on the
  serving stream.

The verdict store (store/, `serve --store DIR`) is the JAX engine's
tier: a repeat submission (same codehash, same config fingerprint)
settles DONE at admission with the banked issue set (no queue slot, no
wave, no walk, not counted in backpressure), and every job that
completes its host walk cleanly writes its verdict back. A write-back
that fails is recorded in the DegradationLog (`store-writeback-failed`)
and a lookup that raises `store-unavailable`, where the JAX engine only
logs them; the job goes on as in the JAX engine. The journal's
re-admission through the store waits for service/journal.py.

The learned router (routing/, `serve --router DIR`) is the JAX
engine's tier: a submission the cost model prices cheaper on the host
walk goes straight to the walk pool at admission (no queue slot, no
wave; its walk runs with the card off, as every walk of the JAX engine
does, and is clamped to the decision's budget); a routed walk that
overran its budget or raised is promoted once to the head of the wave
queue (`_finalize`). A tuned-defaults artifact in the same directory is
installed at start. Every settled job writes one routing-feature record
(observe/routing.py). A router that raises while it loads or decides is
recorded in the DegradationLog (`router-failed`) and a routing record
that cannot be built `routing-record-failed`, where the JAX engine only
logs them; the job takes the built-in ladder, as in the JAX engine.

Left out with their modules (refused by `serve`): the device mesh
(`devices > 1`), the durable journal and its recovery, and the compile
plane's kernel packs and artifact cache. /stats keeps the JAX package's
key set: their blocks read as disabled.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import CancelledError, ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mythril_tpu_torch import observe
from mythril_tpu_torch.observe import journey
from mythril_tpu_torch.observe.registry import _label_key
from mythril_tpu_torch.observe.spans import flight_recorder, trace
from mythril_tpu_torch.service.jobs import Job, JobQueue, JobState
from mythril_tpu_torch.service.lane_allocator import LaneAllocator

log = logging.getLogger(__name__)

#: /stats payload schema version: smoke tools pin it and the key set
#: it covers (the JAX package's version and key set)
STATS_SCHEMA_VERSION = 4

#: engine-instance serial for the registry label (tests run many
#: engines per process; each gets its own series)
_ENGINE_SERIAL = __import__("itertools").count(1)

#: trigger statuses -> report kinds (mirrors explore.TRIGGER_KINDS; a
#: local copy so importing the engine never drags the explorer in)
_TRIGGER_KINDS = {
    4: "assert-violation",  # Status.INVALID
    5: "stack-error",  # Status.ERR_STACK
    6: "invalid-jump",  # Status.ERR_JUMP
    10: "selfdestruct",  # Status.KILLED
}
_DEGRADED_STATUSES = (7, 8)  # ERR_MEM, UNSUPPORTED

DEFAULT_CALLER = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
DEFAULT_ADDRESS = 0x901D573B8CE8C997DE5F19173C32D966B4FA55FE

#: the block context every service wave runs under
_BLOCK_ENV = dict(
    caller=DEFAULT_CALLER,
    address=DEFAULT_ADDRESS,
    timestamp=0x5BFA4639,
    number=0x66E393,
    gasprice=0x773594000,
)


def load_wave_kernels() -> None:
    """Build (nvcc, every stale csrc/*.cu) and load the kernel libraries
    a wave launches: keccak_sponge (SHA3), slot_write (stack, storage
    and branch writes) and the substep kernel (specialized loops). A
    failed build raises."""
    from mythril_tpu_torch.ops import keccak_cuda, slot_write, substep

    keccak_cuda._kernel_fn("keccak_sponge")
    slot_write._kernel_fn()
    substep._kernel_fn()


class ServiceConfig:
    """Arena + policy knobs. Everything has a serving-shaped default;
    tests shrink the arena, `serve` exposes the lot as flags."""

    def __init__(
        self,
        stripes: int = 4,
        lanes_per_stripe: int = 8,
        steps_per_wave: int = 256,
        max_waves: int = 2,
        queue_capacity: int = 64,
        calldata_len: int = 68,
        code_cap: int = 2048,
        code_cache_cap: int = 64,
        host_workers: int = 1,
        host_walk: bool = True,
        execution_timeout: int = 8,
        create_timeout: int = 10,
        transaction_count: int = 2,
        checkpoint_dir: Optional[str] = None,
        coalesce_wait_s: float = 0.05,
        idle_wait_s: float = 0.2,
        pipeline: bool = False,
        specialize: bool = True,
        specialize_warmup: str = "background",
        blockjit: bool = True,
        static_answer: bool = True,
        arena_warmup: bool = False,
        health_interval_s: float = 2.0,
        breakers: bool = True,
        quarantine_strikes: int = 2,
        device=None,
        store_dir: Optional[str] = None,
        store: bool = True,
        router_dir: Optional[str] = None,
        router: bool = True,
    ) -> None:
        self.stripes = stripes
        self.lanes_per_stripe = lanes_per_stripe
        self.steps_per_wave = steps_per_wave
        self.max_waves = max_waves
        self.queue_capacity = queue_capacity
        self.calldata_len = calldata_len
        self.code_cap = code_cap
        self.code_cache_cap = code_cache_cap
        self.host_workers = host_workers
        self.host_walk = host_walk
        self.execution_timeout = execution_timeout
        self.create_timeout = create_timeout
        self.transaction_count = transaction_count
        self.checkpoint_dir = checkpoint_dir
        #: brief admission window before an empty arena's first wave so
        #: near-simultaneous submissions coalesce into one dispatch —
        #: the continuous-batching analogue of a scheduler tick
        self.coalesce_wait_s = coalesce_wait_s
        self.idle_wait_s = idle_wait_s
        #: double-buffered wave pipelining: dispatch wave N+1 (seeded
        #: from the corpora known before wave N's results) to the wave
        #: thread before harvesting wave N, so the host-side
        #: harvest/admission work overlaps device execution — waves
        #: from DISTINCT jobs share the two pipeline slots. Off by
        #: default in the port (on in the JAX package), and `serve`
        #: runs lock-step only: a wave's loop holds the GIL, so the
        #: harvest overlaps little of it, and a job's last wave is
        #: dispatched again before the harvest that ends the job, so
        #: pipelined serving ran slower than lock-step on the card
        #: (PERF.md). The two schedules' second waves differ: lock-step
        #: seeds it with mutations of the first wave's corpus, pipelined
        #: repeats the first wave's seeds, in both packages.
        self.pipeline = pipeline
        #: contract-specialized loops (specialize.py): waves dispatch on
        #: the engine's monotone union bucket (it widens as new phase
        #: groups arrive, never narrows), cached per bucket and pinned
        #: in the code LRU. `serve --no-specialize` restores the generic
        #: interpreter.
        self.specialize = specialize
        #: block-level JIT (laser/batch/blockjit.py): specialized loops
        #: advance whole lowered CFG basic blocks per iteration through
        #: the substep kernel; per-code block-program rows ride the
        #: CodeCache specialization feed. `serve --no-blockjit` keeps
        #: the fuse-only loops.
        self.blockjit = blockjit
        #: the static-answer triage tier at admission: a submission
        #: whose semantic screen (analysis/static taint + sink
        #: predicates) proves NO detection module can fire settles
        #: DONE with an empty issue set before it ever reaches the
        #: queue — no wave, no walk, no lane. Also gated by the
        #: process-wide static flags (`--no-static-prune` restores
        #: full-mount parity).
        self.static_answer = static_answer
        #: cross-run verdict store (store/, `serve --store DIR`): repeat
        #: submissions (same codehash, same analysis-config fingerprint)
        #: settle DONE at admission with the banked issue set
        #: (registry-only admission, no queue slot, no wave, no walk),
        #: and every completed walk writes its verdict back. `--no-store`
        #: (store=False) disables the tier even with a directory
        #: configured.
        self.store_dir = store_dir
        self.store = store
        #: learned tier-ladder router (routing/, `serve --router DIR`):
        #: admission prices host-walk vs device-waves from a trained
        #: cost-model artifact and routes host-cheap submissions straight
        #: to the walk pool (no queue slot, no wave), with in-flight
        #: promotion back to the wave queue on budget overrun.
        #: Absent/refused artifact or `--no-router` (router=False):
        #: today's ladder, bit for bit.
        self.router_dir = router_dir
        self.router = router
        #: arena warmup (`serve` default ON, tests default OFF):
        #: `start()` launches a background thread that builds and loads
        #: the wave's kernel libraries and lands one all-halt wave of
        #: the real dispatch shape; /healthz readiness reports
        #: `arena-warming` until it lands
        self.arena_warmup = arena_warmup
        #: cadence of the health/device sampler thread the server runs
        self.health_interval_s = health_interval_s
        #: tier circuit breakers (support/breaker.py, `--no-breakers`):
        #: device dispatch and the specialized-kernel tier each trip
        #: open on repeated failure and route down their existing
        #: fallback ladder instead of re-failing per job. ANDed with
        #: the process-wide support_args.breakers.
        self.breakers = breakers
        #: poison-job quarantine: a codehash implicated in this many
        #: wave faults settles FAILED with
        #: DegradationReason.QUARANTINED at admission for the rest of
        #: the process life; one strike short of that, the job is
        #: isolated to a SOLO wave so a poison contract cannot take
        #: innocent neighbors down with it.
        self.quarantine_strikes = max(1, int(quarantine_strikes))
        #: how a bucket not yet warm for the dispatch shape is handled:
        #: "background" (default — the wave runs GENERIC while a warmup
        #: thread lands the bucket's first launch off the serving
        #: stream) or "sync" (the dispatching wave runs the bucket —
        #: deterministic, used by the tests)
        self.specialize_warmup = specialize_warmup
        #: where the engine runs: None is the card (raises where there
        #: is none), "cpu" the kernels' plain versions
        self.device = device


class CodeCache:
    """LRU of disassembled dense code rows keyed by code hash — the
    warm path for resubmitted contracts (to_dense is a host-side
    linear sweep, cheap once but not free at service request rates).
    The static summary (analysis/static: CFG + dataflow + prune feed)
    and the kernel-specialization feed (laser/batch/specialize.py:
    PhaseSet bucket + per-pc fuse and block rows + a PINNED handle on
    the bucket's SpecializedKernel) ride in the same LRU entry beside
    the disassembly, so a resubmitted contract skips every sweep AND
    hits an already-warm contract-specialized kernel.

    Eviction releases the entry's kernel pin: the kernel cache may
    then drop the bucket's entry points (unless another resident
    contract still pins the same bucket) — a kernel slot never leaks
    past its LRU entry."""

    def __init__(
        self, code_cap: int, capacity: int = 64, blockjit: bool = True
    ) -> None:
        self.code_cap = code_cap
        self.capacity = max(1, capacity)
        #: engine-level blockjit gate (ServiceConfig.blockjit) — ANDed
        #: with the process-wide blockjit_enabled() switch
        self.blockjit = blockjit
        self._rows: "OrderedDict[str, list]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.static_summaries = 0
        self.kernels_pinned = 0
        self.kernels_released = 0

    @staticmethod
    def code_hash(code: bytes) -> str:
        return hashlib.sha256(code).hexdigest()

    def _release_kernel(self, entry: list) -> None:
        """Drop the entry's pin on its specialization bucket (the
        eviction contract: dense rows and the static summary die with
        the entry by GC; the kernel must be RELEASED so the kernel
        cache can drop its entry points too)."""
        spec = entry[3].get("spec")
        if spec is not None and spec.get("kernel") is not None:
            from mythril_tpu_torch.laser.batch.specialize import kernel_cache

            kernel_cache().release(spec["kernel"])
            spec["kernel"] = None
            self.kernels_released += 1

    def _entry(self, code: bytes) -> list:
        from mythril_tpu_torch.disassembler.asm import to_dense

        key = self.code_hash(code)
        hit = self._rows.get(key)
        if hit is not None:
            self.hits += 1
            self._rows.move_to_end(key)
            return hit
        self.misses += 1
        ops_row = np.zeros((self.code_cap + 33,), dtype=np.uint8)
        ops, jumpdest = to_dense(code, max_len=self.code_cap)
        ops_row[: self.code_cap] = ops
        # slot 3 holds the lazily-built derived feeds: the static
        # summary and the specialization feed (None until a consumer
        # asks for them)
        entry = [
            ops_row, jumpdest, min(len(code), self.code_cap),
            {"summary": None, "summary_tried": False, "spec": None},
        ]
        self._rows[key] = entry
        while len(self._rows) > self.capacity:
            _k, evicted = self._rows.popitem(last=False)
            self._release_kernel(evicted)
            self.evictions += 1
        return entry

    def rows(self, code: bytes) -> Tuple[np.ndarray, np.ndarray, int]:
        """(ops[code_cap+33] u8, jumpdest[code_cap] bool, length)."""
        entry = self._entry(code)
        return entry[0], entry[1], entry[2]

    def static_summary(self, code: bytes):
        """The code's StaticSummary from the same LRU entry, built on
        first request; None when the static layer is off or failed."""
        entry = self._entry(code)
        feeds = entry[3]
        if feeds["summary"] is None and not feeds["summary_tried"]:
            feeds["summary_tried"] = True
            try:
                from mythril_tpu_torch.analysis.static import (
                    static_prune_enabled,
                    summary_for,
                )

                if not static_prune_enabled():
                    return None
                feeds["summary"] = summary_for(code)
                self.static_summaries += 1
            except Exception:
                log.debug("static summary failed", exc_info=True)
                return None
        return feeds["summary"]

    def spec_for(self, code: bytes) -> Optional[Dict]:
        """The code's specialization feed from the same LRU entry:
        {"phases": PhaseSet, "fuse_row": u8[code_cap], "block_row":
        u8[code_cap], "kernel": pinned SpecializedKernel} — built (and
        the kernel warmed lazily on its first wave) once per resident
        code hash, so warm resubmissions dispatch with zero table-sweep
        cost. None when specialization is off or the feed build
        failed."""
        entry = self._entry(code)
        feeds = entry[3]
        if feeds["spec"] is None:
            try:
                from mythril_tpu_torch.laser.batch import blockjit as _bj
                from mythril_tpu_torch.laser.batch import specialize as _spec

                if not _spec.specialize_enabled():
                    return None
                summary = self.static_summary(code)
                blockjit_on = self.blockjit and _bj.blockjit_enabled()
                phases = _spec.phases_for(
                    _spec.signature_for(code, summary),
                    fuse=_spec.fuse_profitable(code, summary),
                    block_depth=(
                        _bj.block_depth_for(code, summary)
                        if blockjit_on
                        else 0
                    ),
                )
                feeds["spec"] = {
                    "phases": phases,
                    "fuse_row": _spec.build_fuse_row(
                        code, self.code_cap, summary
                    ),
                    "block_row": (
                        _bj.build_block_row(code, self.code_cap, summary)
                        if blockjit_on
                        else None
                    ),
                    "kernel": _spec.kernel_cache().acquire(phases),
                }
                self.kernels_pinned += 1
            except Exception:
                log.debug("specialization feed failed", exc_info=True)
                return None
        return feeds["spec"]

    def rebucket(self, code_cap: int) -> None:
        """Grow the capacity (new kernel shape): cached rows are the
        old width, so the cache flushes and rebuilds lazily — kernel
        pins released with their entries."""
        self.code_cap = code_cap
        for entry in self._rows.values():
            self._release_kernel(entry)
        self._rows.clear()

    def stats(self) -> Dict:
        return {
            "size": len(self._rows),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "static_summaries": self.static_summaries,
            "kernels_pinned": self.kernels_pinned,
            "kernels_released": self.kernels_released,
        }


class _JobTrack:
    """Per-resident-job device bookkeeping: lanes, seeds, coverage,
    trigger bank. Touched only by the wave thread."""

    def __init__(
        self, job: Job, stripes: List[int], lanes: List[int],
        calldata_len: int, static_feed=None, spec_feed=None,
    ) -> None:
        import random

        from mythril_tpu_torch.laser.batch.seeds import dispatcher_seeds

        self.job = job
        self.stripes = stripes
        self.lanes = lanes
        self.code_row = stripes[0]
        self.calldata_len = calldata_len
        # the static prune feed masks inert selectors out of this
        # job's seeding; per-job drop delta kept for the report
        self.static = static_feed
        #: the code's specialization feed (CodeCache.spec_for): the
        #: wave kernel is the union bucket over resident jobs' phases
        self.spec = spec_feed
        before = static_feed.seeds_dropped if static_feed else 0
        self.seeds = dispatcher_seeds(
            job.code.hex(), calldata_len, prune=static_feed
        )
        self.static_seeds_dropped = (
            (static_feed.seeds_dropped - before) if static_feed else 0
        )
        self.corpus: List[bytes] = list(self.seeds)
        self.covered: set = set()
        #: True when a donor replica's frontier seeded this track (the
        #: cross-host rebalance handoff; rides into the job report)
        self.frontier_seeded = False
        self.pc_seen: Optional[np.ndarray] = None
        self.triggers: Dict[str, List[Dict]] = {}
        self.waves_done = 0
        self.stale_waves = 0
        self.degraded_lanes = 0
        self.lane_steps = 0
        self.rng = random.Random(int(job.id, 16))
        if job.frontier:
            try:
                self.seed_frontier(job.frontier)
            except Exception:
                log.warning(
                    "job %s: donor frontier refused; exploring from "
                    "scratch", job.id, exc_info=True,
                )

    def seed_frontier(self, frontier: Dict) -> None:
        """Install a donor replica's exported frontier (the
        explore.py `export_frontier` shape, hex-encoded for the HTTP
        hop) BEFORE this track's first wave: the donor's covered
        branch directions stay covered and its parent inputs lead the
        mutation corpus — the service-tier mirror of
        DeviceCorpusExplorer.seed_frontier, so a rebalanced job
        continues the donor's exploration instead of restarting."""
        self.covered |= {
            (int(pc), bool(taken))
            for pc, taken in frontier.get("covered") or []
        }
        inputs = []
        for data in frontier.get("parent_inputs") or []:
            try:
                inputs.append(
                    bytes.fromhex(data) if isinstance(data, str)
                    else bytes(data)
                )
            except (ValueError, TypeError):
                continue
        if inputs:
            self.corpus = inputs + self.corpus
        self.frontier_seeded = True

    def export_frontier(self) -> Dict:
        """Pack this track's live frontier for a host handoff to
        another replica — the same keys DeviceCorpusExplorer.
        export_frontier packs (explore.py), with byte payloads
        hex-encoded so the doc rides GET /v1/frontier/export."""
        return {
            "code_hex": self.job.code.hex(),
            "covered": [
                [int(pc), bool(taken)]
                for pc, taken in sorted(self.covered)
            ],
            "attempted": [],
            "parent_inputs": [d.hex() for d in self.corpus[-64:]],
            "carries": [],
        }

    def next_inputs(self) -> List[bytes]:
        """One calldata per owned lane: dispatcher seeds first, then
        single-byte mutations of the banked corpus (the explorer's
        mutation-fill idiom, scaled down to a stripe)."""
        out: List[bytes] = []
        if self.waves_done == 0:
            for i in range(len(self.lanes)):
                out.append(self.seeds[i % len(self.seeds)])
            return out
        for _ in self.lanes:
            parent = self.rng.choice(self.corpus)
            mutated = bytearray(parent.ljust(self.calldata_len, b"\x00"))
            mutated[self.rng.randrange(len(mutated))] = self.rng.randrange(256)
            out.append(bytes(mutated))
        return out

    def harvest(
        self, inputs: List[bytes], status, halt_pc, gas_min, gas_max,
        br_pc, br_taken, br_cnt, pc_seen, steps: int,
    ) -> None:
        lanes = self.lanes
        fresh = 0
        self.waves_done += 1
        self.lane_steps += steps * len(lanes)
        for data, lane in zip(inputs, lanes):
            st = int(status[lane])
            if st in _DEGRADED_STATUSES:
                self.degraded_lanes += 1
            kind = _TRIGGER_KINDS.get(st)
            if kind is not None:
                bucket = self.triggers.setdefault(kind, [])
                pc = int(halt_pc[lane])
                if all(pc != t["pc"] for t in bucket) and len(bucket) < 64:
                    bucket.append(
                        {
                            "pc": pc,
                            "input": data.hex(),
                            "prefix": [],
                            "gas_min": int(gas_min[lane]),
                            "gas_max": int(gas_max[lane]),
                            "call_value": 0,
                            "prefix_values": [],
                        }
                    )
            for k in range(int(br_cnt[lane])):
                edge = (int(br_pc[lane, k]), bool(br_taken[lane, k]))
                if edge not in self.covered:
                    self.covered.add(edge)
                    fresh += 1
            self.corpus.append(data)
        rows = pc_seen[lanes].astype(np.uint32)
        merged = np.bitwise_or.reduce(rows, axis=0)
        if self.pc_seen is None or np.any(merged & ~self.pc_seen):
            fresh += 1
        self.pc_seen = (
            merged if self.pc_seen is None else (self.pc_seen | merged)
        )
        del self.corpus[256:]  # bounded seed bank
        self.stale_waves = 0 if fresh else self.stale_waves + 1

    def outcome(self) -> Dict:
        """The device phase's result in the prepass-outcome shape
        SymExecWrapper injects (explore.py outcome contract): trigger
        witnesses become Issues, covered branch directions pre-empt
        host feasibility queries."""
        from mythril_tpu_torch.laser.batch.explore import ExploreStats

        stats = ExploreStats()
        stats.device_steps = self.lane_steps
        stats.waves = self.waves_done
        stats.branches_covered = len(self.covered)
        stats.lanes_degraded_mem = 0
        return {
            "covered_branches": sorted(self.covered),
            "corpus_size": len(self.corpus),
            "triggers": {k: list(v) for k, v in self.triggers.items()},
            "evidence": [],
            "device_complete": False,
            "completeness_gates": {},
            "degraded_lanes": self.degraded_lanes,
            "stats": stats.as_dict(),
        }

    def covered_pc_bits(self) -> int:
        if self.pc_seen is None:
            return 0
        return int(
            (np.unpackbits(self.pc_seen.view(np.uint8)) != 0).sum()
        )


class AnalysisEngine:
    """Wave loop + admission + host pool behind the HTTP server.

    `start()` spins the wave loop thread; `submit()` is thread-safe (the
    HTTP layer calls it from handler threads); `drain()` implements the
    SIGTERM contract. The engine also works un-started: submissions
    queue, and a drain checkpoints them — the degenerate case the drain
    tests pin without running a wave."""

    def __init__(self, config: Optional[ServiceConfig] = None) -> None:
        from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket
        from mythril_tpu_torch.support.accel import resolve_device
        from mythril_tpu_torch.support.resilience import DegradationLog

        self.cfg = config or ServiceConfig()
        self.device = resolve_device(self.cfg.device)
        self.queue = JobQueue(self.cfg.queue_capacity)
        self.alloc = LaneAllocator(self.cfg.stripes, self.cfg.lanes_per_stripe)
        self.code_cap = code_cap_bucket(1, floor=self.cfg.code_cap)
        self.code_cache = CodeCache(
            self.code_cap, self.cfg.code_cache_cap,
            blockjit=self.cfg.blockjit,
        )
        self._tracks: "OrderedDict[str, _JobTrack]" = OrderedDict()
        self._arena_ops: Optional[np.ndarray] = None
        self._arena_jd: Optional[np.ndarray] = None
        self._arena_len: Optional[np.ndarray] = None
        self._arena_fuse: Optional[np.ndarray] = None
        self._arena_block: Optional[np.ndarray] = None
        self._code_table = None
        self._fuse_table = None
        self._block_table = None
        self._table_dirty = True
        self._rebuild_arena_rows()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the wave thread and the serving stream: every wave's device
        #: work runs there (`_on_wave_thread`)
        self._wave_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="myth-serve-wave"
        )
        self._stream = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda"
            else None
        )
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.cfg.host_workers),
            thread_name_prefix="myth-serve-host",
        )
        self._host_inflight: Dict[str, Tuple] = {}
        # the learned tier-ladder router (routing/): priced admission and
        # in-flight promotion. None (no artifact, a refused artifact, or
        # router=False) keeps today's ladder bit for bit.
        self._router = None
        if self.cfg.router:
            from mythril_tpu_torch.routing import router as _routing_rt
            from mythril_tpu_torch.routing import tuning as _routing_tune

            try:
                self._router = (
                    _routing_rt.load_router(self.cfg.router_dir)
                    if self.cfg.router_dir
                    else _routing_rt.configured_router()
                )
                # tuned portfolio-override artifacts ride the same
                # directory: install the newest verifying one
                if self.cfg.router_dir:
                    _routing_tune.maybe_install_tuned(self.cfg.router_dir)
            except Exception as why:
                self._router = None
                _routing_rt.record_failure("service-router-load", why)
        self._deg_marker = DegradationLog().marker()
        # -- observability: the wave-loop counters are REGISTRY-backed
        # (mtpu_service_* series labeled by engine instance): every
        # mutation goes through the registry's one lock, and stats()
        # reads them all from ONE snapshot — a point-in-time-consistent
        # /stats instead of field-by-field reads racing the wave loop.
        # The legacy attribute names stay as properties below.
        self.started_t = time.monotonic()
        self._eid = f"e{next(_ENGINE_SERIAL)}"
        reg = observe.registry()
        lab = {"engine": self._eid}
        self._c_waves = reg.counter(
            "mtpu_service_waves_total", "device waves dispatched"
        ).labels(**lab)
        self._c_device_steps = reg.counter(
            "mtpu_service_device_steps_total", "lane-steps executed"
        ).labels(**lab)
        self._c_host_completed = reg.counter(
            "mtpu_service_host_completed_total", "host walks finished"
        ).labels(**lab)
        self._c_rebuckets = reg.counter(
            "mtpu_service_kernel_rebuckets_total",
            "code-capacity re-buckets (arena reshapes)",
        ).labels(**lab)
        self._c_static_seeds = reg.counter(
            "mtpu_service_static_seeds_dropped_total",
            "dispatcher seeds masked by the static prune",
        ).labels(**lab)
        self._c_static_answered = reg.counter(
            "mtpu_service_static_answered_total",
            "submissions settled by the static-answer triage tier "
            "(no device dispatch, no host walk)",
        ).labels(**lab)
        self._c_store_answered = reg.counter(
            "mtpu_service_store_answered_total",
            "submissions settled by the verdict store at admission "
            "(no queue slot, no wave, no walk)",
        ).labels(**lab)
        self._c_store_writebacks = reg.counter(
            "mtpu_service_store_writebacks_total",
            "completed walks persisted into the verdict store",
        ).labels(**lab)
        self._c_wave_kind = reg.counter(
            "mtpu_service_wave_kind_total",
            "waves by kernel kind (specialized vs generic)",
        )
        self._c_spec_waves = self._c_wave_kind.labels(kind="spec", **lab)
        self._c_generic_waves = self._c_wave_kind.labels(
            kind="generic", **lab
        )
        self._c_fused = reg.counter(
            "mtpu_service_fused_steps_total",
            "instructions advanced by fused substeps",
        ).labels(**lab)
        self._c_blocks = reg.counter(
            "mtpu_service_blockjit_blocks_total",
            "lowered basic blocks entered by block substeps "
            "(block-level JIT)",
        ).labels(**lab)
        self._c_fallbacks = reg.counter(
            "mtpu_service_kernel_fallbacks_total",
            "specialized waves retried on the generic kernel",
        ).labels(**lab)
        self._c_overlapped = reg.counter(
            "mtpu_service_pipeline_overlapped_total",
            "harvests that ran with another wave in flight",
        ).labels(**lab)
        self._c_multi_job = reg.counter(
            "mtpu_service_pipeline_multi_job_total",
            "overlaps whose two slots spanned distinct jobs",
        ).labels(**lab)
        self._g_inflight = reg.gauge(
            "mtpu_service_pipeline_inflight",
            "waves currently in flight past the dispatch slot",
        ).labels(**lab)
        self._c_quarantined = reg.counter(
            "mtpu_quarantined_total",
            "jobs settled FAILED by the poison-job quarantine "
            "(denylisted codehash or strike threshold reached)",
        ).labels(**lab)
        # materialize every series at 0 so /metrics exposes the full
        # schema from the first scrape (a dashboard must not have to
        # wait for the first wave to learn the series names)
        for child in (
            self._c_waves, self._c_device_steps, self._c_host_completed,
            self._c_rebuckets, self._c_static_seeds,
            self._c_static_answered, self._c_store_answered,
            self._c_store_writebacks, self._c_spec_waves,
            self._c_generic_waves, self._c_fused, self._c_fallbacks,
            self._c_overlapped, self._c_multi_job, self._c_quarantined,
        ):
            child.inc(0)
        self._g_inflight.set(0)
        #: the engine's monotone specialization bucket (widens as jobs
        #: with new phase groups arrive; a wider kernel stays sound
        #: for every lane) and the warmups already launched for it
        self._union_phases = None
        self._kernel_warming: set = set()
        self._warmups_launched = 0
        #: a bucket warmup's fault that is not the card's (a failed
        #: build, a bug): the loop thread raises it on its next
        #: dispatch, so the wave's jobs fail with it
        self._kernel_fault: Optional[Exception] = None
        self._warmup_threads: List[threading.Thread] = []
        self._first_wave_t: Optional[float] = None
        self._last_wave_t: Optional[float] = None
        self._wave_cold_s: Optional[float] = None
        self._wave_warm_ema_s: Optional[float] = None
        # -- cross-run verdict store (store/) ---------------------------
        # one fingerprint per engine: the service's verdict-relevant
        # config is fixed at construction, so repeats hash once
        self.vstore = None
        self._config_fp: Optional[str] = None
        if self.cfg.store:
            from mythril_tpu_torch.analysis.static.summary import (
                analysis_config_fingerprint,
            )
            from mythril_tpu_torch.store import configured_store

            # a directory that cannot be opened is recorded
            # store-unavailable by store/store.py: the tier stays off
            self.vstore = configured_store(self.cfg.store_dir)
            if self.vstore is not None:
                self._config_fp = analysis_config_fingerprint(
                    transaction_count=self.cfg.transaction_count,
                    create_timeout=self.cfg.create_timeout,
                )
        self._checkpoint_dir: Optional[str] = self.cfg.checkpoint_dir
        self._drained = threading.Event()
        self._draining = False
        #: where the drain's final flight-recorder flush landed (None
        #: until drained; /stats observe.flight_dump mirrors it)
        self.flight_dump_path: Optional[str] = None
        # -- health state machine (observe/slo.py) ---------------------
        # the SLO engine samples the shared registry; the monitor folds
        # objective burn with this engine's lifecycle facts into the
        # ok/degraded/redlined machine /healthz and mtpu_health_state
        # export. Warming is set immediately when arena warmup is off.
        self._warm_done = threading.Event()
        #: why the arena warmup failed (None while it has not): the
        #: replica then stays redlined, so never ready
        self._warm_error: Optional[str] = None
        if not self.cfg.arena_warmup:
            self._warm_done.set()
        self.health = observe.HealthMonitor(
            warming_fn=lambda: not self._warm_done.is_set(),
            compiling_fn=lambda: any(
                t.is_alive() for t in self._warmup_threads
            ),
            draining_fn=lambda: self._draining,
            saturation_fn=self._saturation_reasons,
        )
        # the device monitor reads this engine's arena occupancy and
        # device memory (the newest engine owns the sources; tests run
        # many engines per process and the live serve runs one)
        monitor = observe.device_monitor()
        monitor.set_arena_source(self.alloc.occupancy)
        monitor.set_device(self.device)
        # -- poison-job quarantine ------------------------------------
        # strike counters by codehash (wave-fault attribution) and the
        # process-lifetime denylist; a clean DONE settle clears a
        # codehash's strikes
        self._strikes: Dict[str, int] = {}
        self._denylist: set = set()
        #: idempotency-key -> job id: a retried submit with a known key
        #: maps to the existing job instead of double-running
        self._idem: Dict[str, str] = {}

    # -- legacy counter names (views over the registry series) ---------
    @property
    def waves_total(self) -> int:
        return int(self._c_waves.value)

    @property
    def spec_waves(self) -> int:
        return int(self._c_spec_waves.value)

    @property
    def generic_waves(self) -> int:
        return int(self._c_generic_waves.value)

    @property
    def kernel_fused_steps(self) -> int:
        return int(self._c_fused.value)

    @property
    def kernel_fallbacks(self) -> int:
        return int(self._c_fallbacks.value)

    # -- lifecycle -----------------------------------------------------
    def _saturation_reasons(self) -> List[str]:
        """Live redline facts for the health monitor: a full admission
        queue means the replica is refusing work RIGHT NOW — a front
        should stop routing here before the SLO windows even notice."""
        from mythril_tpu_torch.observe import slo

        reasons: List[str] = []
        if self.queue.depth() >= self.queue.capacity:
            reasons.append(slo.REDLINE_QUEUE_SATURATED)
        if self._warm_error is not None:
            reasons.append(slo.REDLINE_WARMUP_FAILED)
        # open tier breakers (support/breaker.py): the replica is
        # serving through a fallback ladder — enumerated so a front can
        # route around it until the half-open probe recovers
        if self.cfg.breakers:
            from mythril_tpu_torch.support import breaker as cb

            if cb.breakers_enabled():
                reasons.extend(cb.open_reasons())
        return reasons

    def _halt_batch(self, n: int):
        """The all-halt batch of the dispatch shape: every lane on the
        halt row (all zero: STOP at pc 0), on the engine's device."""
        from mythril_tpu_torch.laser.batch.state import make_batch

        return make_batch(
            n,
            code_ids=np.full((n,), self.cfg.stripes, np.int32),
            calldata=[b""] * n,
            device=self.device,
            **_BLOCK_ENV,
        )

    def _halt_tables(self, ops_shape):
        """(code table, substep table) of the arena's shape (`ops_shape`
        is the code table's ops shape), all zero: the tables a warmup
        runs on, its own, so that no warmup reads a table a wave may be
        using on the serving stream."""
        from mythril_tpu_torch.laser.batch.state import CodeTable

        rows, width = ops_shape
        dev = self.device
        return (
            CodeTable(
                torch.zeros((rows, width), dtype=torch.uint8, device=dev),
                torch.zeros((rows, width - 33), dtype=torch.bool, device=dev),
                torch.zeros((rows,), dtype=torch.int32, device=dev),
            ),
            torch.zeros((rows, width - 33), dtype=torch.uint8, device=dev),
        )

    def _side_stream(self):
        """A CUDA stream of the caller's own (a warmup's), or a null
        context on the CPU."""
        if self.device.type != "cuda":
            return nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(device=self.device))

    def _arena_warmup(self) -> None:
        """Build and load the wave's kernel libraries OFF the serving
        path, then land one all-halt wave of the exact dispatch shape,
        on a side stream, so the first real request finds them loaded
        and readiness truthfully says when. A failure (a kernel
        library that does not build or load, a warmup wave that faults)
        is recorded in the DegradationLog and redlines the replica with
        `arena-warmup-failed` for the rest of its life, so readiness
        never flips; a wave that reaches the same fault fails its
        jobs with it."""
        from mythril_tpu_torch.laser.batch.run import wave_run
        from mythril_tpu_torch.support import hostsync
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        try:
            with trace("service.arena.warmup", track="service"):
                if self.device.type == "cuda":
                    load_wave_kernels()
                with self._side_stream():
                    table, _substeps = self._halt_tables(
                        (self.cfg.stripes + 1, self.code_cap + 33)
                    )
                    out, _steps = wave_run(
                        self._halt_batch(self.alloc.n_lanes),
                        table,
                        max_steps=self.cfg.steps_per_wave,
                        track_coverage=True,
                    )
                    hostsync.fetch([out.status])
        except Exception as why:
            log.exception("arena warmup failed")
            self._warm_error = f"{type(why).__name__}: {why}"
            DegradationLog().record(
                DegradationReason.ARENA_WARMUP_FAILED,
                site="service-arena-warmup",
                detail=self._warm_error,
            )
        finally:
            self._warm_done.set()

    def start(self) -> "AnalysisEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="myth-serve-waves", daemon=True
            )
            self._thread.start()
            if self.cfg.arena_warmup and not self._warm_done.is_set():
                threading.Thread(
                    target=self._arena_warmup,
                    name="myth-arena-warmup",
                    daemon=True,
                ).start()
        return self

    def submit(self, job: Job) -> Job:
        """Admit `job` through the tier ladder; returns the CANONICAL
        job — which is an earlier one when the submission carried an
        idempotency key the service has already seen (a client retry
        after a dropped connection must map back to the same job, never
        double-run)."""
        from mythril_tpu_torch.support.resilience import inject

        inject("service.admit")
        key = job.idempotency_key
        if key:
            existing = self.queue.get(self._idem.get(key, ""))
            if existing is not None:
                return existing
        observe.journey_event(
            job.journey_id, journey.TIER_ADMISSION, "submitted",
            code_len=len(job.code),
        )
        if key:
            self._idem[key] = job.id
        if self._try_quarantine(job):
            return job
        if self._try_store_hit(job):
            return job
        if self._try_static_answer(job):
            return job
        if self._try_routed_host(job):
            return job
        self.queue.submit(job)  # raises QueueRefusal on backpressure
        self._wake.set()
        return job

    # -- poison-job quarantine -----------------------------------------
    def _strike(self, code_hash: str) -> int:
        """One wave-fault strike against a codehash; returns the new
        count."""
        count = self._strikes.get(code_hash, 0) + 1
        self._strikes[code_hash] = count
        return count

    def _is_quarantined(self, code_hash: str) -> bool:
        return (
            code_hash in self._denylist
            or self._strikes.get(code_hash, 0)
            >= self.cfg.quarantine_strikes
        )

    def _is_suspect(self, code_hash: str) -> bool:
        """One strike short of quarantine: the job still runs, but
        ISOLATED to a solo wave — a poison contract must not take
        innocent arena neighbors down with its next fault."""
        return self._strikes.get(code_hash, 0) >= 1

    def _quarantine_job(self, job: Job, code_hash: str) -> None:
        """Settle `job` FAILED with the QUARANTINED degradation and
        denylist its codehash for the process lifetime. The job must
        already be registered in the queue."""
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        self._denylist.add(code_hash)
        self._c_quarantined.inc()
        job.degraded.append(DegradationReason.QUARANTINED)
        job.error = (
            job.error
            or "codehash quarantined after repeated wave faults"
        )
        DegradationLog().record(
            DegradationReason.QUARANTINED,
            site="service-quarantine",
            contract=job.id,
            detail=code_hash[:16],
        )
        observe.journey_event(
            job.journey_id, journey.TIER_ADMISSION, "quarantined",
            code_hash=code_hash[:16],
        )
        job.report = {
            "job_id": job.id,
            "journey_id": job.journey_id,
            "code_hash": code_hash,
            "quarantined": True,
            "issues": [],
        }
        self.queue.settle(job, JobState.FAILED)
        self._routing_record(job, route="quarantined")

    def _try_quarantine(self, job: Job) -> bool:
        """The quarantine gate at admission: a denylisted (or
        strike-threshold) codehash settles FAILED instantly —
        registry-only admission, no queue slot, no wave, no chance to
        crash the arena again. False lets the job continue down the
        tier ladder; QueueRefusal propagates when draining."""
        code_hash = CodeCache.code_hash(job.code)
        if not self._is_quarantined(code_hash):
            return False
        self.queue.register(job)  # raises QueueRefusal when draining
        self._quarantine_job(job, code_hash)
        return True

    # -- tier circuit breakers -----------------------------------------
    def _breaker(self, tier: str):
        """The tier's process-wide breaker, or None when the layer is
        off (config knob AND the --no-breakers flag bag switch)."""
        from mythril_tpu_torch.support import breaker as cb

        if not (self.cfg.breakers and cb.breakers_enabled()):
            return None
        return cb.breaker(tier)

    def _breaker_allow(self, tier: str) -> bool:
        br = self._breaker(tier)
        return True if br is None else br.allow()

    def _breaker_record(self, tier: str, ok: bool, detail: str = "") -> None:
        br = self._breaker(tier)
        if br is None:
            return
        if ok:
            br.record_success()
        else:
            br.record_failure(detail)

    def _try_store_hit(self, job: Job) -> bool:
        """The verdict-store exact-hit tier at admission (HTTP thread,
        one hash and one file read warm): a submission whose (codehash,
        config fingerprint) is banked settles DONE with the stored issue
        set before it ever reaches the queue (registry-only admission,
        exactly like the static-answer tier below it). False keeps the
        job on the full path; QueueRefusal propagates when draining. A
        lookup that raises is recorded `store-unavailable`."""
        from mythril_tpu_torch.store import store_enabled
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        if self.vstore is None or not store_enabled():
            return False
        try:
            entry = self.vstore.get(
                CodeCache.code_hash(job.code), self._config_fp
            )
        except Exception as why:
            DegradationLog().record(
                DegradationReason.STORE_UNAVAILABLE,
                site="service-store",
                contract=job.id,
                detail=f"{type(why).__name__}: {why}; full path",
            )
            return False
        if entry is None:
            return False
        self.queue.register(job)  # raises QueueRefusal when draining
        self._c_store_answered.inc()
        observe.journey_event(
            job.journey_id, journey.TIER_STORE_HIT, "banked-verdict",
            issues=len(entry.issues or ()),
        )
        now = time.monotonic()
        job.report = {
            "job_id": job.id,
            "journey_id": job.journey_id,
            "code_hash": entry.code_hash,
            "store_hit": True,
            "issues": entry.issues,
            "store": {
                "config_fingerprint": entry.config_fp,
                "provenance": entry.provenance,
            },
            "timings": {
                "queued_s": 0.0,
                "device_s": 0.0,
                "total_s": round(now - job.created_t, 6),
            },
        }
        self.queue.settle(job, JobState.DONE)
        self._routing_record(job, route="store-hit")
        return True

    def _try_static_answer(self, job: Job) -> bool:
        """The static-answer triage tier at admission (runs on the
        HTTP thread — pure host work): when the semantic screen proves
        NO detection module can fire on this code, the job settles DONE
        with an empty issue set before it ever reaches the queue. False
        keeps the job on the full wave/walk path; QueueRefusal
        propagates when draining."""
        from mythril_tpu_torch.analysis.static import static_answer_enabled

        if not (self.cfg.static_answer and static_answer_enabled()):
            return False
        try:
            from mythril_tpu_torch.analysis.static import summary_for

            summary = summary_for(job.code)
            if not summary.static_answerable:
                return False
        except Exception:
            log.debug("static triage failed; full path", exc_info=True)
            return False
        self.queue.register(job)  # raises QueueRefusal when draining
        self._c_static_answered.inc()
        observe.journey_event(
            job.journey_id, journey.TIER_STATIC_ANSWER, "screened-clean",
            wall_ms=summary.wall_ms,
        )
        now = time.monotonic()
        job.report = {
            "job_id": job.id,
            "journey_id": job.journey_id,
            "code_hash": CodeCache.code_hash(job.code),
            "static_answered": True,
            "issues": [],
            "static": {
                "modules_applicable": 0,
                "static_answerable": True,
                "wall_ms": summary.wall_ms,
            },
            "timings": {
                "queued_s": 0.0,
                "device_s": 0.0,
                "total_s": round(now - job.created_t, 6),
            },
        }
        self.queue.settle(job, JobState.DONE)
        self._routing_record(job, route="static-answer")
        return True

    def _try_routed_host(self, job: Job) -> bool:
        """The cost-model admission tier (routing/): when the loaded
        router prices this submission cheaper on the host walk than on
        device waves, dispatch it STRAIGHT to the walk pool —
        registry-only admission, no queue slot, no wave, the arena stays
        free for wave-bound work. The walk runs with the card off,
        clamped to the decision's predicted budget; an overrun or error
        promotes the job back onto the wave queue in `_finalize` (the
        routing record then settles as promoted-device-waves). False
        keeps the job on today's queue path, which is also the answer
        whenever no router is loaded, the walk pool is saturated, or the
        model has no opinion, so router-off parity is structural. A
        decision that raises is recorded `router-failed`."""
        if self._router is None or not self.cfg.host_walk:
            return False
        if job.host_walk is False or job.frontier is not None:
            return False
        # cap direct dispatches at the walk pool's width: past that the
        # queue's wave tier is the better wait anyway
        if len(self._host_inflight) >= max(1, self.cfg.host_workers):
            return False
        try:
            decision = self._router.decide(
                observe.routing_features_for(
                    job.code.hex(),
                    summary=self.code_cache.static_summary(job.code),
                ),
                tiers=["host-walk", "device-waves"],
            )
        except Exception as why:
            from mythril_tpu_torch.routing.router import record_failure

            record_failure("service-route-decision", why, job.id)
            return False
        if decision is None or decision.route != "host-walk":
            return False
        self.queue.register(job)  # raises QueueRefusal when draining
        job.routed = "host-walk"
        job.route_budget_s = decision.budget_s()
        pair = decision.expected.get("host-walk")
        observe.journey_event(
            job.journey_id, journey.TIER_ADMISSION, "routed",
            route="host-walk",
            predicted_wall_s=round(pair[0], 4) if pair else None,
            budget_s=round(job.route_budget_s, 4),
        )
        now = time.monotonic()
        job.started_t = now
        job.device_done_t = now  # no device phase: host_s is the wall
        self.queue.mark(job, JobState.ANALYZING)
        # the injected-outcome shape the walk consumes (a track's empty
        # outcome): a zeroed ExploreStats, no coverage, no triggers
        from mythril_tpu_torch.laser.batch.explore import ExploreStats

        outcome = {
            "covered_branches": [],
            "corpus_size": 0,
            "triggers": {},
            "evidence": [],
            "device_complete": False,
            "completeness_gates": {},
            "degraded_lanes": 0,
            "stats": ExploreStats().as_dict(),
        }
        future = self._pool.submit(self._host_task, job, None, outcome)
        self._host_inflight[job.id] = (future, None, outcome)
        return True

    def _routing_record(self, job: Job, route: Optional[str] = None) -> None:
        """One routing-feature record per settled service job: the same
        features, route and outcome row the corpus driver writes, with
        the job's journey_id. A record that cannot be built is recorded
        `routing-record-failed`."""
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        if not observe.enabled():
            return
        try:
            report = job.report or {}
            result = {
                "issues": report.get("issues") or [],
                "wall_s": (report.get("timings") or {}).get("total_s"),
                "error": job.error,
                "complete": job.error is None,
                "store_hit": route == "store-hit",
                "static_answered": route == "static-answer",
                "quarantined": route == "quarantined",
                # the router's own vocabulary: a routed or promoted job
                # settles as routed-<tier> / promoted-<tier>
                "routed": job.routed if route is None else None,
                "promoted": job.promoted if route is None else None,
            }
            # the store-hit and quarantine tiers settle in microseconds:
            # their records must not pay a CFG recovery for features
            summary = (
                False
                if route in ("store-hit", "quarantined")
                else self.code_cache.static_summary(job.code)
            )
            observe.routing_log().record(
                contract=f"job-{job.id}",
                code_hash=CodeCache.code_hash(job.code),
                features=observe.routing_features_for(
                    job.code.hex(), summary=summary
                ),
                outcome=observe.routing_outcome_for(result),
                journey_id=job.journey_id,
            )
        except Exception as why:
            DegradationLog().record(
                DegradationReason.ROUTING_RECORD_FAILED,
                site="service-routing-record",
                contract=job.id,
                detail=f"{type(why).__name__}: {why}",
            )

    @property
    def draining(self) -> bool:
        return self._draining

    def export_frontiers(self) -> Dict:
        """The GET /v1/frontier/export payload: every non-terminal job
        with enough context to re-run on another replica — resident
        jobs carry their live track frontier (covered directions +
        corpus tail), queued jobs pass along whatever donor frontier
        they arrived with. Resubmitted elsewhere with the ORIGINAL
        idempotency key, the frontier seeds the survivor's track
        (Job.frontier) so exploration continues where this replica left
        off. Tracks are owned by the wave loop; by the time a caller
        asks (the replica is draining) the loop is winding down, and a
        marginally stale frontier only costs re-exploration, never
        correctness."""
        docs = []
        for job in self.queue.nonterminal():
            track = self._tracks.get(job.id)
            try:
                frontier = (
                    track.export_frontier()
                    if track is not None
                    else dict(
                        job.frontier
                        or {"code_hex": job.code.hex()}
                    )
                )
            except Exception:
                log.warning(
                    "frontier export failed for job %s", job.id,
                    exc_info=True,
                )
                frontier = {"code_hex": job.code.hex()}
            docs.append({
                "job_id": job.id,
                "state": job.state,
                "code": job.code.hex(),
                "idempotency_key": job.idempotency_key,
                "params": {
                    "max_waves": job.max_waves,
                    "deadline_s": (
                        job.deadline.budget_s if job.deadline else None
                    ),
                    "host_walk": job.host_walk,
                    "lanes": job.lanes,
                },
                "frontier": frontier,
            })
        return {
            "schema_version": 1,
            "draining": self._draining,
            "jobs": docs,
        }

    def drain(self, timeout_s: float = 120.0) -> None:
        """The SIGTERM contract: refuse new work, finish the in-flight
        wave and the in-flight host analyses, checkpoint everything
        else to replayable npz. Idempotent."""
        with self._lock:
            if self._draining:
                self._drained.wait(timeout_s)
                return
            self._draining = True
        queued = self.queue.drain_remaining()
        self._stop.set()
        self._wake.set()
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            wedged = self._thread.is_alive()
            if wedged:
                # a wedged device call: checkpoint from the host-side
                # track state anyway (it is no longer being mutated in
                # any way that matters — the wave will be re-run from
                # the checkpoint) and say so
                log.warning(
                    "drain: wave thread still busy after %.0fs; "
                    "checkpointing resident jobs from the last "
                    "harvested state", timeout_s,
                )
        # resident jobs: their next-wave frontier, seeded exactly as
        # the wave loop would have
        for track in list(self._tracks.values()):
            self._checkpoint_job(track.job, track)
            self.alloc.release(track.stripes)
        self._tracks.clear()
        # never-admitted jobs: their first-wave frontier
        for job in queued:
            self._checkpoint_job(job, None)
        # host pool: running analyses finish, queued ones cancel and
        # fall back to device-only reports (the device phase already
        # completed — its findings are not lost, the walk is skipped)
        self._pool.shutdown(wait=True, cancel_futures=True)
        for job_id, (future, track, outcome) in list(
            self._host_inflight.items()
        ):
            if future.cancelled():
                job = self.queue.get(job_id)
                if job is not None and not job.terminal:
                    job.degraded.append("interrupted")
                    self._finalize(job, track, outcome, host_result=None)
        self._host_inflight.clear()
        # in-flight kernel warmups finish before the wave thread goes
        # (bounded: a warmup is one all-halt launch, and no new warmup
        # starts once draining)
        for thread in self._warmup_threads:
            thread.join(timeout=60.0)
        # the wave thread is idle unless a wave wedged the loop (then
        # the drain goes on without it, as without the loop thread)
        self._wave_pool.shutdown(wait=not wedged)
        # the final flight-recorder flush: the drained service leaves
        # its span timeline beside its checkpoints (Perfetto JSON), so
        # a post-mortem sees what the waves were doing at shutdown
        if observe.enabled():
            try:
                dump_dir = observe.out_dir() or self.checkpoint_dir()
                self.flight_dump_path = observe.export_trace(
                    os.path.join(dump_dir, "flight_recorder.trace.json")
                )
            except Exception:
                log.debug("drain flight-recorder flush failed",
                          exc_info=True)
        # release the saturation sources if this engine still owns them
        # (tests run many engines; the sampler must not keep reading a
        # drained allocator as "the" arena)
        monitor = observe.device_monitor()
        if monitor._arena_source == self.alloc.occupancy:
            monitor.set_arena_source(None)
            monitor.set_device(None)
        self._drained.set()

    def close(self) -> None:
        self.drain()

    # -- admission + arena ---------------------------------------------
    def _rebuild_arena_rows(self) -> None:
        rows = self.cfg.stripes + 1  # + the halt row idle lanes run
        self._arena_ops = np.zeros((rows, self.code_cap + 33), np.uint8)
        self._arena_jd = np.zeros((rows, self.code_cap), bool)
        self._arena_len = np.zeros((rows,), np.int32)
        # per-row superblock fuse + block-program tables (specialize
        # .py / blockjit.py): the halt row stays all-zero (idle lanes
        # never fuse or block-step)
        self._arena_fuse = np.zeros((rows, self.code_cap), np.uint8)
        self._arena_block = np.zeros((rows, self.code_cap), np.uint8)
        self._table_dirty = True

    def _install_code(self, track: _JobTrack) -> None:
        ops_row, jd_row, length = self.code_cache.rows(track.job.code)
        self._arena_ops[track.code_row] = ops_row
        self._arena_jd[track.code_row] = jd_row
        self._arena_len[track.code_row] = length
        self._arena_fuse[track.code_row] = (
            track.spec["fuse_row"]
            if track.spec is not None
            else 0
        )
        block_row = (
            track.spec.get("block_row") if track.spec is not None else None
        )
        self._arena_block[track.code_row] = (
            block_row if block_row is not None else 0
        )
        self._table_dirty = True

    def _ensure_code_cap(self, code: bytes) -> None:
        from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket

        if len(code) <= self.code_cap:
            return
        self.code_cap = code_cap_bucket(len(code), floor=self.code_cap)
        self._c_rebuckets.inc()
        self.code_cache.rebucket(self.code_cap)
        self._rebuild_arena_rows()
        for resident in self._tracks.values():
            self._install_code(resident)
        log.info(
            "service arena re-bucketed code capacity to %d", self.code_cap
        )

    def _admit(self) -> None:
        """Between waves: pull queued jobs into free stripes. A SUSPECT
        job (one quarantine strike — implicated in a wave fault) is
        only ever admitted into an EMPTY arena and blocks co-admissions
        while resident: its next fault must take down nobody else."""
        if any(
            self._is_suspect(CodeCache.code_hash(t.job.code))
            for t in self._tracks.values()
        ):
            return  # a solo wave is in progress; nobody rides along
        free = self.alloc.stripes - self.alloc.occupancy()["stripes_busy"]
        if free <= 0:
            return
        claimed = self.queue.claim(free)
        stop_at: Optional[int] = None
        for idx, job in enumerate(claimed):
            suspect = self._is_suspect(CodeCache.code_hash(job.code))
            if suspect and self._tracks:
                # the suspect waits for an empty arena
                stop_at = idx
                break
            n_stripes = self.alloc.stripes_needed(
                job.lanes or self.cfg.lanes_per_stripe
            )
            if n_stripes > self.alloc.stripes_per_group:
                # a job must fit the arena: its wave is one dispatch
                n_stripes = self.alloc.stripes_per_group
            granted = self.alloc.allocate(job.id, n_stripes)
            if granted is None:
                stop_at = idx
                break
            self._ensure_code_cap(job.code)
            lanes = [
                lane for s in granted for lane in self.alloc.lanes_of(s)
            ]
            track = _JobTrack(
                job, granted, lanes, self.cfg.calldata_len,
                static_feed=self.code_cache.static_summary(job.code),
                spec_feed=(
                    self.code_cache.spec_for(job.code)
                    if self.cfg.specialize
                    else None
                ),
            )
            self._c_static_seeds.inc(track.static_seeds_dropped)
            self._install_code(track)
            self._tracks[job.id] = track
            observe.journey_event(
                job.journey_id, journey.TIER_LANE_GRANT, "granted",
                stripes=len(granted), lanes=len(lanes),
                group=self.alloc.group_of(granted[0]), solo=suspect,
            )
            if suspect:
                # a solo wave: admit nobody else alongside
                stop_at = idx + 1
                break
        if stop_at is not None:
            # hand unplaced claims back in reverse so the queue keeps
            # its FIFO order (unclaim inserts at the head)
            for job in reversed(claimed[stop_at:]):
                if job.id not in self._tracks:
                    self.queue.unclaim(job)

    def _table(self):
        """The arena's code table on the engine's device, rebuilt from
        the host rows when an admission changed them (loop thread
        only). The upload is a blocking copy, so a wave on another
        stream reads a complete table."""
        from mythril_tpu_torch.laser.batch.state import CodeTable

        if self._table_dirty or self._code_table is None:
            dev = self.device
            self._code_table = CodeTable(
                torch.from_numpy(self._arena_ops.copy()).to(dev),
                torch.from_numpy(self._arena_jd.copy()).to(dev),
                torch.from_numpy(self._arena_len.copy()).to(dev),
            )
            self._fuse_table = torch.from_numpy(self._arena_fuse.copy()).to(dev)
            self._block_table = torch.from_numpy(self._arena_block.copy()).to(dev)
            self._table_dirty = False
        return self._code_table

    def _substep_table(self, phases):
        """The substep table matching a wave bucket (same dirty
        lifecycle as `_table()`, which must have been called first this
        wave): the block-program rows for a blockjit bucket, the
        superblock fuse rows otherwise."""
        if phases is not None and phases.block_depth > 0:
            return self._block_table
        return self._fuse_table

    def _wave_kernel(self, job_ids, n: int, table) -> Optional[Tuple]:
        """(kernel, phases) for this wave, or None for a generic wave.

        The bucket is the engine's MONOTONE union over every admitted
        job's phases: residency churn (jobs finishing, new mixes)
        never narrows it. A bucket not yet warm for this dispatch shape
        is handled per `specialize_warmup`: "background" runs THIS wave
        generic and warms the bucket off the serving stream; "sync"
        runs the bucket on the wave. Any resident job without a
        specialization feed makes the wave generic (the striped
        dispatch is one kernel)."""
        if not self.cfg.specialize:
            return None
        from mythril_tpu_torch.laser.batch import specialize as _spec

        if not _spec.specialize_enabled():
            return None
        with self._lock:
            fault, self._kernel_fault = self._kernel_fault, None
        if fault is not None:
            # a bucket warmup failed for a reason that is not the card's:
            # fail this wave's jobs with it rather than serve them generic
            raise fault
        if not self._breaker_allow("kernel"):
            # the kernel breaker is open (failed warmups or specialized
            # waves): the specialized tier is routed around, every wave
            # runs the generic interpreter, and /healthz reports
            # `breaker-open:kernel` until the half-open probe recovers
            return None
        feeds = []
        for jid in job_ids:
            track = self._tracks.get(jid)
            if track is None or track.spec is None:
                return None
            feeds.append(track.spec["phases"])
        if not feeds:
            return None
        if self._union_phases is not None:
            feeds.append(self._union_phases)
        self._union_phases = _spec.union_phases(feeds)
        kernel = _spec.kernel_cache().get(self._union_phases)
        key = self._run_key(n, table)
        if kernel.is_warm(key):
            return kernel, self._union_phases
        if self.cfg.specialize_warmup == "sync":
            return kernel, self._union_phases
        self._warm_kernel_async(kernel, key)
        return None

    @staticmethod
    def _run_key(n: int, table) -> tuple:
        """SpecializedKernel.run_key of a service wave: `n` lanes at
        make_batch's memory and stack caps, donated."""
        from mythril_tpu_torch.laser.batch.specialize import SpecializedKernel
        from mythril_tpu_torch.laser.batch.state import MEM_CAP, STACK_CAP

        return SpecializedKernel.shape_key(n, MEM_CAP, STACK_CAP, table.ops.shape, True)

    def _warm_kernel_async(self, kernel, key) -> None:
        """Warm the bucket for this dispatch shape OFF the serving
        path: a daemon thread runs the bucket's loop once over an
        all-halt batch of the same shape, on a side stream of its own
        over zero tables of its own (the lanes halt on the halt row
        after one iteration). At most one warmup per (bucket, shape) at
        a time. A failed warmup is recorded
        (DegradationReason.SPECIALIZE_FAILED) and fed to the kernel
        breaker, and the next wave of the bucket warms it again, until
        the breaker opens; a fault that is not the card's is handed to
        the loop thread, which raises it (`_wave_kernel`)."""
        warm_id = (kernel.phases, key)
        with self._lock:
            if self._draining or warm_id in self._kernel_warming:
                return
            self._kernel_warming.add(warm_id)
            self._warmups_launched += 1
        n = key[2]
        steps = self.cfg.steps_per_wave
        # Warmup-pin the kernel so a capacity eviction racing this
        # thread cannot drop its entry points mid-warmup: eviction may
        # still unmap the bucket (counted inflight), but the discard is
        # deferred to release_warmup below — deterministic either way.
        from mythril_tpu_torch.laser.batch import specialize as _spec
        from mythril_tpu_torch.support import hostsync, resilience

        _spec.kernel_cache().pin_warmup(kernel)

        def _warm():
            try:
                with self._side_stream():
                    table, substeps = self._halt_tables(key[5])
                    out = kernel.run(
                        self._halt_batch(n), table, substeps,
                        max_steps=steps, track_coverage=True, donate=True,
                    )
                    hostsync.fetch([out[0].status])
            except Exception as why:
                log.warning("kernel warmup failed", exc_info=True)
                resilience.DegradationLog().record(
                    resilience.DegradationReason.SPECIALIZE_FAILED,
                    site="service-kernel-warmup",
                    detail=f"{type(why).__name__}: {why}",
                )
                self._breaker_record("kernel", False, str(why))
                with self._lock:
                    self._kernel_warming.discard(warm_id)
                    if not resilience.is_device_fault(why):
                        self._kernel_fault = why
            else:
                self._breaker_record("kernel", True)
            finally:
                _spec.kernel_cache().release_warmup(kernel)

        thread = threading.Thread(
            target=_warm, name="myth-kernel-warmup", daemon=True
        )
        self._warmup_threads.append(thread)
        thread.start()

    # -- the wave loop -------------------------------------------------
    def _loop(self) -> None:
        """Pipelined: dispatch wave N+1 (seeded from corpora known
        before wave N's results — the service's mutation seeding never
        needed the in-flight wave's outcome) BEFORE harvesting wave N,
        so the wave thread runs N+1 on the card while this thread
        consumes N and admits new jobs into freed stripes. With
        `pipeline` off, each wave is dispatched and harvested
        lock-step."""
        inflight: Optional[Dict] = None
        while not self._stop.is_set():
            try:
                nxt = self._dispatch_wave()
            except Exception as why:
                log.exception("service wave dispatch fault; jobs failed")
                self._fail_wave(why, strike=False)
                nxt = None
            if inflight is not None:
                if nxt is not None:
                    self._c_overlapped.inc()
                    jobs = set(inflight["wave_inputs"]) | set(
                        nxt["wave_inputs"]
                    )
                    if len(jobs) > 1:
                        # the two pipeline slots hold waves spanning
                        # more than one job
                        self._c_multi_job.inc()
                try:
                    self._harvest_wave(inflight)
                except Exception as why:
                    log.exception("service wave loop fault; jobs failed")
                    self._fail_wave(why, strike=False)
                inflight = None
                self._g_inflight.set(0)
            if nxt is not None:
                if self.pipeline_enabled:
                    inflight = nxt
                    self._g_inflight.set(1)
                else:
                    try:
                        self._harvest_wave(nxt)
                    except Exception as why:
                        log.exception("service wave loop fault; jobs failed")
                        self._fail_wave(why, strike=False)
            elif inflight is None:
                self._wake.wait(self.cfg.idle_wait_s)
                self._wake.clear()
        if inflight is not None:
            # the drain contract: the in-flight wave is finished, its
            # jobs harvested, before checkpoints are cut
            try:
                self._harvest_wave(inflight)
            except Exception as why:
                log.exception("drain harvest of the in-flight wave failed")
                self._fail_wave(why, strike=False)
            self._g_inflight.set(0)

    @property
    def pipeline_enabled(self) -> bool:
        return bool(self.cfg.pipeline)

    def _on_wave_thread(self, fn):
        """Submit `fn` to the wave thread, where it runs on the serving
        stream; returns its future. Every wave's device work, retries
        included, runs there, in dispatch order."""
        stream = self._stream

        def _job():
            ctx = torch.cuda.stream(stream) if stream is not None else nullcontext()
            with ctx:
                return fn()

        return self._wave_pool.submit(_job)

    def _wave_job(self, code_ids, calldata, table, substeps, kernel):
        """One wave's device work, start to end, on the wave thread:
        seed the batch from the host inputs, run it (the bucket's
        specialized loop, or the generic `wave_run`), read back what the
        harvest needs in one `hostsync.fetch`, which synchronizes the
        serving stream, so a CUDA fault of the wave surfaces here.
        Returns (status, pc, gas_min, gas_max, br_pc, br_taken, br_cnt,
        pc_seen) as numpy arrays, the steps, and (substep lane-steps,
        blocks entered) of a specialized run, else None."""
        from mythril_tpu_torch.laser.batch.run import wave_run
        from mythril_tpu_torch.laser.batch.state import make_batch
        from mythril_tpu_torch.support import hostsync

        if self._stream is not None:
            # the tables were uploaded on the loop thread's stream: mark
            # them in use here, so their memory outlives this wave
            cur = torch.cuda.current_stream(self.device)
            for t in (*table, *(() if substeps is None else (substeps,))):
                t.record_stream(cur)
        batch = make_batch(
            len(code_ids), code_ids=code_ids, calldata=calldata,
            device=self.device, **_BLOCK_ENV,
        )
        sub = None
        if kernel is not None:
            out, steps, fused, blocks = kernel.run(
                batch, table, substeps,
                max_steps=self.cfg.steps_per_wave,
                track_coverage=True, donate=True,
            )
            sub = (fused, blocks)
        else:
            out, steps = wave_run(
                batch, table, max_steps=self.cfg.steps_per_wave,
                track_coverage=True,
            )
        fields = [out.status, out.pc, out.gas_min, out.gas_max,
                  out.br_pc, out.br_taken, out.br_cnt, out.pc_seen]
        if sub is not None:
            fields += list(sub)
        host = hostsync.fetch(fields)
        if sub is not None:
            sub = (int(host[8]), int(host[9]))
        return host[:8], int(steps), sub

    def _dispatch_wave(self) -> Optional[Dict]:
        """Admit queued jobs, seed every resident job's lanes, and
        dispatch the wave to the wave thread (no wait): returns the
        in-flight record the harvest half consumes. The host-side
        inputs ride the record so a faulted wave can be rebuilt and
        retried through the synchronous resilience ladder."""
        from mythril_tpu_torch.support import resilience

        if not self._tracks and self.queue.depth():
            # the coalesce window: near-simultaneous submissions share
            # the first wave instead of serializing behind it
            time.sleep(self.cfg.coalesce_wait_s)
        self._admit()
        if not self._tracks:
            return None
        if not self._breaker_allow("device"):
            # the device-tier breaker is OPEN: route every resident
            # job's device phase straight down the ladder to the host
            # walk — zero doomed dispatches, zero per-job retry cost.
            # The half-open probe (after recovery_s) re-enters the
            # normal dispatch below and its outcome moves the breaker.
            for track in list(self._tracks.values()):
                del self._tracks[track.job.id]
                self.alloc.release(track.stripes)
                track.job.device_done_t = time.monotonic()
                track.job.degraded.append("breaker-open:device")
                observe.journey_event(
                    track.job.journey_id, journey.TIER_WAVE,
                    "breaker-skip",
                )
                self._dispatch_host(track)
            return None
        halt_row = self.cfg.stripes
        n = self.alloc.n_lanes
        code_ids = np.full((n,), halt_row, np.int32)
        calldata: List[bytes] = [b""] * n
        wave_inputs: Dict[str, List[bytes]] = {}
        for track in self._tracks.values():
            inputs = track.next_inputs()
            wave_inputs[track.job.id] = inputs
            observe.journey_event(
                track.job.journey_id, journey.TIER_WAVE, "dispatch",
                wave=track.waves_done + 1,
            )
            for lane, data in zip(track.lanes, inputs):
                code_ids[lane] = track.code_row
                calldata[lane] = data
        record: Dict = {
            "wave_inputs": wave_inputs,
            "code_ids": code_ids,
            "calldata": calldata,
            "future": None,
            "spec": False,
            "failed": None,
            "t0": time.perf_counter(),
        }
        try:
            resilience.inject("service.dispatch")
            with trace(
                "service.wave.dispatch", track="service",
                jobs=len(wave_inputs),
            ):
                table = self._table()
                spec = self._wave_kernel(wave_inputs, n, table)
                if spec is not None:
                    kernel, phases = spec
                    record["spec"] = True
                    self._c_spec_waves.inc()
                    substeps = self._substep_table(phases)
                else:
                    self._c_generic_waves.inc()
                    kernel = substeps = None
                record["future"] = self._on_wave_thread(
                    lambda: self._wave_job(
                        code_ids, calldata, table, substeps, kernel
                    )
                )
        except Exception as why:
            if not resilience.is_device_fault(why):
                raise
            record["failed"] = why
        return record

    def _rebuild_batch(self, record: Dict):
        """The wave's batch, seeded again from the host inputs that ride
        its record (the dispatched batch was stepped in place)."""
        from mythril_tpu_torch.laser.batch.state import make_batch

        return make_batch(
            self.alloc.n_lanes,
            code_ids=record["code_ids"],
            calldata=record["calldata"],
            device=self.device,
            **_BLOCK_ENV,
        )

    def _retry_wave(self, record: Dict):
        """`run_resilient` over the rebuilt batch, GENERIC, on the wave
        thread and the engine's device; the same readback as a wave."""
        from mythril_tpu_torch.laser.batch.run import run_resilient
        from mythril_tpu_torch.support import hostsync

        table = self._table()

        def _go():
            out, steps = run_resilient(
                self._rebuild_batch(record),
                table,
                max_steps=self.cfg.steps_per_wave,
                track_coverage=True,
            )
            return hostsync.fetch(
                [out.status, out.pc, out.gas_min, out.gas_max,
                 out.br_pc, out.br_taken, out.br_cnt, out.pc_seen]
            ), int(steps)

        return self._on_wave_thread(_go).result()

    def _note_wave_timing(self, wall: float) -> None:
        now = time.monotonic()
        self._c_waves.inc()
        if self._first_wave_t is None:
            self._first_wave_t = now
            self._wave_cold_s = wall
        else:
            ema = self._wave_warm_ema_s
            self._wave_warm_ema_s = (
                wall if ema is None else 0.8 * ema + 0.2 * wall
            )
        self._last_wave_t = now

    def _job_wave_done(self, track: _JobTrack) -> bool:
        """Post-harvest settlement: deadline expiry, wave cap,
        staleness."""
        track.job.waves = track.waves_done
        observe.journey_event(
            track.job.journey_id, journey.TIER_WAVE, "harvest",
            wave=track.waves_done,
            covered_branches=len(track.covered),
            stale_waves=track.stale_waves,
        )
        max_waves = track.job.max_waves or self.cfg.max_waves
        expired = (
            track.job.deadline is not None and track.job.deadline.expired
        )
        if expired:
            from mythril_tpu_torch.support.resilience import (
                DegradationLog,
                DegradationReason,
            )

            track.job.degraded.append(DegradationReason.DEADLINE_EXPIRED)
            DegradationLog().record(
                DegradationReason.DEADLINE_EXPIRED,
                site="service-wave",
                contract=track.job.id,
            )
        return bool(
            expired
            or track.waves_done >= max_waves
            or track.stale_waves >= 2
        )

    def _harvest_wave(self, record: Dict) -> None:
        from mythril_tpu_torch.support import resilience

        try:
            resilience.inject("service.harvest")
            if record["failed"] is not None:
                raise record["failed"]
            # a wave's faults surface HERE, attributed to the wave in
            # this record, not to whatever the host was doing
            with trace("service.wave.harvest", track="service"):
                fields, steps, sub = record["future"].result()
            # the retrospective device-execution span (dispatch ->
            # readback-ready): the service's Perfetto track
            flight_recorder().add(
                "wave.device",
                record["t0"],
                time.perf_counter(),
                track="service",
                jobs=len(record["wave_inputs"]),
            )
            if sub is not None:
                self._c_fused.inc(sub[0])
                self._c_blocks.inc(sub[1])
            self._breaker_record("device", True)
            if record["spec"]:
                self._breaker_record("kernel", True)
        except Exception as why:
            if not resilience.is_device_fault(why):
                raise
            self._breaker_record("device", False, str(why))
            resilience.DegradationLog().record(
                resilience.DegradationReason.ASYNC_DEVICE_FAULT,
                site="service-wave",
                detail=str(why),
            )
            if record.get("spec"):
                # the retry ladder always re-dispatches GENERIC: a
                # specialized loop must not be retried into itself
                self._c_fallbacks.inc()
                self._breaker_record("kernel", False, str(why))
            try:
                fields, steps = self._retry_wave(record)
            except Exception as ladder_why:
                self._fail_wave(ladder_why)
                return
        wave_inputs = record["wave_inputs"]
        self._note_wave_timing(time.perf_counter() - record["t0"])
        status, halt_pc, gas_min, gas_max, br_pc, br_taken, br_cnt, seen = (
            fields
        )
        self._c_device_steps.inc(steps * self.alloc.n_lanes)
        finished: List[_JobTrack] = []
        for track in list(self._tracks.values()):
            if track.job.id not in wave_inputs:
                # admitted AFTER this wave dispatched (pipelined): its
                # first wave is the one still in flight
                continue
            track.harvest(
                wave_inputs[track.job.id], status, halt_pc, gas_min,
                gas_max, br_pc, br_taken, br_cnt, seen, steps,
            )
            if self._job_wave_done(track):
                finished.append(track)
        for track in finished:
            del self._tracks[track.job.id]
            self.alloc.release(track.stripes)
            track.job.device_done_t = time.monotonic()
            self._dispatch_host(track)

    def _fail_wave(self, why: Exception, strike: bool = True) -> None:
        """A wave died past run_resilient's whole escalation ladder, or
        (`strike` False) on a fault that is not the card's (a kernel
        that does not build, a bug): fail the resident jobs with the
        fault recorded — the service itself stays up for the next
        request. Only a device fault strikes the jobs' codes."""
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        DegradationLog().record(
            DegradationReason.WAVE_ABANDONED,
            site="service-wave",
            detail=str(why),
        )
        for track in list(self._tracks.values()):
            del self._tracks[track.job.id]
            self.alloc.release(track.stripes)
            track.job.error = f"device wave failed: {why}"
            if strike:
                self._fail_with_strike(track.job)
            else:
                self.queue.settle(track.job, JobState.FAILED)

    def _fail_with_strike(self, job: Job) -> None:
        """Settle a wave-faulted job FAILED with quarantine
        attribution: every job resident in the dead wave takes a
        strike (a poison contract and its innocent neighbors are
        indistinguishable HERE — the solo-wave isolation on the next
        submission is what tells them apart: innocents pass their solo
        wave and the strike clears; the poison faults again and
        quarantines)."""
        code_hash = CodeCache.code_hash(job.code)
        strikes = self._strike(code_hash)
        if strikes >= self.cfg.quarantine_strikes:
            self._quarantine_job(job, code_hash)
            return
        self.queue.settle(job, JobState.FAILED)

    # -- host phase ----------------------------------------------------
    def _dispatch_host(self, track: _JobTrack) -> None:
        job = track.job
        outcome = track.outcome()
        host_walk = (
            self.cfg.host_walk if job.host_walk is None else job.host_walk
        )
        if not host_walk:
            self._finalize(job, track, outcome, host_result=None)
            return
        self.queue.mark(job, JobState.ANALYZING)
        future = self._pool.submit(self._host_task, job, track, outcome)
        self._host_inflight[job.id] = (future, track, outcome)

    def _host_task(self, job: Job, track: _JobTrack, outcome: Dict) -> None:
        """The host walk of one finished job (SymExecWrapper +
        fire_lasers through corpus._analyze_one, the device outcome
        injected, so the walk runs no prepass of its own). Its solver
        queries race the engine's device, as every walk of the port
        does."""
        from mythril_tpu_torch.analysis.corpus import _analyze_one
        from mythril_tpu_torch.support.host_lock import HOST_SYMBOLIC_LOCK

        timeout = self.cfg.execution_timeout
        if job.deadline is not None:
            timeout = max(1, min(timeout, int(job.deadline.remaining)))
        routed_walk = track is None and job.routed and not job.promoted
        if routed_walk and job.route_budget_s:
            # routed walk: clamp to the decision's budget, so a mis-route
            # pays at most the predicted wall (plus slack) before
            # `_finalize` promotes it onto the wave queue
            timeout = max(1, min(timeout, int(job.route_budget_s + 0.999)))
        observe.journey_event(
            job.journey_id, journey.TIER_HOST_WALK, "start",
            timeout_s=timeout,
        )
        solver_before = observe.solver_marker()
        try:
            # host symbolic state (term arena, CDCL session) is
            # process-global: in-process workers serialize here
            with HOST_SYMBOLIC_LOCK:
                with trace(
                    "service.host.walk", track="service", job=job.id
                ):
                    result = _analyze_one(
                        job.code.hex(),
                        "",
                        f"job-{job.id}",
                        DEFAULT_ADDRESS,
                        outcome,
                        strategy="bfs",
                        transaction_count=self.cfg.transaction_count,
                        execution_timeout=timeout,
                        create_timeout=self.cfg.create_timeout,
                        max_depth=128,
                        loop_bound=3,
                        device=self.device,
                        # a routed walk keeps off the card, as the JAX
                        # engine's walks do: the arena is the wave
                        # thread's
                        use_device=not routed_walk,
                    )
        except CancelledError:
            raise
        except Exception as why:  # _analyze_one already catches
            result = {"issues": [], "states": 0, "error": str(why)}
        # the walk ran under HOST_SYMBOLIC_LOCK, so the attribution
        # delta is this job's: the ladder hops (device vs CDCL) land on
        # the timeline as one solver-tier event
        try:
            attribution = observe.solver_attribution(solver_before)
            if attribution:
                observe.journey_event(
                    job.journey_id, journey.TIER_SOLVER, "escalations",
                    **{
                        origin: row["queries"]
                        for origin, row in attribution.items()
                    },
                )
        except Exception:
            log.debug("journey solver attribution failed", exc_info=True)
        observe.journey_event(
            job.journey_id, journey.TIER_HOST_WALK, "done",
            issues=len(result.get("issues") or ()),
            states=result.get("states", 0),
        )
        self._host_inflight.pop(job.id, None)
        self._c_host_completed.inc()
        self._finalize(job, track, outcome, host_result=result)

    def _finalize(
        self, job: Job, track: Optional[_JobTrack], outcome: Dict,
        host_result: Optional[Dict],
    ) -> None:
        now = time.monotonic()
        # in-flight promotion (routing/): a router-dispatched walk that
        # errored or burned its whole clamped budget was mis-routed, so
        # instead of settling a truncated result the job goes to the
        # HEAD of the wave queue for the device tier it was denied. One
        # promotion at most (job.promoted latches), and the regret, the
        # wall burnt beyond the predicted budget, is counted.
        if (
            track is None
            and job.routed
            and not job.promoted
            and self._router is not None
            and host_result is not None
            and not self.queue.draining
            and (job.deadline is None or job.deadline.remaining > 1.0)
        ):
            wall = now - (job.started_t or job.created_t)
            clamp = int((job.route_budget_s or 0) + 0.999)
            if host_result.get("error") is not None or (
                clamp and wall >= clamp - 0.05
            ):
                job.promoted = "device-waves"
                job.error = None
                self._router.note_promotion("host-walk", "device-waves")
                if job.route_budget_s and wall > job.route_budget_s:
                    self._router.note_regret(wall - job.route_budget_s)
                observe.journey_event(
                    job.journey_id, journey.TIER_ADMISSION, "promoted",
                    route="device-waves", walk_wall_s=round(wall, 4),
                )
                job.device_done_t = None
                self.queue.unclaim(job)
                self._wake.set()
                return
        device_s = (
            (job.device_done_t or now) - (job.started_t or job.created_t)
        )
        report = {
            "job_id": job.id,
            "journey_id": job.journey_id,
            "code_hash": CodeCache.code_hash(job.code),
            "device": {
                "waves": outcome["stats"]["waves"],
                "lane_steps": outcome["stats"]["device_steps"],
                "covered_branches": len(outcome["covered_branches"]),
                "covered_pc_bits": (
                    track.covered_pc_bits() if track is not None else 0
                ),
                "triggers": {
                    kind: len(bucket)
                    for kind, bucket in outcome["triggers"].items()
                },
                "degraded_lanes": outcome["degraded_lanes"],
                "static_pruned_seeds": (
                    track.static_seeds_dropped if track is not None else 0
                ),
            },
            "issues": [],
            "timings": {
                "queued_s": round(
                    (job.started_t or now) - job.created_t, 3
                ),
                "device_s": round(device_s, 3),
            },
        }
        state = JobState.DONE
        if host_result is not None:
            report["issues"] = host_result.get("issues", [])
            report["host"] = {
                "states": host_result.get("states", 0),
                "error": host_result.get("error"),
            }
            report["timings"]["host_s"] = round(
                now - (job.device_done_t or now), 3
            )
            if host_result.get("error"):
                job.error = host_result["error"]
                state = JobState.FAILED
        if job.degraded:
            report["degraded"] = list(job.degraded)
        report["timings"]["total_s"] = round(now - job.created_t, 3)
        job.report = report
        # the routing record lands BEFORE the settle wakes long-poll
        # waiters: a client that sees the terminal state must find the
        # record (and its journey_id) already in the log
        self._routing_record(job)
        self.queue.settle(job, state)
        if state == JobState.DONE:
            # a clean completion clears any quarantine strikes: an
            # innocent job implicated in a shared-wave fault proves
            # itself by passing its solo wave
            self._strikes.pop(CodeCache.code_hash(job.code), None)
            self._store_writeback(job, report, outcome)

    def _store_writeback(self, job: Job, report: Dict, outcome: Dict) -> None:
        """Tier 3: a job that completed its host walk cleanly (no error,
        no degradation) banks its verdict and the wave phase's evidence
        for future admissions. Device-only reports (host walk off) are
        NOT banked: the store must never serve a weaker verdict than a
        full analysis would compute. A write that fails is recorded
        `store-writeback-failed` (by store/store.py, or here when the
        export raises)."""
        if self.vstore is None or report.get("host") is None:
            return
        if report["host"].get("error") or job.degraded:
            return
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        try:
            from mythril_tpu_torch.store import (
                banks_from_outcome,
                provenance,
                static_export,
            )

            summary = self.code_cache.static_summary(job.code)
            path = self.vstore.put(
                CodeCache.code_hash(job.code),
                self._config_fp,
                issues=report.get("issues") or [],
                static=static_export(summary),
                banks=banks_from_outcome(outcome),
                provenance=provenance(
                    wall_s=report["timings"].get("total_s"),
                    computed_by=f"service:{self._eid}",
                ),
            )
        except Exception as why:
            DegradationLog().record(
                DegradationReason.STORE_WRITEBACK_FAILED,
                site="service-store",
                contract=job.id,
                detail=f"{type(why).__name__}: {why}",
            )
            return
        if path:
            self._c_store_writebacks.inc()

    # -- drain checkpoints ----------------------------------------------
    def checkpoint_dir(self) -> str:
        if self._checkpoint_dir is None:
            self._checkpoint_dir = tempfile.mkdtemp(prefix="myth-serve-")
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        return self._checkpoint_dir

    def _checkpoint_job(self, job: Job, track: Optional[_JobTrack]) -> None:
        """Flush one unfinished job's seeded frontier to a replayable
        npz: its lanes' next-wave inputs (or first-wave dispatcher
        seeds when it never entered the arena) against its own
        single-contract code table. The npz is the JAX package's
        format (laser/batch/checkpoint.py), which both packages'
        load_checkpoint read; it is built on the host, so a drain
        touches no device."""
        from mythril_tpu_torch.laser.batch.checkpoint import save_checkpoint
        from mythril_tpu_torch.laser.batch.seeds import (
            code_cap_bucket,
            dispatcher_seeds,
        )
        from mythril_tpu_torch.laser.batch.state import (
            make_batch,
            make_code_table,
        )

        try:
            if track is not None:
                n = len(track.lanes)
                inputs = track.next_inputs()
            else:
                n = (
                    self.alloc.stripes_needed(
                        job.lanes or self.cfg.lanes_per_stripe
                    )
                    * self.cfg.lanes_per_stripe
                )
                # same prune feed a wave admission would have used, so
                # the checkpointed frontier replays what the engine
                # would actually have seeded
                seeds = dispatcher_seeds(
                    job.code.hex(), self.cfg.calldata_len,
                    prune=self.code_cache.static_summary(job.code),
                )
                inputs = [seeds[i % len(seeds)] for i in range(n)]
            table = make_code_table(
                [job.code], code_cap=code_cap_bucket(len(job.code)),
                device="cpu",
            )
            batch = make_batch(n, calldata=inputs, device="cpu", **_BLOCK_ENV)
            path = os.path.join(
                self.checkpoint_dir(), f"job-{job.id}.npz"
            )
            save_checkpoint(
                path, batch, table, step=self.cfg.steps_per_wave
            )
            job.checkpoint_path = path
            self.queue.settle(job, JobState.CHECKPOINTED)
        except Exception as why:
            log.exception("drain checkpoint failed for job %s", job.id)
            job.error = f"drain checkpoint failed: {why}"
            self.queue.settle(job, JobState.FAILED)

    # -- introspection --------------------------------------------------
    def _kernel_stats(self) -> Dict:
        """The specialization scorecard (/stats kernel.*): the
        process-wide kernel cache (size, hits, misses, first launches
        in flight, their wall) plus this engine's wave split and fused
        throughput. The compile plane is not ported: its blocks read as
        disabled."""
        from mythril_tpu_torch.laser.batch.blockjit import blockjit_enabled
        from mythril_tpu_torch.laser.batch.specialize import (
            kernel_cache_stats,
            specialize_enabled,
        )

        out = {
            "enabled": bool(self.cfg.specialize) and specialize_enabled(),
            "warmup": self.cfg.specialize_warmup,
            "warmups_launched": self._warmups_launched,
            "spec_waves": self.spec_waves,
            "generic_waves": self.generic_waves,
            "fused_steps": self.kernel_fused_steps,
            "blockjit": (
                bool(self.cfg.specialize)
                and specialize_enabled()
                and bool(self.cfg.blockjit)
                and blockjit_enabled()
            ),
            "blockjit_blocks": int(self._c_blocks.value),
            "fallbacks": self.kernel_fallbacks,
            "pinned_codes": self.code_cache.kernels_pinned
            - self.code_cache.kernels_released,
        }
        out.update(kernel_cache_stats())
        # the cache's own counters under their /stats names
        out["cache_hits"] = out.pop("hits")
        out["cache_misses"] = out.pop("misses")
        out["compileplane"] = {"enabled": False}
        out["generic_aot"] = {"enabled": False}
        return out

    def _breaker_stats(self) -> Dict:
        """`/stats breaker.*`: the tier circuit-breaker board
        (support/breaker.py) — per-tier state/trip/failure counters,
        process-wide (the tiers are shared, not per-engine)."""
        from mythril_tpu_torch.support import breaker as cb

        enabled = bool(self.cfg.breakers) and cb.breakers_enabled()
        return {
            "enabled": enabled,
            "tiers": cb.board_stats() if enabled else {},
        }

    @staticmethod
    def _solver_stats(snap: Dict) -> Dict:
        """`/stats solver.*`: the query flight recorder's live view —
        the loss waterfall (why host-answered queries were not
        device-answered), the host-WON restriction, and the capture
        corpus state (observe/querylog.py). Process-wide series, not
        per-engine: the solver funnel is shared."""
        from mythril_tpu_torch.observe import querylog

        loss: Dict[str, int] = {}
        loss_sat: Dict[str, int] = {}
        for key, value in (snap.get("mtpu_solver_loss_total") or {}).items():
            labels = dict(key)
            reason = labels.get("reason", "?")
            loss[reason] = loss.get(reason, 0) + int(value)
            if labels.get("verdict") == "sat":
                loss_sat[reason] = loss_sat.get(reason, 0) + int(value)
        return {
            "loss": loss,
            "loss_sat": loss_sat,
            "captured_queries": int(
                sum(
                    (
                        snap.get("mtpu_solver_captured_queries_total") or {}
                    ).values()
                )
            ),
            "capture_dir": querylog.capture_dir(),
        }

    def stats(self) -> Dict:
        """The /stats tree. The wave-loop counters all come out of ONE
        registry snapshot (a single lock acquisition), so the numbers
        are point-in-time consistent with each other even while the
        wave loop is mutating them; the queue/arena/cache blocks are
        internally consistent behind their own locks. Pinned by
        `schema_version`: the JAX package's key set, with the blocks of
        the modules the port leaves out (mesh, journal) reading as
        disabled or zero."""
        from mythril_tpu_torch.analysis.static import link_stat_counts
        from mythril_tpu_torch.support.resilience import DegradationLog

        now = time.monotonic()
        snap = observe.registry().snapshot()

        def sv(name: str, **labels) -> float:
            return snap.get(name, {}).get(
                _label_key(dict(labels, engine=self._eid)), 0
            )

        waves_total = int(sv("mtpu_service_waves_total"))
        overlapped = int(sv("mtpu_service_pipeline_overlapped_total"))
        span = (
            (self._last_wave_t - self._first_wave_t)
            if waves_total > 1
            else None
        )
        occupancy = self.alloc.occupancy()
        return {
            "schema_version": STATS_SCHEMA_VERSION,
            "uptime_s": round(now - self.started_t, 3),
            "draining": self._draining,
            "queue": {
                "depth": self.queue.depth(),
                "capacity": self.queue.capacity,
                "accepted": self.queue.accepted,
                "rejected_full": self.queue.rejected_full,
                "rejected_draining": self.queue.rejected_draining,
                "jobs": self.queue.jobs_by_state(),
            },
            "arena": occupancy,
            "waves": {
                "count": waves_total,
                "steps_per_wave": self.cfg.steps_per_wave,
                "device_steps": int(sv("mtpu_service_device_steps_total")),
                "rate_per_s": (
                    round((waves_total - 1) / span, 3) if span else 0.0
                ),
                "cold_wave_s": (
                    round(self._wave_cold_s, 4)
                    if self._wave_cold_s is not None
                    else None
                ),
                "warm_wave_s": (
                    round(self._wave_warm_ema_s, 4)
                    if self._wave_warm_ema_s is not None
                    else None
                ),
            },
            "warm": {
                "code_cap": self.code_cap,
                "kernel_rebuckets": int(
                    sv("mtpu_service_kernel_rebuckets_total")
                ),
                "code_cache": self.code_cache.stats(),
            },
            "pipeline": {
                "enabled": self.pipeline_enabled,
                "inflight": int(sv("mtpu_service_pipeline_inflight")),
                "overlapped_waves": overlapped,
                "multi_job_overlaps": int(
                    sv("mtpu_service_pipeline_multi_job_total")
                ),
                "wave_overlap_ratio": (
                    round(overlapped / waves_total, 3)
                    if waves_total
                    else 0.0
                ),
            },
            "mesh": {
                "devices": 1,
                "groups": self.alloc.groups,
                "steals": 0,
                "rebalance_bytes": 0,
                "per_device": [
                    dict(g, waves=0, devices=None, faults=0)
                    for g in occupancy["groups"]
                ],
            },
            "store": dict(
                (
                    self.vstore.stats()
                    if self.vstore is not None
                    else {
                        "hits": 0,
                        "near_hits": 0,
                        "misses": 0,
                        "writes": 0,
                        "bytes": 0,
                        "evictions": 0,
                        "corrupt": 0,
                    }
                ),
                enabled=self.vstore is not None,
                answered=int(sv("mtpu_service_store_answered_total")),
                writebacks=int(sv("mtpu_service_store_writebacks_total")),
            ),
            "static": {
                "summaries_cached": self.code_cache.static_summaries,
                "seeds_dropped": int(
                    sv("mtpu_service_static_seeds_dropped_total")
                ),
                "static_answered": int(
                    sv("mtpu_service_static_answered_total")
                ),
                "answer_enabled": bool(self.cfg.static_answer),
                # the cross-contract linker's process-wide counters
                # (analysis/static/callgraph.py): the `static.link.*` rows
                "link": link_stat_counts(),
            },
            "journal": {
                "enabled": False,
                "recovered_jobs": 0,
                "recovery_deduped": 0,
            },
            "breaker": self._breaker_stats(),
            "quarantine": {
                "strikes": dict(self._strikes),
                "denylisted": len(self._denylist),
                "strike_threshold": self.cfg.quarantine_strikes,
                "quarantined": int(sv("mtpu_quarantined_total")),
            },
            "kernel": self._kernel_stats(),
            "solver": self._solver_stats(snap),
            "host_pool": {
                "workers": max(1, self.cfg.host_workers),
                "inflight": len(self._host_inflight),
                "completed": int(sv("mtpu_service_host_completed_total")),
            },
            "observe": {
                "enabled": observe.enabled(),
                "spans_recorded": flight_recorder().recorded,
                "flight_dump": self.flight_dump_path,
            },
            "health": self.health.healthz_payload(),
            "device": observe.device_monitor().latest(),
            "degradation": DegradationLog().counts_since(self._deg_marker),
        }
