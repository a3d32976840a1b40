"""Per-contract specialized step loops: opcode-set pruning and superblock
fusion, in eager PyTorch.

The port of the JAX package's laser/batch/specialize.py, with its
decisions and results reproduced bit for bit:

- **Opcode-set pruning.** A `step.PhaseSet` derived from the contract's
  reachable-opcode signature (the static summary's features, else a
  linear sweep) prunes handler phases. A lane that reaches a pruned
  opcode is parked UNSUPPORTED at the instruction (host takeover).
- **Superblock fusion.** Each loop iteration runs one pruned full step
  plus `fuse_depth - 1` fused substeps, which execute only lanes
  sitting on a fusible op (PUSH/DUP/SWAP/POP/JUMPDEST, marked per pc in
  the fuse table) whose stack and gas cannot fault on it; every other
  lane waits for the next full step, so the result equals the generic
  loop's. With `block_depth` > 0 the iteration runs that many block
  substeps instead (blockjit.py).
- **Buckets and the cache.** Kernels are keyed by the PhaseSet (the
  bucket), so similar contracts share one; `KernelCache` is the JAX
  package's LRU with pins.

What changes against the JAX package:

- the loops are Python, with one any-RUNNING host read an iteration
  (as `run.py`); all the substeps of an iteration are ONE launch of the
  hand-written CUDA kernel `csrc/substep.cu` (`ops.substep.substep_run`;
  a substep touches only its own lane, and a lane it skips keeps its
  state, so a per-lane loop that stops at the first skip computes what
  the batch-wide sequence computes). `fused_substep`,
  `sym_fused_substep` (here) and blockjit.py's `block_substep`,
  `sym_block_substep` are the plain versions, one substep each;
- nothing is traced: `SpecializedKernel.compiles` counts the distinct
  (entry point, shape) first dispatches, and `compile_s` is their
  first-call wall;
- there is no compile plane (the JAX `_plane`, `plane_hits`,
  `plane_stores`), no metrics registry (the compile histogram and the
  cache-lookup counters) and no kernel-tier circuit breaker; a
  dispatch's `donate` runs in place (the caller's batch is consumed),
  as `symbolic.sym_run_inplace` does.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.run import _any_running
from mythril_tpu_torch.laser.batch.state import CodeTable, StateBatch, Status
from mythril_tpu_torch.laser.batch.step import (
    GENERIC_PHASES,
    PHASE_FLAGS,
    PHASE_OPS,
    PhaseSet,
    _meta,
    step,
)
from mythril_tpu_torch.ops import substep as substep_op
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support.opcodes import OPCODES

M32 = 0xFFFFFFFF

#: full step + (FUSE_DEPTH - 1) fused substeps per loop iteration
FUSE_DEPTH = 4

#: byte -> opcode name (linear-sweep signature extraction)
_BYTE_TO_NAME = {entry[0]: name for name, entry in OPCODES.items()}

#: the fusible op set: pure stack shuffling with static gas
_FUSE_BYTES = frozenset(
    list(range(0x60, 0x80))  # PUSH1..PUSH32
    + list(range(0x80, 0x90))  # DUP1..DUP16
    + list(range(0x90, 0xA0))  # SWAP1..SWAP16
    + [0x50, 0x5B]  # POP, JUMPDEST
)

# ---------------------------------------------------------------------------
# signatures + phase decisions
# ---------------------------------------------------------------------------
def signature_for(code: bytes, summary=None) -> frozenset:
    """The contract's opcode-name signature: the static summary's
    reachable feature set when one is attached, else a linear byte sweep
    following PUSH immediates."""
    if summary is not None:
        features = getattr(summary, "features", None)
        if features:
            return frozenset(features)
    names = set()
    pc, n = 0, len(code)
    while pc < n:
        op = code[pc]
        name = _BYTE_TO_NAME.get(op)
        if name is not None:
            names.add(name)
        pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return frozenset(names)


def phases_for(
    signature: Iterable[str], fuse: bool = True, block_depth: int = 0
) -> PhaseSet:
    """The pruning decision: a phase stays iff the signature reaches one
    of its opcodes. `block_depth` > 0 swaps the fused substeps for block
    substeps (blockjit.py) and is part of the bucket key."""
    signature = set(signature)
    flags = {
        flag: any(opname in signature for opname in ops)
        for flag, ops in PHASE_OPS.items()
    }
    return PhaseSet(
        **flags,
        fuse_depth=FUSE_DEPTH if fuse else 0,
        block_depth=int(block_depth),
    )


def union_phases(phase_sets: Iterable[PhaseSet]) -> PhaseSet:
    """The bucket of a multi-contract wave: a phase stays iff any striped
    contract needs it, and the substep depths take the max."""
    phase_sets = list(phase_sets)
    if not phase_sets:
        return GENERIC_PHASES
    merged = {
        name: any(getattr(ph, name) for ph in phase_sets)
        for name in PHASE_FLAGS
    }
    return PhaseSet(
        **merged,
        fuse_depth=max(ph.fuse_depth for ph in phase_sets),
        block_depth=max(ph.block_depth for ph in phase_sets),
    )


#: fusible opcode NAMES (the CFG-walk twin of _FUSE_BYTES)
_FUSE_NAMES = frozenset(
    [f"PUSH{i}" for i in range(1, 33)]
    + [f"DUP{i}" for i in range(1, 17)]
    + [f"SWAP{i}" for i in range(1, 17)]
    + ["POP", "JUMPDEST"]
)


def _summary_cfg(summary):
    """The static summary's recovered CFG, or None."""
    if summary is None:
        return None
    return getattr(summary, "cfg", None)


def build_fuse_row(code: bytes, code_cap: int, summary=None) -> np.ndarray:
    """u8[code_cap]: 1 at every pc whose instruction is fusible. With a
    static summary the marks come from its CFG's instruction list (so
    fusion and the block JIT agree on alignment); else the sweep."""
    row = np.zeros((code_cap,), np.uint8)
    cfg = _summary_cfg(summary)
    if cfg is not None:
        for ins in cfg.instructions:
            if ins.opcode in _FUSE_NAMES and ins.address < code_cap:
                row[ins.address] = 1
        return row
    pc, n = 0, len(code)
    while pc < n and pc < code_cap:
        op = code[pc]
        if op in _FUSE_BYTES:
            row[pc] = 1
        pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return row


def build_fuse_table(
    codes: List[bytes], code_cap: int, summaries: Optional[List] = None
) -> np.ndarray:
    """One fuse row per CodeTable row, same row order."""
    if summaries is None:
        summaries = [None] * len(codes)
    return np.stack(
        [
            build_fuse_row(code, code_cap, summary)
            for code, summary in zip(codes, summaries)
        ]
    )


def fuse_run_lengths(code: bytes, summary=None) -> List[tuple]:
    """(start_pc, n_ops) of every maximal fusible run: CFG-block-bounded
    with a static summary, bounded only by non-fusible ops without."""
    cfg = _summary_cfg(summary)
    if cfg is not None:
        out: List[tuple] = []
        for start in sorted(cfg.blocks):
            run_start, count = None, 0
            for ins in cfg.blocks[start].instructions:
                if ins.opcode in _FUSE_NAMES:
                    if run_start is None:
                        run_start, count = ins.address, 0
                    count += 1
                elif run_start is not None:
                    out.append((run_start, count))
                    run_start = None
            if run_start is not None:
                out.append((run_start, count))
        return out
    out = []
    pc, n = 0, len(code)
    start, count = None, 0
    while pc < n:
        op = code[pc]
        if op in _FUSE_BYTES:
            if start is None:
                start, count = pc, 0
            count += 1
        else:
            if start is not None:
                out.append((start, count))
                start = None
        pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    if start is not None:
        out.append((start, count))
    return out


#: fusion profitability floor: the fraction of instructions inside runs
#: of >= 2 fusible ops (every iteration pays the substeps)
FUSE_DENSITY_MIN = 0.25


def fuse_profitable(code: bytes, summary=None) -> bool:
    """The per-contract fusion decision: enough of the instruction
    stream sits in runs of >= 2 fusible ops."""
    cfg = _summary_cfg(summary)
    if cfg is not None:
        total = len(cfg.instructions)
    else:
        pc, n, total = 0, len(code), 0
        while pc < n:
            op = code[pc]
            total += 1
            pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    if not total:
        return False
    fused = sum(
        length
        for _start, length in fuse_run_lengths(code, summary)
        if length >= 2
    )
    return fused / total >= FUSE_DENSITY_MIN


# ---------------------------------------------------------------------------
# the substeps' plain versions (one substep, every lane)
# ---------------------------------------------------------------------------
def _substep_prelude(batch: StateBatch, code: CodeTable, tbl):
    """What every substep reads first: the code window, the opcode, the
    table row and the opcode's metadata row."""
    dev = batch.pc.device
    code_id = batch.code_id.clamp(0, code.ops.shape[0] - 1).long()
    code_len = code.length[code_id]
    pc_safe = batch.pc.clamp(0, code.ops.shape[1] - 33).long()
    code_win = code.ops[code_id[:, None], pc_safe[:, None] + torch.arange(33, device=dev)]
    op = code_win[:, 0].to(torch.int32)
    row = tbl[code_id, batch.pc.clamp(0, tbl.shape[1] - 1).long()].to(torch.int32)
    meta = _meta(dev)[op.long()]
    return code_len, code_win, op, row, meta


def _ok_predicate(batch: StateBatch, live, meta):
    """Lanes that may execute: live, no stack underflow or overflow (or
    model-capacity degrade), and the op's minimum gas affordable in
    uint32 arithmetic that wraps, as in the JAX substeps."""
    stack_cap = batch.stack.shape[1]
    pops, net_sp = meta[:, 2], meta[:, 3]
    return (live & (batch.sp >= pops)
            & (batch.sp + net_sp <= min(stack_cap, 1024))
            & (((batch.gas_min + meta[:, 4]) & M32) <= batch.gas_budget))


def _push_word(code_win, op):
    """The PUSHn immediate from the fetch window (as the full step)."""
    push_n = op - 0x5F
    return u256.lshr(u256.bytes_to_word(code_win[:, 1:]), 8 * (32 - push_n))


def _apply_substep(batch: StateBatch, ok, op, meta, res_val, res_idx, writes,
                   swap_idx, top, track_coverage):
    """Write one substep's effects in place: the SWAP deep slot, then the
    result slot (the result wins a tie, as the JAX nested select), sp,
    pc, gas and the coverage bit. Returns the batch with pc/sp/gas
    replaced."""
    n = batch.pc.shape[0]
    lanes = torch.arange(n, device=batch.pc.device)
    stack = batch.stack
    is_swap = (op >= 0x90) & (op <= 0x9F)
    is_push = (op >= 0x60) & (op <= 0x7F)
    sw = ok & is_swap
    stack[lanes, swap_idx] = torch.where(sw[:, None], top, stack[lanes, swap_idx])
    stack[lanes, res_idx] = torch.where(writes[:, None], res_val, stack[lanes, res_idx])
    sp = torch.where(ok, batch.sp + meta[:, 3], batch.sp)
    pc = torch.where(ok, batch.pc + 1 + torch.where(is_push, op - 0x5F, 0), batch.pc)
    gas_min = (batch.gas_min + torch.where(ok, meta[:, 4], 0)) & M32
    gas_max = (batch.gas_max + torch.where(ok, meta[:, 5], 0)) & M32
    if track_coverage:
        word_idx = (batch.pc // 32).clamp(0, batch.pc_seen.shape[1] - 1).long()
        bit = torch.ones_like(batch.pc) << (batch.pc % 32)
        seen = batch.pc_seen[lanes, word_idx]
        batch.pc_seen[lanes, word_idx] = torch.where(ok, seen | bit, seen)
    return batch._replace(pc=pc, sp=sp, gas_min=gas_min, gas_max=gas_max)


def _peek(batch: StateBatch, ks):
    """Stack slots sp - 1 - k for the [N, K] depths `ks`, clipped."""
    idx = (batch.sp[:, None] - 1 - ks).clamp(0, batch.stack.shape[1] - 1).long()
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return idx, batch.stack[lanes[:, None], idx]


def fused_substep(batch: StateBatch, code: CodeTable, fuse_tbl,
                  track_coverage: bool = True, stack_tid=None):
    """One micro-step over the fusible op set, in place: every RUNNING
    lane whose op the fuse table marks 1 and whose stack and gas cannot
    fault on it. With `stack_tid` (the symbolic shadow) PUSH writes a
    concrete tid and DUP/SWAP move tids as they move values. Returns
    (batch', lanes_executed)."""
    stack_cap = batch.stack.shape[1]
    code_len, code_win, op, row, meta = _substep_prelude(batch, code, fuse_tbl)
    live = (batch.status == Status.RUNNING) & (batch.pc < code_len) & (row == 1)
    ok = _ok_predicate(batch, live, meta)
    is_push = (op >= 0x60) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    dup_n, swap_n = op - 0x80, op - 0x8F
    peek_idx, peeked = _peek(batch, torch.stack([torch.zeros_like(op), dup_n, swap_n], 1))
    top, dup_val, swap_deep = peeked[:, 0], peeked[:, 1], peeked[:, 2]
    res_val = torch.where(is_push[:, None], _push_word(code_win, op),
                          torch.where(is_dup[:, None], dup_val, swap_deep))
    res_idx = torch.where(is_swap, batch.sp - 1, batch.sp).clamp(0, stack_cap - 1).long()
    writes = ok & (is_push | is_dup | is_swap)
    swap_idx = (batch.sp - 1 - swap_n).clamp(0, stack_cap - 1).long()
    if stack_tid is not None:
        lanes = torch.arange(op.shape[0], device=op.device)
        tids = stack_tid[lanes[:, None], peek_idx]
        res_tid = torch.where(is_push, 0, torch.where(is_dup, tids[:, 1], tids[:, 2]))
        # the JAX order: the result slot first, SWAP's deep slot second
        stack_tid[lanes, res_idx] = torch.where(writes, res_tid, stack_tid[lanes, res_idx])
        stack_tid[lanes, swap_idx] = torch.where(ok & is_swap, tids[:, 0],
                                                 stack_tid[lanes, swap_idx])
    out = _apply_substep(batch, ok, op, meta, res_val, res_idx, writes, swap_idx, top,
                         track_coverage)
    return out, ok.to(torch.int64).sum()


def sym_fused_substep(symb, code: CodeTable, fuse_tbl, track_coverage: bool = True):
    """The fused substep with the symbolic-shadow mirror, in place.
    Returns (symb', lanes_executed)."""
    base, n_exec = fused_substep(symb.base, code, fuse_tbl, track_coverage,
                                 stack_tid=symb.stack_tid)
    return symb._replace(base=base), n_exec


# ---------------------------------------------------------------------------
# specialized run loops
# ---------------------------------------------------------------------------
def _heads(b: StateBatch, tbl):
    """Lanes RUNNING at a lowered block's head (the full step consumes
    the head; the substeps count the heads they reach)."""
    from mythril_tpu_torch.laser.batch.blockjit import ROW_HEAD

    code_id = b.code_id.clamp(0, tbl.shape[0] - 1).long()
    row = tbl[code_id, b.pc.clamp(0, tbl.shape[1] - 1).long()]
    return ((b.status == Status.RUNNING) & (row == ROW_HEAD)).sum()


def _spec_run_impl(batch: StateBatch, code: CodeTable, fuse, max_steps: int = 4096,
                   track_coverage: bool = True, phases: Optional[PhaseSet] = None):
    """The concrete specialized loop, in place on `batch`: one pruned
    full step plus the iteration's substeps. Returns (out, full_steps,
    substep_lane_steps, blocks_entered); the two counts are 0-d int64
    tensors on the batch's device."""
    dev = batch.pc.device
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    heads = torch.zeros((), dtype=torch.int64, device=dev)
    block = substep_op.plan(phases)[1]
    b, i = batch, 0
    while i < max_steps and _any_running(b):
        if block:
            heads += _heads(b, fuse)
        b = step(b, code, track_coverage=track_coverage, phases=phases)
        # the iteration's substeps: one launch on the card
        b = substep_op.substep_run(b, code, fuse, phases, counts,
                                   track_coverage=track_coverage)
        i += 1
    return b, i, counts[0], counts[1] + heads


def _spec_sym_run_impl(symb, code: CodeTable, fuse, max_steps: int = 2048,
                       phases: Optional[PhaseSet] = None):
    """The symbolic specialized loop (the explorer's wave), in place on
    `symb`. Returns (out, full_steps, active_lane_steps,
    substep_lane_steps, blocks_entered): `active` keeps the generic
    loop's meaning (lanes RUNNING at each full step); the substep count
    tallies the instructions the substeps advanced on top."""
    from mythril_tpu_torch.laser.batch.symbolic import sym_step

    dev = symb.base.pc.device
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    heads = torch.zeros((), dtype=torch.int64, device=dev)
    active = torch.zeros((), dtype=torch.int64, device=dev)
    block = substep_op.plan(phases)[1]
    s, i = symb, 0
    while i < max_steps and _any_running(s.base):
        active += (s.base.status == Status.RUNNING).sum()
        if block:
            heads += _heads(s.base, fuse)
        s = sym_step(s, code, phases=phases)
        s = s._replace(base=substep_op.substep_run(s.base, code, fuse, phases, counts,
                                                   stack_tid=s.stack_tid))
        i += 1
    return s, i, active, counts[0], counts[1] + heads


# ---------------------------------------------------------------------------
# kernel handles + the cache
# ---------------------------------------------------------------------------
class SpecializedKernel:
    """One specialization bucket's entry points, with first-call timing
    per (entry point, shape)."""

    def __init__(self, phases: PhaseSet) -> None:
        self.phases = phases
        self.refs = 0
        #: in-flight background-warmup pins (KernelCache.pin_warmup)
        self.warm_refs = 0
        self.calls = 0
        self.compile_s = 0.0
        self._warm = set()
        self._run = _spec_run_impl
        self._sym = _spec_sym_run_impl

    @property
    def pruned_phases(self) -> tuple:
        return self.phases.pruned

    @property
    def compiles(self) -> int:
        return len(self._warm)

    def _timed(self, key, fn, *args, **kwargs):
        """The first call per (entry, shape) is timed into compile_s (a
        cold call's wall: nvcc builds and first kernel loads)."""
        self.calls += 1
        if key in self._warm:
            return fn(*args, **kwargs)
        global _COMPILING
        with _CACHE_MU:
            _COMPILING += 1
        t0 = time.perf_counter()
        try:
            from mythril_tpu_torch.support.resilience import inject

            inject("kernel.compile")
            return fn(*args, **kwargs)
        finally:
            t1 = time.perf_counter()
            self.compile_s += t1 - t0
            self._warm.add(key)
            with _CACHE_MU:
                _COMPILING -= 1
            from mythril_tpu_torch.observe.spans import flight_recorder

            flight_recorder().add("kernel.compile", t0, t1, entry=key[0],
                                  pruned=len(self.phases.pruned))

    @staticmethod
    def run_key(batch, code, donate: bool) -> tuple:
        """The warm-cache key of a concrete-run dispatch shape."""
        return ("run", donate, batch.pc.shape[0], batch.mem.shape[1],
                batch.stack.shape[1], tuple(code.ops.shape))

    def is_warm(self, key) -> bool:
        return key in self._warm

    def run(self, batch, code, fuse, max_steps, track_coverage=True, donate=False):
        """(out, full_steps, substep_lane_steps, blocks_entered). `fuse`
        is the block-program table when this bucket's block_depth > 0,
        the fuse table otherwise. `donate` steps `batch` in place."""
        if self._run is None:
            raise RuntimeError("specialized kernel was dropped")
        if not donate:
            batch = StateBatch(*(t.clone() for t in batch))
        return self._timed(self.run_key(batch, code, donate), self._run, batch, code,
                           fuse, max_steps=int(max_steps),
                           track_coverage=bool(track_coverage), phases=self.phases)

    def sym_run(self, symb, code, fuse, max_steps, donate=False):
        """(out, full_steps, active, substep_steps, blocks_entered), the
        explorer's wave entry. `donate` steps `symb` in place."""
        if self._sym is None:
            raise RuntimeError("specialized kernel was dropped")
        from mythril_tpu_torch.laser.batch.symbolic import clone_sym_batch

        if not donate:
            symb = clone_sym_batch(symb)
        base = symb.base
        key = ("sym", donate, base.pc.shape[0], base.mem.shape[1],
               base.stack.shape[1], tuple(code.ops.shape))
        return self._timed(key, self._sym, symb, code, fuse,
                           max_steps=int(max_steps), phases=self.phases)

    def drop(self) -> None:
        """Release the entry points (the cache evicted this entry)."""
        self._run = None
        self._sym = None


_CACHE_MU = threading.Lock()
_COMPILING = 0


class KernelCache:
    """LRU of SpecializedKernel handles keyed by bucket (the PhaseSet).
    Entries pinned with acquire() survive capacity eviction until
    released; releasing the last pin of an evicted entry drops it."""

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = max(1, capacity)
        self._entries: "OrderedDict[PhaseSet, SpecializedKernel]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: entries evicted while a warmup pin held them: the drop is
        #: deferred to release_warmup
        self.inflight_evictions = 0

    def get(self, phases: PhaseSet) -> SpecializedKernel:
        with _CACHE_MU:
            kernel = self._entries.get(phases)
            if kernel is not None:
                self.hits += 1
                self._entries.move_to_end(phases)
                return kernel
            self.misses += 1
        kernel = SpecializedKernel(phases)
        with _CACHE_MU:
            racing = self._entries.get(phases)
            if racing is not None:
                return racing
            self._entries[phases] = kernel
            self._evict_over_capacity()
        return kernel

    def acquire(self, phases: PhaseSet) -> SpecializedKernel:
        kernel = self.get(phases)
        with _CACHE_MU:
            kernel.refs += 1
        return kernel

    def release(self, kernel: Optional[SpecializedKernel]) -> None:
        if kernel is None:
            return
        with _CACHE_MU:
            kernel.refs = max(0, kernel.refs - 1)
            if (
                kernel.refs == 0
                and kernel.warm_refs == 0
                and self._entries.get(kernel.phases) is not kernel
            ):
                kernel.drop()
            else:
                self._evict_over_capacity()

    def pin_warmup(self, kernel: SpecializedKernel) -> SpecializedKernel:
        """Pin `kernel` for a background warmup: capacity pressure may
        still unmap it, but its drop waits for release_warmup."""
        with _CACHE_MU:
            kernel.warm_refs += 1
        return kernel

    def release_warmup(self, kernel: Optional[SpecializedKernel]) -> None:
        """The warmup's release: an entry evicted meanwhile (and pinned
        by nothing else) is dropped here."""
        if kernel is None:
            return
        with _CACHE_MU:
            kernel.warm_refs = max(0, kernel.warm_refs - 1)
            if (
                kernel.warm_refs == 0
                and kernel.refs == 0
                and self._entries.get(kernel.phases) is not kernel
            ):
                kernel.drop()

    def _evict_over_capacity(self) -> None:
        # under _CACHE_MU; pinned entries are skipped, warmup-pinned ones
        # unmapped with their drop deferred
        over = len(self._entries) - self.capacity
        if over <= 0:
            return
        for phases in list(self._entries):
            if over <= 0:
                break
            kernel = self._entries[phases]
            if kernel.refs > 0:
                continue
            del self._entries[phases]
            self.evictions += 1
            over -= 1
            if kernel.warm_refs > 0:
                self.inflight_evictions += 1
            else:
                kernel.drop()

    def stats(self) -> Dict:
        with _CACHE_MU:
            entries = list(self._entries.values())
            return {
                "size": len(entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "inflight_evictions": self.inflight_evictions,
                "pinned": sum(1 for k in entries if k.refs > 0),
                "compiles": sum(k.compiles for k in entries),
                "compiles_in_flight": _COMPILING,
                "compile_s": round(sum(k.compile_s for k in entries), 3),
            }

    def clear(self) -> None:
        with _CACHE_MU:
            for kernel in self._entries.values():
                kernel.drop()
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0
            self.inflight_evictions = 0


_KERNELS = KernelCache()


def kernel_cache() -> KernelCache:
    """The process-wide kernel cache."""
    return _KERNELS


def kernel_cache_stats() -> Dict:
    return _KERNELS.stats()


def clear_kernel_cache() -> None:
    _KERNELS.clear()


def specialize_enabled() -> bool:
    """One switch for every consumer (CLI --no-specialize)."""
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "specialize", True))
