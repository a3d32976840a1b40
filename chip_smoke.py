#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mythril_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels         # device, build, the kernel
                                            # phases and the wrappers' host cost
                                            # (portfolio kernels on the
                                            # solving and synthetic programs)
    python3 chip_smoke.py --ab-host-reads   # device, build, then only the
                                            # A/B of the u256 loops' host read
    python3 chip_smoke.py --ab-windows      # device, build, then only the
                                            # A/B of the wave's memory windows
    python3 chip_smoke.py --ab-portfolio DIR  # the portfolio kernels of the
                                            # checkout in DIR (a parent, unpacked
                                            # with git archive under _archive/;
                                            # any other DIR is refused) against
                                            # this one's, at the flip's shapes,
                                            # in the order DIR, this, this, DIR

Phases, each followed by torch.cuda.synchronize(); any failure exits
non-zero (nothing is caught):

1. device: require CUDA; print the card's name and power limit, the
   host's CPU model and the host's dispatch time per trivial CUDA launch
   (median of 1000), which sets the pace of a host-bound step;
2. build: compile every csrc/*.cu with nvcc for sm_90a, one nvcc per
   source, all started together (seconds and ptxas report printed);
3. kernels, each held bit for bit against its plain PyTorch version on
   the same tensors, then timed (CUDA events around a CUDA-graph replay
   of 50 launches, median of 25) beside its bound and its plain
   version's time (eager calls):
   - keccak_f1600 on 16384 seeded random states; keccak256 of b"" and of
     a 64-byte mapping key on the card equal to the pure-Python oracle;
     the compiled kernel's SASS instruction count, and its time at 4x
     and 16x the main path's n;
   - keccak_sponge on 16384 lanes of 4096 B: random lengths 0-1087 at
     unaligned offsets, windows ending at the row's end, length 0 at an
     offset far past the row or negative, a quarter of `ok` off; eight
     lanes against the oracle; timed at the main path's two SHA3 shapes
     (64 B, one block; 320 B, three blocks; every lane ok) and on the
     random lengths;
   - slot_write on seeded [16384, 128, 16] int32 stacks with a quarter of
     the masks off, on [16384, 12] int64 and [16384, 64] uint8 buffers,
     with two writes per lane on one slot and with out-of-range indices;
     its time, bound, plain time and `Tensor.scatter_`'s with every mask
     set (where scatter_ computes the same function), and its time and
     bound with a quarter of the masks off. Then slot_write_many on
     seven mixed uint8/int32/int64 tables, on the symbolic step's 8
     evidence banks and on the storage journal's keys and values, the
     last two then timed against one single-table launch per table;
   - host: microseconds per eager call of each wrapper (no synchronize
     inside the timed calls);
4. main path: after one cold loop iteration (42 steps, timed apart),
   16384 lanes x 256 steps of the demo loop (calldata ->
   arithmetic -> storage -> loop) extended with a Solidity mapping-slot
   hash (SHA3 over 64 bytes, SLOAD/SSTORE of that slot) and a 3-block
   SHA3 over 320 bytes of calldata copied to memory, through
   make_code_table / make_batch / run on the card. The path must have
   launched keccak_sponge, slot_write and slot_write_many, sampled
   lanes' storage must equal values computed in Python with the port's
   keccak oracle, and the first 128 lanes must equal, field by field, a
   device="cpu" run of those lanes;
5. symbolic wave: the JAX explorer's first wave at its defaults, 16384
   lanes as 512 stripes of 32 over the 13 vendored contracts
   (laser/symbolic_wave.py), through sym_run for up to 512 steps after a
   cold pass of 64 steps timed apart: wall, ms/step, active lane-steps/s,
   host syncs/step, the kernels' launches, arena fill, banked events,
   the ArenaView readback and a 32-step profile; an untimed rerun, which
   must give the same result, counts the lanes that overflowed the
   arena; then reseed_wave_inplace into a second wave, which must equal
   a fresh batch of the same seeds, and run it;
6. symbolic parity: the pinned 260-lane wave on the card must hash, field
   by field, to the JAX package's digests
   (mythril_tpu_torch/laser/symbolic_wave_digests.json), its flip
   frontier decoded on the card (candidates, path conditions, lowered
   queries) must equal the JAX package's canonical digests
   (mythril_tpu_torch/laser/flip_frontier_pinned.json), and a 128-lane
   wave on the card must equal a device="cpu" run, every field;
7. flip frontier (laser/flip_frontier.py): the explorer's geometry, 13
   contracts x 32 lanes, 68 B calldata, for 4 generations, each sym_run,
   ArenaView, decode and candidates, lower and compile, one
   device_solve_batch dispatch on the card (portfolio_eval for
   enumeration and the cube fan's ranking, portfolio_sls for the search)
   and the next wave seeded with the witnesses; per generation the
   candidates, opaque ones, compile losses, verdicts by mode, witnesses
   that failed validation (any fails the run), flips realized in the
   next generation, the stages' ms and the kernels' launches. Then the
   frontier of phase 5's 16384-lane wave in one dispatch;
8. portfolio kernels: portfolio_eval and portfolio_sls on the frontier's
   own programs (the search also on the cube fan's), on queries the
   search solves (before the first step and mid-search) and on
   synthetic ones at 32 to 2048 bits (every op, L = 16 to 128), each
   against its plain version run on CPU copies of the same inputs (bit
   for bit; portfolio_sls at a 16-step budget, at which its
   counter-based random streams agree step by step, also with the Luby
   restart unit lowered to 2 and 4 so that lanes restart), every check
   under the launch plan's own choice, with the global variant forced
   and (the search) with each cluster size forced, each plan logged and
   its shared bytes held to the kernel's own layout; timed (device time
   from torch.profiler; "not measured" where it saw no kernel, and the
   run fails if that is a kernels-line shape) beside the bound the plain
   version's operation count gives and the plain version's time, also
   at the flip's own shapes (the first pass and the cube fan, K = 64,
   192 steps; rank_impact_vars' batch) and at Q = 128 queries;
   registers and spills from ptxas;
9. VMTests: every vendored suite through run_cases(hybrid=False) on the
   card, name by name against the JAX package's pinned verdicts
   (mythril_tpu_torch/laser/vmtests_device_verdicts.json), with no
   mismatch and no "fail:";
10. report: the `kernels` JSON line, then the result line.

After 4 it also prints where a main-path step's time goes
(torch.profiler: CUDA kernels per step, device busy share, top kernels)
and the times of the bit-serial u256 loops (DIV/SDIV/MOD/SMOD,
ADDMOD/MULMOD, EXP) at full width.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

LANES = 16384
STEPS = 256
CPU_LANES = 128
CALLDATA_BYTES = 320  # 3 keccak rate blocks once padded
SAMPLE_LANES = (0, 1, 77, 4097, 9999, 16383)
LOOP_STEPS = 42  # one iteration of the main path's loop: every handler it runs
AB_MAIN_REPS = 3  # main-path runs per variant visit in --ab-host-reads
GRAPH_LAUNCHES = 50  # kernel launches per timed CUDA-graph replay
VM_MAX_STEPS = 4096
VM_STRAGGLER_STEPS = 0
SLOT_CAP, SLOT_W = 128, 16  # the main path's stack: [LANES, 128, 16] int32
WAVE_STRIPES, WAVE_LANES_PER_STRIPE = 512, 32  # the explorer's 16384 lanes
WAVE_MAX_STEPS = 512
WAVE_COLD_STEPS = 64
WAVE_PROFILE_STEPS = 32
PARITY_STRIPES = 4  # a 128-lane wave on the card against the CPU
SLS_CHECK_STEPS = 16  # the step budget at which portfolio_sls is held to its plain version
SLS_CHECK_K = (64, 320, 512)  # candidates per SLS check: the explorer's, and past one a thread
EVAL_CHECK_K = (16, 256)  # candidates per portfolio_eval check (16: rank_impact_vars' probes)
RANK_PROBES = 16  # rank_impact_vars' probe batch: it scores (V + 1) batches in one call
RESTART_BASES = (2, 4)  # the restart-forcing checks' Luby unit (the default is 24)
FLIP_STEPS = 192  # device_solve_batch's first pass (PORTFOLIO_DEFAULTS first_pass_steps)
OCCUPANCY_Q = 128  # queries of the timed occupancy run
ENUM_K = 4096  # device_enumerate's chunk: portfolio_eval's timed shape

# H100 SXM peaks (NVIDIA data sheet; the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
# INT32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s
# float32 figure is 128 lanes x 2 for FMA at the same clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SPONGE_RATE, SPONGE_MAX_BLOCKS = 136, 8  # ops/keccak.py: bytes per block, blocks
MEM_CAP = 4096  # the main path's memory per lane (state.py default)
# keccak-f per message, in 32-bit ALU instructions with 3-input LOP3
# (see csrc/keccak_f.cu): per round theta 20 + 10 + 50, rho 48, chi 50;
# iota 37 over the 24 rounds
KECCAK_OPS_PER_MSG = 24 * (20 + 10 + 50 + 48 + 50) + 37


def log(msg):
    print(msg, flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def program():
    """The main path's contract: (instruction list, bytecode)."""
    from mythril_tpu_torch.support.opcodes import OPCODES

    body = [
        ("JUMPDEST",),
        ("PUSH1", 0x00), ("CALLDATALOAD",), ("PUSH1", 3), ("MUL",),
        ("PUSH1", 7), ("ADD",), ("PUSH1", 0x00), ("SSTORE",),  # s[0] = cd0*3+7
        ("PUSH1", 0x00), ("SLOAD",), ("CALLER",), ("EQ",), ("POP",),
        ("TIMESTAMP",), ("POP",),
        # Solidity mapping slot: h = keccak(caller . uint256(1)); s[h] += 1
        ("CALLER",), ("PUSH1", 0x00), ("MSTORE",),
        ("PUSH1", 0x01), ("PUSH1", 0x20), ("MSTORE",),
        ("PUSH1", 0x40), ("PUSH1", 0x00), ("SHA3",),
        ("DUP1",), ("SLOAD",), ("PUSH1", 0x01), ("ADD",), ("SWAP1",), ("SSTORE",),
        # multi-block SHA3: calldata -> memory[0x40:], s[2] = keccak(calldata)
        ("CALLDATASIZE",), ("PUSH1", 0x00), ("PUSH1", 0x40), ("CALLDATACOPY",),
        ("CALLDATASIZE",), ("PUSH1", 0x40), ("SHA3",), ("PUSH1", 0x02), ("SSTORE",),
        ("PUSH1", 0x00), ("JUMP",),
    ]
    code = bytearray()
    for ins in body:
        code.append(OPCODES[ins[0]][0])
        if len(ins) > 1:
            code.append(ins[1])
    return body, bytes(code)


def expected_storage(body, calldata: bytes, caller: int, steps: int) -> dict:
    """Storage after `steps` lock-step instructions, from the program
    text and the Python keccak oracle."""
    from mythril_tpu_torch.support.keccak import keccak256_int

    sstores = [j for j, ins in enumerate(body) if ins[0] == "SSTORE"]
    runs = {j: max(0, (steps - j + len(body) - 1) // len(body)) for j in sstores}
    mod = 1 << 256
    slot_h = keccak256_int(caller.to_bytes(32, "big") + (1).to_bytes(32, "big"))
    out = {}
    if runs[sstores[0]]:
        out[0] = (int.from_bytes(calldata[:32], "big") * 3 + 7) % mod
    if runs[sstores[1]]:
        out[slot_h] = runs[sstores[1]]
    if runs[sstores[2]]:
        out[2] = keccak256_int(calldata)
    return {k: v for k, v in out.items() if v}


def time_cuda(fn, reps):
    """Median milliseconds of `reps` calls, each between CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, kernel, reps):
    """(device ms, call ms) of one call of `fn`: the mean device time of
    the CUDA kernels whose name holds `kernel`, from torch.profiler around
    `reps` calls (a second profile where the first saw none of them; None
    where neither did), and the median time between CUDA events around
    one call, which also holds the wrapper's host work. The second is
    never a stand-in for the first."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: the card's clocks rise under load
    call = time_cuda(fn, reps)
    for _ in range(2):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA" and kernel in e.name]
        if us:
            return sum(us) / reps / 1e3, call
    return None, call


def ms_text(ms):
    """A kernel time for the log: 4 decimals, or why there is none."""
    return "not measured (the profiler saw no kernel)" if ms is None else f"{ms:.4f} ms"


def sm_clocks() -> str:
    """The card's SM clock against its most, its power draw and its
    temperature, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def host_cpu() -> str:
    """The host's CPU model and core count, from /proc/cpuinfo (its
    vendor, family and model numbers where it names no model)."""
    fields = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    model = fields.get("model name", "unknown").removeprefix("unknown") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
        if k in fields) or "not named in /proc/cpuinfo"
    return f"{model}, {os.cpu_count()} cores"


def dispatch_us() -> float:
    """Host microseconds per launch of a trivial CUDA op (an in-place add
    on one element), median of 1000: what a host-bound step pays per
    kernel on this host."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    sync()
    times = []
    for _ in range(1000):
        t0 = time.perf_counter()
        x.add_(1)
        times.append(time.perf_counter() - t0)
    sync()
    return statistics.median(times) * 1e6


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    DISPATCH_US[0] = dispatch_us()
    log(f"[device] host CPU {host_cpu()}; dispatch {DISPATCH_US[0]:.2f} us per trivial "
        f"CUDA launch (median of 1000)")
    return name, card.splitlines()[0]


BUILD_REPORTS = {}  # csrc stem -> nvcc's output (ptxas -v)


def phase_build():
    from mythril_tpu_torch.native import build

    t0 = time.perf_counter()
    built = build.build(verbose=True)
    for stem, (secs, report) in built.items():
        BUILD_REPORTS[stem] = report
        table = ptxas_table(report)
        log(f"[build] csrc/{stem}.cu: done by {secs:.2f} s; ptxas (registers, spill bytes): "
            f"{table or report or 'no report'}")
        if any(spill for _, spill in table.values()):
            # the spilling functions' own lines: stack frame, spills, registers
            lines = report.splitlines()
            for i, line in enumerate(lines):
                if "Function properties" in line:
                    block = lines[i:i + 3]
                    if any(re.search(r"[1-9]\d* bytes spill", b) for b in block):
                        log("[build]   " + " | ".join(b.strip() for b in block))
    log(f"[build] nvcc {build.nvcc()}: {len(built)} sources in parallel, "
        f"{time.perf_counter() - t0:.2f} s wall")


def sass_histogram(kernel="keccak_f1600_kernel"):
    """One built kernel's SASS instructions by opcode (NOPs left out),
    from cuobjdump; the permutation is straight-line code, so outside the
    tile copy's short loops this is what every thread issues. None where
    the toolkit has no cuobjdump."""
    from mythril_tpu_torch.native import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path("keccak_f"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    sass = next((part for part in sass.split("Function : ")[1:]
                 if part.split(None, 1)[0].find(kernel) >= 0), "")
    counts = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
                         sass):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    counts.pop("NOP", None)
    return counts or None


def graph_ms(fn):
    """Device ms of one call of `fn`: a CUDA graph of GRAPH_LAUNCHES
    calls replays them back to back (median of 25 replays)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    return time_cuda(graph.replay, 25) / GRAPH_LAUNCHES


def keccak_bounds(n):
    """(bytes ms, operations ms): the least time n permutations take."""
    return (2 * 200 * n / HBM_BYTES_PER_S * 1e3,
            KECCAK_OPS_PER_MSG * n / INT32_OPS_PER_S * 1e3)


def phase_kernel(card):
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import keccak as plain
    from mythril_tpu_torch.ops import keccak_cuda
    from mythril_tpu_torch.support import keccak as oracle

    rng = np.random.default_rng(0)
    states = torch.tensor(
        rng.integers(0, 2**64, (LANES, 25), dtype=np.uint64).view(np.int64),
        device="cuda")
    got = keccak_cuda.keccak_f(states)
    want = plain.keccak_f(states)
    sync()
    mismatches = int((got != want).sum())
    max_abs_err = 0
    if mismatches:
        bad = (got != want).nonzero()[:16].tolist()
        max_abs_err = max(abs(int(got[i, j]) - int(want[i, j])) for i, j in bad)
    log(f"[kernel] keccak_f1600 on {LANES} states: {mismatches} mismatching lanes")
    if mismatches:
        raise SystemExit("keccak_f1600 disagrees with its plain version")

    mapping_key = (0xDEADBEEFDEADBEEF).to_bytes(32, "big") + (1).to_bytes(32, "big")
    before = keccak_cuda.LAUNCHES
    for msg in (b"", mapping_key):
        digest = plain.keccak256(msg).cpu().numpy().tobytes()
        if digest != oracle.keccak256(msg):
            raise SystemExit(f"keccak256({msg.hex()}) on the card disagrees")
    sync()
    entry_launches = keccak_cuda.LAUNCHES - before
    if entry_launches == 0:
        raise SystemExit("keccak256 never launched keccak_f1600")
    log(f"[kernel] keccak256(b'') and keccak256(mapping key) equal the oracle "
        f"({entry_launches} keccak_f1600 launches)")

    for _ in range(3):
        keccak_cuda.keccak_f(states)
    # one eager call includes the host's launch latency, which is longer
    # than the kernel; graph_ms gives the kernel's own device time
    call_ms = time_cuda(lambda: keccak_cuda.keccak_f(states), 25)
    kernel_ms = graph_ms(lambda: keccak_cuda.keccak_f(states))
    plain.keccak_f(states)
    plain_ms = time_cuda(lambda: plain.keccak_f(states), 25)
    bytes_ms, ops_ms = keccak_bounds(LANES)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"[kernel] n={LANES}: kernel {kernel_ms:.4f} ms (graph replay; one eager call "
        f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} ms, "
        f"int32 ops {ops_ms:.4f} ms) on {card}")
    sass = sass_histogram()
    if sass is None:
        log("[kernel] SASS instruction count: not measured (no cuobjdump)")
    else:
        top = sorted(sass.items(), key=lambda kv: -kv[1])
        log(f"[kernel] SASS: {sum(sass.values())} instructions per message "
            f"({KECCAK_OPS_PER_MSG} ALU instructions needed): "
            + ", ".join(f"{k} {v}" for k, v in top))
    # the main path's n gives each SM ~4 warps; larger n shows how far
    # the gap to the bound is occupancy
    scaling = {}
    for n in (4 * LANES, 16 * LANES):
        big = torch.tensor(
            rng.integers(0, 2**64, (n, 25), dtype=np.uint64).view(np.int64),
            device="cuda")
        scaling[n] = (graph_ms(lambda: keccak_cuda.keccak_f(big)), max(keccak_bounds(n)))
        del big
    log(f"[kernel] scaling: " + "; ".join(
        f"n={n}: {ms:.4f} ms, bound {bound:.4f} ms, {ms / bound:.2f}x bound"
        for n, (ms, bound) in scaling.items()) + f" on {card}")
    big_ms, big_bound = scaling[16 * LANES]
    return dict(mismatches=mismatches, max_abs_err=max_abs_err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                n16x_ms=big_ms, n16x_bound_ms=big_bound, launches_keccak256=entry_launches)


def sponge_bounds(length, ok):
    """(bytes ms, operations ms): the least time the sponge takes on these
    lengths (host numpy): 4309 operations per absorbed block of an ok
    lane, against each hashed byte read once, off, length and ok read
    for every lane (9 B) and a 64 B word written per ok lane."""
    import numpy as np

    hashed = length[ok & (length >= 0) & (length < SPONGE_RATE * SPONGE_MAX_BLOCKS)]
    blocks = int(((hashed.astype(np.int64) + SPONGE_RATE) // SPONGE_RATE).sum())
    nbytes = int(hashed.sum()) + 9 * length.shape[0] + 64 * int(ok.sum())
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            KECCAK_OPS_PER_MSG * blocks / INT32_OPS_PER_S * 1e3)


def sponge_inputs(rng, n, cap):
    """The equality case: random lengths 0-1087 at random (unaligned)
    offsets, an eighth of the windows ending at `cap`, lanes of length 0
    at an offset far past `cap` or negative, a few lengths the step never
    hashes (1088, -1), and a quarter of `ok` off. Host numpy arrays."""
    import numpy as np

    length = rng.integers(0, SPONGE_RATE * SPONGE_MAX_BLOCKS, n).astype(np.int32)
    off = (rng.random(n) * (cap - length + 1)).astype(np.int32)
    kind = rng.integers(0, 64, n)
    off = np.where(kind < 8, cap - length, off)
    length = np.where((kind == 8) | (kind == 9), 0, length)
    off = np.where(kind == 8, 1 << 29, np.where(kind == 9, -(1 << 31), off))
    length = np.where(kind == 10, SPONGE_RATE * SPONGE_MAX_BLOCKS,
                      np.where(kind == 11, -1, length))
    ok = rng.random(n) > 0.25
    return off.astype(np.int32), length.astype(np.int32), ok


def phase_sponge(card):
    """keccak_sponge against its plain version and the oracle on the
    card, then its time at the main path's two SHA3 shapes."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import keccak as plain
    from mythril_tpu_torch.ops import keccak_cuda
    from mythril_tpu_torch.support.keccak import keccak256_int

    rng = np.random.default_rng(4)
    n, cap = LANES, MEM_CAP
    mem_host = rng.integers(0, 256, (n, cap), dtype=np.uint8)
    mem = torch.tensor(mem_host, device="cuda")
    off_h, len_h, ok_h = sponge_inputs(rng, n, cap)
    off, length, ok = (torch.tensor(x, device="cuda") for x in (off_h, len_h, ok_h))
    got = keccak_cuda.keccak_sponge(mem, off, length, ok)
    want = plain.keccak_sponge_plain(mem, off, length, ok)
    sync()
    mismatches = int((got != want).sum())
    max_abs_err = int((got.long() - want.long()).abs().max()) if mismatches else 0
    log(f"[sponge] keccak_sponge on {n} lanes of {cap} B (lengths 0-1087, unaligned "
        f"offsets, windows ending at the row's end, length 0 far past it or negative, "
        f"{int((~ok).sum())} lanes not ok): {mismatches} mismatching limbs")
    if mismatches:
        raise SystemExit("keccak_sponge disagrees with its plain version")
    host = got.cpu().numpy()
    checked = 0
    for lane in np.flatnonzero(ok_h & (len_h >= 0) & (len_h < SPONGE_RATE * SPONGE_MAX_BLOCKS))[:8]:
        start = min(max(int(off_h[lane]), 0), cap)
        data = mem_host[lane, start:start + int(len_h[lane])].tobytes()
        word = sum(int(v) << (16 * k) for k, v in enumerate(host[lane].tolist()))
        if word != keccak256_int(data):
            raise SystemExit(f"keccak_sponge lane {lane}: digest differs from the oracle")
        checked += 1
    if (host[~ok_h] != 0).any():
        raise SystemExit("keccak_sponge wrote a digest where ok is off")
    log(f"[sponge] {checked} lanes equal the Python oracle; lanes outside ok are zero")
    rand_ms = graph_ms(lambda: keccak_cuda.keccak_sponge(mem, off, length, ok))
    rand_bytes_ms, rand_ops_ms = sponge_bounds(len_h, ok_h)

    # the main path's two SHA3 shapes, every lane ok: the 64 B
    # mapping-slot hash at 0 and the 320 B calldata hash at 0x40
    shapes = {}
    every = torch.ones(n, dtype=torch.bool, device="cuda")
    for blocks, (at, nbytes) in ((1, (0, 64)), (3, (0x40, CALLDATA_BYTES))):
        o = torch.full((n,), at, dtype=torch.int32, device="cuda")
        ln = torch.full((n,), nbytes, dtype=torch.int32, device="cuda")
        if not torch.equal(keccak_cuda.keccak_sponge(mem, o, ln, every),
                           plain.keccak_sponge_plain(mem, o, ln, every)):
            raise SystemExit(f"keccak_sponge disagrees at the {blocks}-block shape")
        ms = graph_ms(lambda: keccak_cuda.keccak_sponge(mem, o, ln, every))
        plain_ms = time_cuda(lambda: plain.keccak_sponge_plain(mem, o, ln, every), 5)
        bytes_ms, ops_ms = sponge_bounds(np.full(n, nbytes, np.int32), np.ones(n, bool))
        bound_ms = max(bytes_ms, ops_ms)
        shapes[blocks] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        log(f"[sponge] {blocks} block(s), {nbytes} B at {at} on {n} lanes: kernel "
            f"{ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"by {shapes[blocks]['bound_by']} (bytes {bytes_ms:.4f}, int32 ops "
            f"{ops_ms:.4f}), {ms / bound_ms:.2f}x bound on {card}")
    rand_bound = max(rand_bytes_ms, rand_ops_ms)
    log(f"[sponge] the equality case (random lengths): kernel {rand_ms:.4f} ms, bound "
        f"{rand_bound:.4f} ms by operations (bytes {rand_bytes_ms:.4f}), "
        f"{rand_ms / rand_bound:.2f}x bound on {card}")
    main = shapes[3]
    return dict(mismatches=mismatches, max_abs_err=max_abs_err, kernel_ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                one_block_ms=shapes[1]["ms"], one_block_plain_ms=shapes[1]["plain_ms"],
                one_block_bound_ms=shapes[1]["bound_ms"], random_lengths_ms=rand_ms,
                random_lengths_bound_ms=rand_bound)


def slot_bound_ms(n, written, w, elem_bytes):
    """The least time one slot write takes: read every lane's index (8 B)
    and mask (1 B), and for each of the `written` lanes whose mask is set
    read its value row and write its row, at the card's memory rate."""
    return (n * (8 + 1) + 2 * written * w * elem_bytes) / HBM_BYTES_PER_S * 1e3


def phase_slot_write(card):
    """slot_write against its plain version on the card, then its time."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import slot_write as sw

    rng = np.random.default_rng(3)
    n = LANES

    def rand(shape, dtype):
        info = np.iinfo(dtype)
        return torch.tensor(rng.integers(info.min, info.max, shape, dtype=dtype,
                                         endpoint=True), device="cuda")

    def write(s_cap, row, dtype, lo=0, hi=None):
        hi = s_cap if hi is None else hi
        return (torch.tensor(rng.integers(lo, hi, n), device="cuda"),
                torch.tensor(rng.random(n) > 0.25, device="cuda"),
                rand((n,) + row, dtype))

    stack_write = write(SLOT_CAP, (SLOT_W,), np.int32)
    second = list(write(SLOT_CAP, (SLOT_W,), np.int32))
    same = torch.tensor(rng.random(n) > 0.5, device="cuda")
    second[0] = torch.where(same, stack_write[0], second[0])
    stack_label = f"[{n}, {SLOT_CAP}, {SLOT_W}] int32 stack"
    cases = {
        stack_label: (rand((n, SLOT_CAP, SLOT_W), np.int32), stack_write),
        f"[{n}, 12] int64": (rand((n, 12), np.int64), write(12, (), np.int64)),
        f"[{n}, 64] uint8": (rand((n, 64), np.uint8), write(64, (), np.uint8)),
        "two writes per lane, half on one slot": (
            rand((n, SLOT_CAP, SLOT_W), np.int32), stack_write + tuple(second)),
        "indices out of range": (rand((n, SLOT_CAP), np.int32),
                                 write(SLOT_CAP, (), np.int32, -3, SLOT_CAP + 3)),
    }
    mismatches = 0
    max_abs_err = 0
    for label, (buf, args) in cases.items():
        got, want = buf.clone(), buf.clone()
        sw.slot_write(got, *args)
        sw.slot_write_plain(want, *args)
        sync()
        bad = int((got != want).sum())
        if bad:
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
            max_abs_err = max(max_abs_err, int(diff.max()))
        mismatches += bad
        log(f"[slot_write] {label}: {bad} mismatching elements")
    if mismatches:
        raise SystemExit("slot_write disagrees with its plain version")

    # timed with every mask set, where Tensor.scatter_ along the slot axis
    # computes the same function, so that the kernel, its plain version,
    # the library call and the bound share one input; then with the
    # quarter of the masks off of the equality case
    buf = cases[stack_label][0]
    idx, mask, val = stack_write
    every = torch.ones_like(mask)
    idx3 = idx[:, None, None].expand(n, 1, SLOT_W)
    val3 = val[:, None, :]
    lib_out, ker_out = buf.clone(), buf.clone()
    lib_out.scatter_(1, idx3, val3)
    sw.slot_write(ker_out, idx, every, val)
    sync()
    if not torch.equal(lib_out, ker_out):
        raise SystemExit("scatter_ and slot_write disagree with every mask set")
    del lib_out, ker_out
    kernel_ms = graph_ms(lambda: sw.slot_write(buf, idx, every, val))
    library_ms = graph_ms(lambda: buf.scatter_(1, idx3, val3))
    sw.slot_write_plain(buf, idx, every, val)
    plain_ms = time_cuda(lambda: sw.slot_write_plain(buf, idx, every, val), 25)
    bound_ms = slot_bound_ms(n, n, SLOT_W, 4)
    written = int(mask.sum())
    part_ms = graph_ms(lambda: sw.slot_write(buf, idx, mask, val))
    part_bound_ms = slot_bound_ms(n, written, SLOT_W, 4)
    two_ms = graph_ms(lambda: sw.slot_write(buf, *stack_write, *second))
    log(f"[slot_write] n={n}, [{n}, {SLOT_CAP}, {SLOT_W}] int32, every mask set: kernel "
        f"{kernel_ms:.4f} ms (graph replay), plain {plain_ms:.4f} ms, Tensor.scatter_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes; {written} lanes write: "
        f"kernel {part_ms:.4f} ms, bound {part_bound_ms:.4f} ms; two writes "
        f"{two_ms:.4f} ms on {card}")
    many = phase_slot_write_many(card, rng, rand)
    return dict(mismatches=mismatches + many.pop("mismatches"),
                max_abs_err=max(max_abs_err, many.pop("max_abs_err")), kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms, quarter_masks_off_ms=part_ms,
                quarter_masks_off_bound_ms=part_bound_ms, two_writes_ms=two_ms, **many)


def bank_tables(n, make, cap=12):
    """The symbolic step's 8 evidence banks (symbolic.py): [n, 12] int32
    pc, kind, tid, vtid and aux, [n, 12, 16] int32 a and b, [n, 12] int64
    gas, each with a value of its row's shape; make(shape, numpy dtype)
    gives a tensor."""
    import numpy as np

    shapes = [((), np.int32)] * 4 + [((SLOT_W,), np.int32)] * 2 + [((), np.int32),
                                                                    ((), np.int64)]
    return [(make((n, cap) + row, dt), make((n,) + row, dt)) for row, dt in shapes]


def phase_slot_write_many(card, rng, rand):
    """slot_write_many against its plain version on mixed tables and on
    the evidence banks and the storage journal's keys and values, then its
    time on the last two, against one single-table launch per table (the
    old way)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import slot_write as sw

    n = LANES
    idx = torch.tensor(rng.integers(-3, 15, n), device="cuda")
    mask = torch.tensor(rng.random(n) > 0.25, device="cuda")
    gathered = rand((n, 5, 3), np.int32)
    mixed = [(rand((n, 12), np.int32), rand((n,), np.int32)),
             (rand((n, 12, SLOT_W), np.int32), rand((n, SLOT_W), np.int32)),
             (rand((n, 12), np.int64), rand((n,), np.int64)),
             (rand((n, 64), np.uint8), rand((n,), np.uint8)),
             (rand((n, 12, 8), np.uint8), rand((n, 8), np.uint8)),
             (rand((n, 7, 3), np.int32), gathered[:, 2]),
             (rand((n, 12, 5), np.int32), gathered[:, :, 1])]
    got = [(b.clone(), v) for b, v in mixed]
    want = [(b.clone(), v) for b, v in mixed]
    sw.slot_write_many(idx, mask, got)
    sw.slot_write_many_plain(idx, mask, want)
    sync()
    mismatches, max_abs_err = 0, 0
    for (g, _), (w, _) in zip(got, want):
        bad = int((g != w).sum())
        if bad:
            max_abs_err = max(max_abs_err, int((g.long() - w.long()).abs().max()))
        mismatches += bad
    log(f"[slot_write_many] {len(mixed)} tables (int32, int64, uint8; rows of 1, 3, 8 "
        f"and 16 elements, strided values; indices -3..14 against 7, 12 and 64 slots, "
        f"a quarter of the masks off): "
        f"{mismatches} mismatching elements")
    if mismatches:
        raise SystemExit("slot_write_many disagrees with its plain version")

    every = torch.ones(n, dtype=torch.bool, device="cuda")
    out = {}
    shapes = {
        "banks": (bank_tables(n, rand), torch.tensor(rng.integers(0, 12, n), device="cuda")),
        "skeys_svals": ([(rand((n, 64, SLOT_W), np.int32), rand((n, SLOT_W), np.int32))
                         for _ in range(2)],
                        torch.tensor(rng.integers(0, 64, n), device="cuda")),
    }
    for label, (tables, slot) in shapes.items():
        got = [(b.clone(), v) for b, v in tables]
        want = [(b.clone(), v) for b, v in tables]
        sw.slot_write_many(slot, every, got)
        sw.slot_write_many_plain(slot, every, want)
        sync()
        bad = sum(int((g != w).sum()) for (g, _), (w, _) in zip(got, want))
        if bad:
            max_abs_err = max(max_abs_err, max(int((g.long() - w.long()).abs().max())
                                               for (g, _), (w, _) in zip(got, want)))
        mismatches += bad
        del got, want
        log(f"[slot_write_many] {label}, {len(tables)} tables: {bad} mismatching elements")
        if bad:
            raise SystemExit(f"slot_write_many disagrees with its plain version on {label}")
        many_ms = graph_ms(lambda: sw.slot_write_many(slot, every, tables))

        def separate():
            for buf, val in tables:
                sw.slot_write(buf, slot, every, val)

        separate_ms = graph_ms(separate)
        sw.slot_write_many_plain(slot, every, tables)
        plain_ms = time_cuda(lambda: sw.slot_write_many_plain(slot, every, tables), 25)
        nbytes = n * 9 + sum(2 * n * b[0, 0].numel() * b.element_size() for b, _ in tables)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[label] = dict(ms=many_ms, separate_ms=separate_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, tables=len(tables))
        log(f"[slot_write_many] {label}, {len(tables)} tables, every mask set: one launch "
            f"{many_ms:.4f} ms ({many_ms / len(tables):.4f} ms per table), one launch per "
            f"table {separate_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"by bytes ({nbytes} B), {many_ms / bound_ms:.2f}x bound on {card}")
    return dict(mismatches=mismatches, max_abs_err=max_abs_err,
                **{f"many_{label}_{k}": v for label, r in out.items() for k, v in r.items()})


def host_cost_us(card):
    """Host microseconds per eager call of each kernel wrapper on the main
    path's shapes, with no synchronize inside the timed calls: median of
    200 calls after 20 warm ones."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import keccak_cuda
    from mythril_tpu_torch.ops import slot_write as sw

    n = LANES
    rng = np.random.default_rng(5)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=getattr(torch, np.dtype(dtype).name), device="cuda")

    stack = zeros((n, SLOT_CAP, SLOT_W), np.int32)
    idx = torch.tensor(rng.integers(0, SLOT_CAP, n), device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    val = zeros((n, SLOT_W), np.int32)
    states = zeros((n, 25), np.int64)
    banks =bank_tables(n, zeros)
    slot = idx.remainder(12)
    mem = zeros((n, MEM_CAP), np.uint8)
    off = torch.zeros(n, dtype=torch.int32, device="cuda")
    ln = torch.full((n,), 64, dtype=torch.int32, device="cuda")
    calls = {
        "slot_write": lambda: sw.slot_write(stack, idx, mask, val),
        "slot_write, two writes": lambda: sw.slot_write(stack, idx, mask, val, idx, mask, val),
        "slot_write_many, 8 banks": lambda: sw.slot_write_many(slot, mask, banks),
        "keccak_f1600": lambda: keccak_cuda.keccak_f(states),
        "keccak_sponge": lambda: keccak_cuda.keccak_sponge(mem, off, ln, mask),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        sync()
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        sync()
        out[name] = statistics.median(times) * 1e6
    log(f"[host] us per eager call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()) + f" on {card}")
    return out


def phase_main_path(card):
    import numpy as np
    import torch

    from mythril_tpu_torch.interop import batch_to_numpy
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.laser.batch.state import Status, storage_dict
    from mythril_tpu_torch.support import hostsync

    body, code = program()
    rng = np.random.default_rng(1)
    calldata = [rng.integers(0, 256, CALLDATA_BYTES, dtype=np.uint8).tobytes()
                for _ in range(LANES)]
    table = make_code_table([code])
    batch = make_batch(LANES, calldata=calldata)
    # cold: the first steps pay the allocator's growth and each CUDA
    # kernel's first load; the measured run starts warm
    t0 = time.perf_counter()
    run(batch, table, max_steps=LOOP_STEPS)
    sync()
    cold_ms = (time.perf_counter() - t0) / LOOP_STEPS * 1e3
    log(f"[main] cold: first {LOOP_STEPS} steps {cold_ms:.3f} ms/step on {card}")

    reset_launches()
    hostsync.COUNT = 0
    t0 = time.perf_counter()
    final, steps = run(batch, table, max_steps=STEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    syncs = hostsync.COUNT
    log(f"[main] {LANES} lanes x {steps} steps: {wall:.3f} s, "
        f"{LANES * steps / wall:,.0f} transitions/s, {wall / steps * 1e3:.3f} ms/step, "
        f"{syncs / steps:.2f} host syncs/step, launches {launches} "
        f"({launches['slot_write'] / steps:.2f} slot_write/step) on {card}")
    if steps != STEPS:
        raise SystemExit(f"run stopped after {steps} of {STEPS} steps")
    check_path_launches("main path", launches)
    host = batch_to_numpy(final)
    if not (host.status == Status.RUNNING).all():
        raise SystemExit("lanes halted in the endless demo loop")
    caller = 0xDEADBEEFDEADBEEF
    for lane in SAMPLE_LANES:
        want = expected_storage(body, calldata[lane], caller, STEPS)
        got = storage_dict(host, lane)
        if got != want:
            raise SystemExit(f"lane {lane}: storage {got} != expected {want}")
    log(f"[main] storage of lanes {SAMPLE_LANES} equals the Python oracle")

    cpu_final, cpu_steps = run(
        make_batch(CPU_LANES, calldata=calldata[:CPU_LANES], device="cpu"),
        make_code_table([code], device="cpu"), max_steps=STEPS)
    cpu_host = batch_to_numpy(cpu_final)
    for name in host._fields:
        if not np.array_equal(getattr(host, name)[:CPU_LANES], getattr(cpu_host, name)):
            raise SystemExit(f"field {name}: card lanes differ from the CPU run")
    log(f"[main] first {CPU_LANES} lanes equal a device='cpu' run, every field")
    return dict(launches=launches, wall=wall, steps=steps, syncs=syncs, cold_ms=cold_ms)


# the kernels the main path and the wave launch; keccak_f1600's
# permutations run inside keccak_sponge there, so only keccak256 calls it
PATH_KERNELS = ("keccak_sponge", "slot_write")
# the flip frontier's kernels (step 3 of the main path)
FLIP_KERNELS = ("portfolio_eval", "portfolio_sls")


def reset_launches():
    from mythril_tpu_torch.ops import keccak_cuda, portfolio_eval, portfolio_sls, slot_write

    keccak_cuda.LAUNCHES = keccak_cuda.SPONGE_LAUNCHES = 0
    slot_write.LAUNCHES = slot_write.MANY_LAUNCHES = 0
    portfolio_eval.LAUNCHES = portfolio_sls.LAUNCHES = 0


def read_launches():
    """Launches since reset_launches(), by kernel; slot_write counts both
    of its forms, slot_write_many the multi-table form alone."""
    from mythril_tpu_torch.ops import keccak_cuda, portfolio_eval, portfolio_sls, slot_write

    return {"keccak_f1600": keccak_cuda.LAUNCHES, "keccak_sponge": keccak_cuda.SPONGE_LAUNCHES,
            "slot_write": slot_write.LAUNCHES, "slot_write_many": slot_write.MANY_LAUNCHES,
            "portfolio_eval": portfolio_eval.LAUNCHES, "portfolio_sls": portfolio_sls.LAUNCHES}


def check_path_launches(path, launches):
    for name in PATH_KERNELS + ("slot_write_many",):
        if launches[name] == 0:
            raise SystemExit(f"the {path} never launched {name}")


def profile_steps(label, fn, n_steps, card, ms_per_step):
    """Where a step's time goes: CUDA kernels per step, device busy time
    per step and the kernels that take most of it, from torch.profiler
    around `fn` (n_steps steps). The idle share divides busy time by the
    wall time of the same profiled window; the window's ms/step beside
    the unprofiled run's shows what the profiler costs."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_ms = (time.perf_counter() - t0) / n_steps * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        log(f"[{label}] the profiler recorded no device activity: not measured")
        return None, None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    per_step_ms = busy_us / n_steps / 1e3
    log(f"[{label}] {n_steps} steps: {len(kernels) / n_steps:.1f} CUDA "
        f"kernels/step, device busy {per_step_ms:.3f} ms/step of {window_ms:.3f} "
        f"ms/step wall in the same profiled window (idle share "
        f"{1 - per_step_ms / window_ms:.3f}; unprofiled {ms_per_step:.3f} ms/step) "
        f"on {card}")
    for name, us in top:
        log(f"  {us / busy_us:6.1%}  {name[:100]}")
    return per_step_ms, len(kernels) / n_steps


def phase_profile(card, ms_per_step):
    """The main path's step breakdown over LOOP_STEPS steps."""
    import numpy as np

    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run

    _, code = program()
    rng = np.random.default_rng(1)
    calldata = [rng.integers(0, 256, CALLDATA_BYTES, dtype=np.uint8).tobytes()
                for _ in range(LANES)]
    table = make_code_table([code])
    batch, _ = run(make_batch(LANES, calldata=calldata), table, max_steps=LOOP_STEPS)
    return profile_steps("profile", lambda: run(batch, table, max_steps=LOOP_STEPS),
                         LOOP_STEPS, card, ms_per_step)


def second_wave_seed(codes, n):
    """The reseed delta of the second wave: the same stripes, calldata
    drawn from random.Random(WAVE_STRIPES + k), no value, balance or
    storage (the explorer's first-wave environment)."""
    import numpy as np

    from mythril_tpu_torch.laser import symbolic_wave as wave

    code_ids, calldata, _ = wave.wave_inputs(codes, WAVE_STRIPES, WAVE_LANES_PER_STRIPE,
                                             seed=WAVE_STRIPES)
    cd = np.zeros((n, 128), np.uint8)
    for i, data in enumerate(calldata):
        cd[i, :len(data)] = np.frombuffer(data, np.uint8)
    cds = np.array([len(d) for d in calldata], np.int32)
    words = np.zeros((n, SLOT_W), np.uint32)
    slab = np.zeros((n, 1, SLOT_W), np.uint32)
    return (code_ids, cd, cds, words, words, slab, slab, np.zeros(n, np.int32),
            np.zeros(n, bool))


def sym_fields(symb):
    """(name, tensor) of every field of a SymBatch, its StateBatch's too."""
    return ([(f"base.{k}", t) for k, t in zip(symb.base._fields, symb.base)]
            + list(zip(symb._fields[1:], symb[1:])))


def overflowed_lanes(symb, table, want):
    """Lanes whose arena row was dropped past ARENA_CAP at some step, from
    a rerun of the wave from `symb` that counts them (one extra launch
    per step, outside any timed run); the rerun must give `want`."""
    import torch

    from mythril_tpu_torch.laser.batch import symbolic as sym

    dropped = torch.zeros(symb.base.pc.shape[0], dtype=torch.bool, device="cuda")
    append = sym._arena_append

    def counting_append(symb_, mk_row, columns):
        ok, node_tid = append(symb_, mk_row, columns)
        dropped.bitwise_or_(mk_row & ~ok)
        return ok, node_tid

    sym._arena_append = counting_append
    try:
        again, _, _ = sym.sym_run(symb, table, max_steps=WAVE_MAX_STEPS)
    finally:
        sym._arena_append = append
    differ = [name for (name, x), (_, y) in zip(sym_fields(again), sym_fields(want))
              if not torch.equal(x, y)]
    if differ:
        raise SystemExit(f"a rerun of the wave differs in {differ}")
    return int(dropped.sum())


def phase_wave(card):
    """The symbolic shadow wave at the explorer's full width."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch import symbolic as sym
    from mythril_tpu_torch.laser.batch.arena import ArenaView
    from mythril_tpu_torch.support import hostsync

    symb, table = wave.make_wave(WAVE_STRIPES, WAVE_LANES_PER_STRIPE)
    n = symb.base.pc.shape[0]
    sync()
    t0 = time.perf_counter()
    mid, cold_steps, _ = sym.sym_run(symb, table, max_steps=WAVE_COLD_STEPS)
    sync()
    cold_ms = (time.perf_counter() - t0) / cold_steps * 1e3
    log(f"[wave] {n} lanes ({WAVE_STRIPES} stripes x {WAVE_LANES_PER_STRIPE}, 13 "
        f"contracts): cold first {cold_steps} steps {cold_ms:.3f} ms/step on {card}")

    reset_launches()
    hostsync.COUNT = 0
    t0 = time.perf_counter()
    out, steps, active = sym.sym_run(symb, table, max_steps=WAVE_MAX_STEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    syncs = hostsync.COUNT
    overflowed = overflowed_lanes(symb, table, out)
    active = int(active)
    status = np.bincount(out.base.status.cpu().numpy(), minlength=11).tolist()
    log(f"[wave] {n} lanes x {steps} steps: {wall:.3f} s, {wall / steps * 1e3:.3f} "
        f"ms/step, {active} active lane-steps ({active / wall:,.0f}/s), {syncs / steps:.2f} "
        f"host syncs/step, launches {launches} ({launches['slot_write'] / steps:.2f} "
        f"slot_write/step) on {card}")
    log(f"[wave] ar_count {int(out.ar_count)} of {sym.ARENA_CAP}, {overflowed} lanes "
        f"overflowed the arena, {int(out.ev_cnt.sum())} events banked "
        f"({int((out.ev_overflow != 0).sum())} lanes dropped one), status counts {status}")
    check_path_launches("symbolic wave", launches)

    # the first view pays the pinned host buffers' allocation; the
    # second reuses them from PyTorch's caching host allocator
    view_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        view = ArenaView(out)
        view_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[wave] ArenaView readback {view_ms[0]:.3f} ms first, {view_ms[1]:.3f} ms "
        f"second (two host syncs each), {view.bytes_fetched} B fetched of "
        f"{view.bytes_full} B full on {card}")

    prof_in = sym.clone_sym_batch(mid)
    profile_steps("wave profile",
                  lambda: sym.sym_run_inplace(prof_in, table, max_steps=WAVE_PROFILE_STEPS),
                  WAVE_PROFILE_STEPS, card, wall / steps * 1e3)
    del prof_in, mid

    # the next wave in the spent wave's buffers, held to a fresh batch
    delta = second_wave_seed(wave.load_contracts(), n)
    t0 = time.perf_counter()
    wave2 = sym.reseed_wave_inplace(out, *delta)
    sync()
    reseed_ms = (time.perf_counter() - t0) * 1e3
    fresh, _ = wave.make_wave(WAVE_STRIPES, WAVE_LANES_PER_STRIPE, seed=WAVE_STRIPES)
    differ = [name for (name, x), (_, y) in zip(sym_fields(wave2), sym_fields(fresh))
              if not torch.equal(x, y)]
    if differ:
        raise SystemExit(f"the reseeded wave differs from a fresh batch in {differ}")
    del fresh
    t0 = time.perf_counter()
    _, steps2, active2 = sym.sym_run_inplace(wave2, table, max_steps=WAVE_MAX_STEPS)
    sync()
    wall2 = time.perf_counter() - t0
    log(f"[wave] reseed_wave_inplace {reseed_ms:.3f} ms, equal to a fresh batch in every "
        f"field; second wave {steps2} steps, {wall2:.3f} s, {wall2 / steps2 * 1e3:.3f} "
        f"ms/step, {int(active2) / wall2:,.0f} active lane-steps/s on {card}")
    return dict(launches=launches, wall=wall, steps=steps,
                frontier=(view, symb.base.code_id.cpu().numpy()))


def phase_sym_parity():
    """The card's symbolic wave against the JAX package's pinned digests
    and against a CPU run."""
    import numpy as np

    from mythril_tpu_torch.interop import symbatch_to_numpy
    from mythril_tpu_torch.laser import flip_frontier as ff
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch.arena import ArenaView
    from mythril_tpu_torch.laser.batch.symbolic import sym_run

    pinned = wave.load_pinned()
    settings = pinned["settings"]
    if settings != wave.PIN_SETTINGS:
        raise SystemExit(f"pinned digests were taken at {settings}")
    symb, table = wave.make_wave(settings["stripes"], settings["lanes_per_stripe"])
    out, steps, active = sym_run(symb, table, max_steps=settings["max_steps"])
    digests = wave.field_digests(symbatch_to_numpy(out))
    bad = sorted(k for k, v in pinned["digests"].items() if digests.get(k) != v)
    if bad or (steps, int(active)) != (pinned["steps"], pinned["active_lane_steps"]):
        raise SystemExit(f"the pinned wave on the card differs from the JAX package's "
                         f"digests in {bad} (steps {steps}, active {int(active)})")
    log(f"[parity] pinned {symb.base.pc.shape[0]}-lane wave: {steps} steps, all "
        f"{len(digests)} SymBatch fields hash to the JAX package's digests")
    flip_pinned = ff.load_pinned()
    if flip_pinned["settings"] != wave.PIN_SETTINGS:
        raise SystemExit(f"pinned frontier digests were taken at {flip_pinned['settings']}")
    frontier = ff.pinned_wave_frontier(ArenaView(out), symb.base.code_id.cpu().numpy())
    if frontier != {k: v for k, v in flip_pinned.items() if k != "settings"}:
        raise SystemExit("the pinned wave's flip frontier decoded on the card differs from "
                         "the JAX package's pinned digests")
    log(f"[parity] pinned wave's frontier: {frontier['tried']} targets tried, "
        f"{frontier['opaque']} opaque, {len(frontier['candidates'])} candidates whose path "
        f"conditions and lowered queries equal the JAX package's decode (canonical digests)")

    lanes = PARITY_STRIPES * WAVE_LANES_PER_STRIPE
    card_out = symbatch_to_numpy(sym_run(*wave.make_wave(
        PARITY_STRIPES, WAVE_LANES_PER_STRIPE), max_steps=WAVE_MAX_STEPS)[0])
    cpu_out = symbatch_to_numpy(sym_run(*wave.make_wave(
        PARITY_STRIPES, WAVE_LANES_PER_STRIPE, device="cpu"), max_steps=WAVE_MAX_STEPS)[0])
    got = list(card_out.base) + list(card_out[1:])
    want = list(cpu_out.base) + list(cpu_out[1:])
    names = [f"base.{k}" for k in card_out.base._fields] + list(card_out._fields[1:])
    differ = [name for name, x, y in zip(names, got, want) if not np.array_equal(x, y)]
    if differ:
        raise SystemExit(f"the {lanes}-lane wave on the card differs from the CPU in {differ}")
    log(f"[parity] {lanes}-lane wave: the card equals a device='cpu' run in every field, "
        f"arena included")



def _identifiers(mangled):
    """The length-prefixed identifiers of an Itanium-mangled name."""
    out, i = [], 0
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j > i:
            n = int(mangled[i:j])
            out.append(mangled[j:j + n])
            i = j + n
        else:
            i += 1
    return out


def ptxas_table(report):
    """{function: (registers, spill bytes)} from a ptxas -v report, the
    mangled names cut to the kernel's (or device function's) name and
    its template arguments (the limb count; the portfolio kernels'
    shared or global variant)."""
    out = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            mangled = m.group(1)
            parts = [w for w in _identifiers(mangled)
                     if w.endswith("kernel") or w in ("eval_program", "udivmod")]
            name = parts[-1] if parts else mangled[:60]
            t = re.search(r"ILi(\d+)E(?:Lb([01])E)?", mangled)
            if t:
                variant = {"1": ",shared", "0": ",global"}.get(t.group(2), "")
                name += f"<{t.group(1)}{variant}>"
            out[name] = [None, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def portfolio_registers():
    """{kernel <L, variant>: (registers, spill bytes)} of csrc/portfolio.cu
    and csrc/portfolio_sls.cu from the build's ptxas reports (None where
    the build printed none)."""
    return ptxas_table(BUILD_REPORTS.get("portfolio", "") + "\n"
                       + BUILD_REPORTS.get("portfolio_sls", "")) or None


FIRST_PASS_EVALS = 192 + 2  # a first pass: the initial score, 192 steps, the final score
DISPATCH_US = [0.0]  # host us per trivial CUDA launch, from phase_device


def aten_ops(fn) -> int:
    """PyTorch operator calls `fn` makes (each one kernel launch when its
    tensors lie on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def work_bound(count, io_bytes):
    """(bound ms, bound_by) of evaluations whose work the plain version
    counted: int32 operations over INT32_OPS_PER_S against the bytes the
    function must move, `io_bytes` (its inputs read once, its outputs
    written once), over HBM_BYTES_PER_S. The kernels' node-value scratch
    is their own design, not the function's, and is not counted."""
    ops_ms = count.get("ops", 0) / INT32_OPS_PER_S * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def synthetic_programs():
    """Programs the frontier does not give: every op of the device
    language at 32-bit and at 512- to 2048-bit widths (L = 16, 32, 64,
    128), from the port's own term layer."""
    from mythril_tpu_torch.laser.smt import terms as T
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf

    progs = []
    for w in (32, 512, 1024, 2048):
        x, y, z = (T.bv_var(f"chip_{w}_{n}", w) for n in "xyz")
        c = lambda v: T.bv_const(v, w)  # noqa: E731
        # division on a numerator of at most 64 bits: the plain version's
        # bit-serial loop runs one step per numerator bit
        low = (lambda t: t) if w <= 64 else (lambda t: T.zext(T.extract(63, 0, t), w - 64))
        q = [T.eq(T.add(T.mul(x, c(3)), y), c(0x1234567)),
             T.ult(T.udiv(low(y), c(7)), T.urem(low(z), c(1000003))),
             T.bor(T.slt(x, z), T.sle(T.ashr(z, c(5)), T.lshr(y, c(w - 9)))),
             T.implies(T.eq(T.bvxor(x, y), z), T.bnot(T.eq(T.shl(y, c(3)), T.bvnot(x)))),
             T.eq(T.extract(7, 0, T.sub(x, y)), T.bv_const(0x5A, 8)),
             T.bxor(T.eq(T.sext(T.extract(15, 0, z), w - 16), x),
                    T.band(T.ult(c(3), y), T.eq(T.ite(T.ult(x, y), x, y), T.bvor(y, z)))),
             T.eq(T.concat(T.extract(w - 1, w // 2, x), T.extract(w // 2 - 1, 0, y)),
                  T.zext(T.extract(w - 9, 0, z), 8))]
        progs.append(pf.compile_program(q))
    return progs


# queries that the search solves inside SLS_CHECK_STEPS at the check's
# seed, built from the port's term layer: one a seeded lane solves before
# the first step, others after a few steps (found with the plain version)
def solving_programs():
    from mythril_tpu_torch.laser.smt import terms as T
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower

    x, y = T.bv_var("chip_sx", 32), T.bv_var("chip_sy", 32)
    s, t = T.bv_var("chip_ss", 16), T.bv_var("chip_st", 16)
    c = lambda v: T.bv_const(v, 32)  # noqa: E731
    queries = [
        [T.ult(s, t), T.ult(T.bv_const(0x8000, 16), s)],
        [T.slt(x, c(0)), T.eq(T.extract(7, 0, x), T.bv_const(0x80, 8))],
        [T.eq(T.mul(x, c(3)), c(0x300)), T.ult(x, c(0x1000))],
        [T.ult(x, c(1000)), T.ult(c(500), x), T.eq(T.urem(x, c(7)), c(3))],
        [T.eq(T.sub(x, y), c(3)), T.ult(y, c(4))],
        [T.eq(T.add(x, y), c(0x1234)), T.ult(x, c(100))],
        [T.eq(T.lshr(x, c(4)), c(0x12))],
    ]
    return [pf.compile_program(lower(q)[0]) for q in queries]


@contextmanager
def plan_forced(mod, variant=None, cluster=None):
    """Force a portfolio wrapper's launch plan (`mod.PLAN_OVERRIDE`) for
    the calls inside."""
    saved = dict(mod.PLAN_OVERRIDE)
    mod.PLAN_OVERRIDE.clear()
    mod.PLAN_OVERRIDE.update({k: v for k, v in (("variant", variant), ("cluster", cluster))
                              if v is not None})
    try:
        yield
    finally:
        mod.PLAN_OVERRIDE.clear()
        mod.PLAN_OVERRIDE.update(saved)


def plan_text(plan):
    """One launch plan, short: variant, blocks (or cluster) x candidate
    slots a block (x candidates a slot), shared bytes."""
    if "cluster" in plan:
        return (f"{plan['variant']} {plan['cluster']}x{plan['slots']}x{plan['per_thread']} "
                f"({plan['smem']} B)")
    return f"{plan['variant']} {plan['blocks']}x{plan['slots']} ({plan['smem']} B)"


def sls_stack_plan(group, K, variant=None, cluster=None):
    """The plan portfolio_sls takes for these stacked programs, with the
    kernel's own count of its shared bytes (`kernel_smem`)."""
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.ops import portfolio_sls as ps

    cpu_in = pf.stack_programs(group, "cpu")
    dims = (cpu_in[0].shape[1], cpu_in[4].shape[2], K, cpu_in[7].shape[1],
            cpu_in[4].shape[1], cpu_in[5].shape[1])
    plan = ps.sls_plan(*dims, variant, cluster)
    n, L, _, V, C, R = dims
    plan["kernel_smem"] = ps.kernel_smem_bytes(n, L, V, C, R, plan["slots"], plan["per_block"],
                                               plan["variant"] == "shared")
    return plan


def cycled(progs, q):
    """q programs: `progs` repeated in turn."""
    return [progs[i % len(progs)] for i in range(q)]


def cube_programs(progs):
    """The cube fan's programs of `progs` as device_solve_batch builds
    them (rank_impact_vars on the card, then 2**cube_depth cubes each)."""
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf

    out = []
    for prog in progs:
        ranked = pf.rank_impact_vars(prog, device="cuda")
        for cq in pf.cube_queries(prog.source, prog, ranked=ranked):
            cprog = pf.compile_program(cq)
            if cprog is not None and cprog.var_slots:
                out.append(cprog)
    return out


def phase_portfolio_kernels(card, frontier_progs, solving_progs=()):
    """Both portfolio kernels held to their plain versions (run on CPU
    copies of the same inputs) on the frontier's own programs, on
    programs the search solves (`solving_progs`, the one-branch
    contract's, plus `solving_programs()`), on the synthetic ones and,
    for the search, with the Luby restarts forced (RESTART_BASES); every
    check under the plan's own choice, the global variant forced and each
    cluster size forced. Then timed against their bounds, also at the
    flip's own shapes and at Q = OCCUPANCY_Q."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.ops import portfolio_eval as pe
    from mythril_tpu_torch.ops import portfolio_sls as ps

    rng = np.random.default_rng(4)
    solving = list(solving_progs) + solving_programs()
    synthetic = synthetic_programs()
    progs = list(frontier_progs) + solving + synthetic

    def rand_X(prog, K):
        X = rng.integers(0, 1 << 16, (len(prog.var_slots), K, prog.limbs))
        X[:, ::4, 2:] = 0
        X[:, 1::5, :] = 0
        for v, (_n, w) in enumerate(prog.var_slots):
            X[v] &= np.array(pe.width_mask(w, prog.limbs))[None, :]
        return X

    def eval_plan_of(prog, K, variant=None):
        """The plan, with the kernel's own count of its shared bytes."""
        dims = (prog.n_real_nodes, prog.limbs, K, len(prog.var_slots),
                prog.const_pool.shape[0], prog.roots.shape[0])
        plan = pe.eval_plan(*dims, variant)
        n, L, _, V, C, R = dims
        plan["kernel_smem"] = (pe.kernel_smem_bytes(n, L, V, C, R, plan["slots"])
                               if plan["variant"] == "shared" else 0)
        return plan

    # the plans' shared bytes against the kernels' own layouts (a launch
    # short of the layout is refused by the C entry)
    layout_bad = 0

    def held(plan):
        nonlocal layout_bad
        layout_bad += int(plan["smem"] != plan["kernel_smem"])
        return plan

    # portfolio_eval: every candidate's (solved, score) on every program,
    # under the plan's variant and with the global variant forced
    eval_bad = eval_cases = eval_err = 0
    eval_plans = {}

    def eval_check(prog, X, count=None):
        nonlocal eval_bad, eval_err, eval_cases
        card_args = pe.program_tensors(prog, "cuda") + (torch.as_tensor(X, device="cuda"),)
        t0 = time.perf_counter()
        want = pe.eval_plain(*pe.program_tensors(prog, "cpu"), torch.as_tensor(X),
                             n_nodes=prog.n_real_nodes, count=count)
        plain_ms = (time.perf_counter() - t0) * 1e3
        for variant in (None, "global"):
            with plan_forced(pe, variant):
                got = pe.portfolio_eval(*card_args, n_nodes=prog.n_real_nodes)
            sync()
            eval_bad += int((got[0].cpu() != want[0]).sum() + (got[1].cpu() != want[1]).sum())
            eval_err = max(eval_err, int((got[1].cpu().long() - want[1].long()).abs().max()))
            eval_cases += X.shape[1]
            plan = held(eval_plan_of(prog, X.shape[1], variant))
            key = (prog.limbs, X.shape[1], plan["variant"], plan["slots"])
            eval_plans[key] = eval_plans.get(key, 0) + 1
        return card_args, plain_ms

    for prog in progs:
        for K in EVAL_CHECK_K:
            eval_check(prog, rand_X(prog, K))
    log(f"[portfolio] portfolio_eval on {len(progs)} programs ({len(frontier_progs)} of the "
        f"frontier; L {sorted({p.limbs for p in progs})}) x K {list(EVAL_CHECK_K)} candidates, "
        f"the plan's variant and the global one: {eval_bad} mismatches against the plain "
        f"version on {card}; plans (L, K, variant, slots): programs {eval_plans}")

    # the timed shapes on the frontier's largest program: device_enumerate's
    # chunk, rank_impact_vars' batch ((V + 1) x 16 probes) and one probe batch
    prog = max(progs[:max(1, len(frontier_progs))], key=lambda p: p.n_real_nodes)
    n_var = len(prog.var_slots)
    eval_shapes = []
    for K in (ENUM_K, (n_var + 1) * RANK_PROBES, RANK_PROBES):
        X = rand_X(prog, K)
        count = {}
        card_args, plain_ms = eval_check(prog, X, count)
        io_bytes = X.size * 4 + sum(a.numel() * 4 for a in card_args[:7]) + K * 8
        bound, by = work_bound(count, io_bytes)
        row = dict(shape=f"K={K}, {prog.n_real_nodes} nodes, L={prog.limbs}", K=K,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by, ops=count["ops"],
                   io_bytes=io_bytes)
        for variant in (None, "global"):
            tag = "" if variant is None else "global_"
            with plan_forced(pe, variant):
                dev_ms, call_ms = kernel_ms(
                    lambda: pe.portfolio_eval(*card_args, n_nodes=prog.n_real_nodes),
                    "portfolio_eval_kernel", 10)
            row[tag + "ms"] = dev_ms
            row[tag + "ms_source"] = "profiler" if dev_ms is not None else "not measured"
            row[tag + "call_ms"] = call_ms
            row[tag + "plan"] = plan_text(eval_plan_of(prog, K, variant))
        eval_shapes.append(row)
        log(f"[portfolio] portfolio_eval at {row['shape']}: kernel {ms_text(row['ms'])} "
            f"({row['plan']}; {row['call_ms']:.4f} ms a call between events), global "
            f"variant {ms_text(row['global_ms'])}, plain {plain_ms:.1f} ms (CPU), bound "
            f"{bound:.4f} ms by {by} ({count['ops']:,} int32 ops, {io_bytes:,} B in and out) "
            f"on {card}")
    enum_row = eval_shapes[0]
    # what the kernels replace: the plain version's PyTorch ops for one
    # evaluation of this program (each a launch on the card), and at the
    # host's dispatch time per launch, a first pass of the search (192
    # steps, 194 evaluations) eagerly
    small = pe.program_tensors(prog, "cpu") + (torch.as_tensor(rand_X(prog, 64)),)
    eager_ops = aten_ops(lambda: pe.eval_plain(*small, n_nodes=prog.n_real_nodes))
    first_pass = eager_ops * FIRST_PASS_EVALS
    log(f"[portfolio] the plain version runs {eager_ops} PyTorch ops per evaluation of "
        f"this program at K=64: {first_pass:,} launches for one query's first pass, "
        f"{first_pass * DISPATCH_US[0] / 1e6:.1f} s at this host's {DISPATCH_US[0]:.2f} us "
        f"per trivial launch on {card}")

    # portfolio_sls: Q programs in one launch, bit-equal at a short budget,
    # under the plan's choice, the global variant and each cluster size
    knobs = dict(pf.PORTFOLIO_DEFAULTS)
    sls_bad = sls_err = restarts = 0
    sls_rows = []
    forced = [("global", None)] + [(None, c) for c in ps.CLUSTER_SIZES]
    groups = [("frontier", list(frontier_progs), SLS_CHECK_K[:1], knobs)] if frontier_progs \
        else []
    # the cube fan's programs, as the flip phase's second launch builds
    # them (rank_impact_vars on the card, then the cubes' extra
    # constraints on each root)
    cubes = cube_programs(list(frontier_progs)) if frontier_progs else []
    if cubes:
        groups.append(("cube fan", cubes, SLS_CHECK_K[:1], knobs))
    groups += [("solving", solving, SLS_CHECK_K, knobs)]
    groups += [("synthetic", [p], SLS_CHECK_K[:2], knobs) for p in synthetic]
    # the Luby restarts inside the budget: frontier and wide synthetic
    # programs (no early solve) with a small restart unit
    restart_progs = [("frontier", list(frontier_progs))] if frontier_progs else []
    restart_progs += [(f"synthetic L={p.limbs}", [p]) for p in synthetic if p.limbs in (16, 64)]
    for base in RESTART_BASES:
        for label, group in restart_progs:
            groups.append((f"{label}, restart_base {base}", group, SLS_CHECK_K[:1],
                           dict(knobs, restart_base=base)))
    for label, group, ks, kn in groups:
        card_in = pf.stack_programs(group, "cuda")
        cpu_in = pf.stack_programs(group, "cpu")
        for K in ks:
            count = {}
            t0 = time.perf_counter()
            want = ps.sls_plain(*cpu_in, seed=7, steps=SLS_CHECK_STEPS, K=K, count=count,
                                **ps.search_args(K, kn))
            plain_ms = (time.perf_counter() - t0) * 1e3
            restarts += count.get("restarts", 0)
            bad = 0
            plans = []
            for variant, cluster in [(None, None)] + forced:
                with plan_forced(ps, variant, cluster):
                    got = ps.portfolio_sls(*card_in, seed=7, steps=SLS_CHECK_STEPS, K=K,
                                           knobs=kn)
                sync()
                bad += sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
                sls_err = max([sls_err] + [int((g.cpu().long() - w.long()).abs().max())
                                           for g, w in zip(got[1:], want[1:])])
                plans.append(plan_text(held(sls_stack_plan(group, K, variant, cluster))))
                if variant is None and cluster is None:
                    steps, solved = got[2].tolist(), got[0].tolist()
            sls_bad += bad
            ms, call_ms = kernel_ms(
                lambda: ps.portfolio_sls(*card_in, seed=7, steps=SLS_CHECK_STEPS, K=K,
                                         knobs=kn), "portfolio_sls_kernel", 5)
            io_bytes = (sum(a.numel() * 4 for a in card_in) + got[1].numel() * 4
                        + 2 * 4 * len(group))
            bound, by = work_bound(count, io_bytes)
            sls_rows.append(dict(programs=label, q=len(group), K=K,
                                 limbs=max(p.limbs for p in group), ms=ms,
                                 ms_source="profiler" if ms is not None else "not measured",
                                 call_ms=call_ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by, steps=steps, solved=solved,
                                 mismatches=bad, restarts=count.get("restarts", 0),
                                 ops=count.get("ops", 0), plan=plans[0]))
            log(f"[portfolio] portfolio_sls {label} Q={len(group)} K={K} "
                f"L={sls_rows[-1]['limbs']} {SLS_CHECK_STEPS} steps: {bad} mismatches (solved, "
                f"winners, steps) over {len(plans)} plans [{'; '.join(plans)}]; solved "
                f"{[int(x) for x in solved]}, steps taken {steps}, "
                f"{count.get('restarts', 0)} restarts; kernel {ms_text(ms)} ({call_ms:.4f} ms "
                f"a call between events), plain "
                f"{plain_ms:.1f} ms (CPU), bound {bound:.4f} ms by {by} on {card}")
    # the checks must see the outcomes that make witnesses: a query solved
    # by a seeded lane before the first step and one solved mid-search
    # (the early stop, the first solved lane's winner, its step count),
    # and lanes that restarted
    at_init = sum(s and n == 0 for r in sls_rows for s, n in zip(r["solved"], r["steps"]))
    mid = sum(s and 0 < n < SLS_CHECK_STEPS for r in sls_rows
              for s, n in zip(r["solved"], r["steps"]))
    log(f"[portfolio] portfolio_sls checks: {at_init} queries solved before the first step, "
        f"{mid} solved after 1 to {SLS_CHECK_STEPS - 1} steps, {restarts} Luby restarts")
    if not (at_init and mid):
        raise SystemExit("the portfolio_sls checks never compared a solving search")
    if not restarts:
        raise SystemExit("no lane restarted in the portfolio_sls checks")
    regs = portfolio_registers()
    log(f"[portfolio] registers, spill bytes: {regs if regs else 'not measured'} "
        f"(ptxas, sm_90a) for {card}")
    log(f"[portfolio] the plans' shared bytes against the kernels' layouts: {layout_bad} "
        f"mismatches")
    if eval_bad or sls_bad or layout_bad:
        raise SystemExit(f"the portfolio kernels disagree with their plain versions or "
                         f"layouts: eval {eval_bad}, sls {sls_bad}, layout {layout_bad}")

    # timed only: the flip's own SLS shapes (the first pass over the
    # frontier's queries, the cube fan over their cubes, 192 steps) and
    # Q = OCCUPANCY_Q queries at the checks' budget. A bound at 192 steps
    # scales the same programs' 16-step check count by the evaluations.
    sls_shapes = []
    log(f"[portfolio] SM clock, most, power, temperature before the timed shapes: "
        f"{sm_clocks()}")

    def time_sls(label, group, K, steps, bound=None):
        card_in = pf.stack_programs(group, "cuda")
        got = ps.portfolio_sls(*card_in, seed=7, steps=steps, K=K, knobs=knobs)
        ms, call_ms = kernel_ms(
            lambda: ps.portfolio_sls(*card_in, seed=7, steps=steps, K=K, knobs=knobs),
            "portfolio_sls_kernel", 3)
        taken = got[2].tolist()
        row = dict(shape=f"{label} Q={len(group)}, K={K}, {steps} steps", ms=ms,
                   ms_source="profiler" if ms is not None else "not measured", call_ms=call_ms,
                   plan=plan_text(sls_stack_plan(group, K)), solved=int(got[0].sum()),
                   steps_max=max(taken), bound_ms=bound[0] if bound else None,
                   bound_by=bound[1] if bound else None)
        sls_shapes.append(row)
        log(f"[portfolio] portfolio_sls timed, {row['shape']}: {ms_text(ms)} ({row['plan']}; "
            f"{call_ms:.4f} ms a call between events), "
            f"{row['solved']} solved, steps taken up to {row['steps_max']}, bound "
            f"{'%.4f ms by %s' % bound if bound else 'not counted'} on {card}")

    def per_eval(label):
        """A check group's counted operations per evaluation (K = 64)."""
        row = next(r for r in sls_rows if r["programs"] == label)
        return row["ops"] / (row["K"] * sum(n + 2 for n in row["steps"]))

    if frontier_progs:
        evals = lambda q, K: q * K * (FLIP_STEPS + 2)  # noqa: E731
        time_sls("frontier", list(frontier_progs), 64, FLIP_STEPS,
                 (per_eval("frontier") * evals(len(frontier_progs), 64) / INT32_OPS_PER_S
                  * 1e3, "operations (scaled)"))
        if cubes:
            time_sls("cube fan", cubes, 64, FLIP_STEPS,
                     (per_eval("cube fan") * evals(len(cubes), 64) / INT32_OPS_PER_S * 1e3,
                      "operations (scaled)"))
        # the occupancy question on its own: the frontier's queries (which
        # run every step) cycled to OCCUPANCY_Q, against Q = 4 above
        time_sls("frontier cycled", cycled(list(frontier_progs), OCCUPANCY_Q), 64,
                 SLS_CHECK_STEPS,
                 (per_eval("frontier") * OCCUPANCY_Q * 64 * (SLS_CHECK_STEPS + 2)
                  / INT32_OPS_PER_S * 1e3, "operations (scaled)"))
    narrow = [p for p in progs if p.limbs == 16]
    occ = cycled(narrow, OCCUPANCY_Q)
    cpu_in = pf.stack_programs(occ, "cpu")
    count = {}
    want = ps.sls_plain(*cpu_in, seed=7, steps=SLS_CHECK_STEPS, K=64, count=count,
                        **ps.search_args(64, knobs))
    got = ps.portfolio_sls(*pf.stack_programs(occ, "cuda"), seed=7, steps=SLS_CHECK_STEPS,
                           K=64, knobs=knobs)
    sync()
    occ_bad = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
    io_bytes = sum(a.numel() * 4 for a in cpu_in) + got[1].numel() * 4 + 8 * len(occ)
    time_sls(f"{len(narrow)} L=16 programs cycled", occ, 64, SLS_CHECK_STEPS,
             work_bound(count, io_bytes))
    sls_shapes[-1]["mismatches"] = occ_bad
    if occ_bad:
        raise SystemExit(f"portfolio_sls at Q={OCCUPANCY_Q}: {occ_bad} mismatches")

    log(f"[portfolio] SM clock, most, power, temperature after the timed shapes: "
        f"{sm_clocks()}")
    main = sls_rows[0]
    if enum_row["ms"] is None or main["ms"] is None:
        raise SystemExit("the profiler saw no portfolio kernel at the kernels line's shapes")
    return {
        "portfolio_eval": dict(mismatches=eval_bad, max_abs_err=eval_err,
                               kernel_ms=enum_row["ms"], plain_ms=enum_row["plain_ms"],
                               bound_ms=enum_row["bound_ms"], bound_by=enum_row["bound_by"],
                               library_ms=None, plain_device="cpu", shape=enum_row["shape"],
                               plan=enum_row["plan"], checked_candidates=eval_cases,
                               registers=regs, shapes=eval_shapes),
        "portfolio_sls": dict(mismatches=sls_bad, max_abs_err=sls_err, kernel_ms=main["ms"],
                              plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                              bound_by=main["bound_by"], library_ms=None, plain_device="cpu",
                              shape=f"{main['programs']} Q={main['q']}, K={main['K']}, "
                              f"L={main['limbs']}, {SLS_CHECK_STEPS} steps", plan=main["plan"],
                              restarts=restarts, checks=sls_rows, shapes=sls_shapes),
    }


# a contract whose one branch tests calldata byte 0 (calldataload(0) >> 248
# == 0x42, JUMPI at pc 11, SSTORE behind it): its flip is solvable, so the
# witness -> next wave -> realized flip loop runs on the card
ONE_BRANCH = bytes.fromhex("600035" "60f8" "1c" "6042" "14" "600d" "57" "00" "5b" "6001"
                           "6000" "55" "00")


def flip_loop_check(card):
    """One generation of a one-branch contract on the card: the flip is
    solved, its witness seeds the next wave, which takes the branch."""
    import numpy as np

    from mythril_tpu_torch.laser import flip_frontier as ff
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch.arena import ArenaView
    from mythril_tpu_torch.laser.batch.state import make_batch, make_code_table
    from mythril_tpu_torch.laser.batch.symbolic import make_sym_batch, sym_run

    n = 4
    code_ids = np.zeros(n, np.int32)
    base = make_batch(n, code_ids=code_ids, calldata=[bytes(wave.CALLDATA_LEN)] * n,
                      **wave.BATCH_KWARGS)
    table = make_code_table([ONE_BRANCH])
    out, _, _ = sym_run(make_sym_batch(base), table, max_steps=64)
    by_contract = ff.lanes_by_contract(code_ids)
    res = ff.solve_frontier(ArenaView(out), {}, by_contract)
    calldata = ff.generation_calldata([ONE_BRANCH], code_ids, 2, 1, res["witnesses"])
    out2, _ = ff.next_wave(out, table, code_ids, calldata, max_steps=64)
    hit = ff.realized(ArenaView(out2), by_contract, {0: [(11, True)]})
    log(f"[flip] one-branch contract: {ff.describe(res)}; witness calldata[0] "
        f"{calldata[0][:1].hex()}, {hit} of 1 flips realized in the next wave on {card}")
    if hit != 1 or res["witness_invalid"]:
        raise SystemExit("the one-branch contract's flip was not realized on the card")
    return ff.frontier_queries(res)


def phase_flip(card, big):
    """The flip frontier at the explorer's geometry (a stripe of
    LANES_PER_CONTRACT lanes per vendored contract) for GENERATIONS
    generations, then the 16384-lane wave's frontier in one dispatch."""
    from mythril_tpu_torch.laser import flip_frontier as ff
    from mythril_tpu_torch.laser import symbolic_wave as wave

    per_gen = []
    last = read_launches()

    def report(g, res):
        nonlocal last
        now = read_launches()
        launches = {k: now[k] - last[k] for k in ("portfolio_eval", "portfolio_sls")}
        last = now
        per_gen.append(launches)
        log(f"[flip] generation {g}: {res['steps']} wave steps, {ff.describe(res)}; ms: "
            f"wave {res['wave_ms']:.1f}, view {res['view_ms']:.1f}, decode "
            f"{res['decode_ms']:.1f}, lower+compile {res['lower_compile_ms']:.1f}, device "
            f"solve {res['solve_ms']:.1f}; launches {launches} on {card}")

    reset_launches()
    t0 = time.perf_counter()
    stripes = len(wave.load_contracts())
    history = ff.run_generations(stripes, ff.LANES_PER_CONTRACT, ff.GENERATIONS, log=report)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for res in history[:-1]:
        log(f"[flip] generation {res['generation']}: {len(res['witnesses'])} witnesses, "
            f"{res['realized']} flips realized in generation {res['generation'] + 1}, next "
            f"wave {res['next_wave_ms']:.1f} ms on {card}")
    log(f"[flip] {stripes * ff.LANES_PER_CONTRACT} lanes x {ff.GENERATIONS} generations: "
        f"{wall:.3f} s, launches {launches} on {card}")
    invalid = sum(r["witness_invalid"] for r in history)
    if launches["portfolio_sls"] == 0:
        raise SystemExit("the flip phase never launched portfolio_sls")
    if launches["portfolio_eval"] == 0:
        log("[flip] portfolio_eval was not launched: no query enumerated and none went to "
            "the cube fan (every SLS survivor would be ranked by it)")
    progs = ff.frontier_queries(history[0], limit=8)

    # the explorer-width wave of phase_wave: its whole frontier, one dispatch
    view, code_ids = big
    reset_launches()
    t0 = time.perf_counter()
    res = ff.solve_frontier(view, {}, ff.lanes_by_contract(code_ids))
    sync()
    big_ms = (time.perf_counter() - t0) * 1e3
    big_launches = read_launches()
    invalid += res["witness_invalid"]
    log(f"[flip] the {len(code_ids)}-lane wave's frontier: {ff.describe(res)}; ms: decode "
        f"{res['decode_ms']:.1f}, lower+compile {res['lower_compile_ms']:.1f}, device solve "
        f"{res['solve_ms']:.1f}, all {big_ms:.1f}; launches {big_launches} on {card}")
    if invalid:
        raise SystemExit(f"{invalid} witnesses failed validation")
    progs += ff.frontier_queries(res, limit=2)
    solving = flip_loop_check(card)
    return dict(launches=launches, per_generation=per_gen, wall=wall, programs=progs,
                solving=solving, big_launches=big_launches)


def phase_bignum(card):
    """The bit-serial u256 loops at full width (candidates for kernels)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import u256

    rng = np.random.default_rng(2)

    def words():
        return torch.tensor(rng.integers(0, 1 << 16, (LANES, 16), dtype=np.int32),
                            device="cuda")

    a, b, c = words(), words(), words()
    out = {}
    for name, fn in (("divmod_all", lambda: u256.divmod_all(a, b)),
                     ("addmod_mulmod", lambda: u256.addmod_mulmod(a, b, c)),
                     ("exp", lambda: u256.exp(a, b)),
                     ("mul", lambda: u256.mul(a, b))):
        fn()
        out[name] = time_cuda(fn, 3)
    sync()
    log("[bignum] full-width 256-bit operands, n=%d: %s on %s" % (
        LANES, ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()), card))
    return out


def phase_vmtests():
    from mythril_tpu_torch.laser.conformance import load_vmtests, run_cases

    pinned = json.loads(
        (ROOT / "mythril_tpu_torch" / "laser" / "vmtests_device_verdicts.json").read_text())
    settings = pinned["settings"]
    if (settings["max_steps"], settings["straggler_steps"]) != (VM_MAX_STEPS,
                                                               VM_STRAGGLER_STEPS):
        raise SystemExit(f"pinned verdicts were taken at {settings}")
    cases, _ = load_vmtests()
    t0 = time.perf_counter()
    verdicts = run_cases(cases, max_steps=VM_MAX_STEPS, hybrid=False,
                         straggler_steps=VM_STRAGGLER_STEPS)
    sync()
    wall = time.perf_counter() - t0
    mismatches = sorted(k for k in pinned["verdicts"]
                        if verdicts.get(k) != pinned["verdicts"][k])
    mismatches += sorted(set(verdicts) - set(pinned["verdicts"]))
    fails = sorted(k for k, v in verdicts.items() if v.startswith("fail"))
    passes = sum(v == "pass" for v in verdicts.values())
    log(f"[vmtests] {len(cases)} cases in {wall:.1f} s: {passes} pass, "
        f"{len(cases) - passes} skip, {len(fails)} fail, {len(mismatches)} mismatches "
        f"against the pinned JAX verdicts")
    for k in (mismatches + fails)[:10]:
        log(f"  {k}: {verdicts.get(k)} (pinned {pinned['verdicts'].get(k)})")
    if mismatches or fails:
        raise SystemExit("VMTests verdicts disagree")
    return wall


def ab_host_reads(card):
    """The u256 loops' data-dependent start or stop bit (one host read
    per DIV/MOD/ADDMOD/MULMOD/EXP step) against all 256 or 512 bits:
    each variant runs the main path AB_MAIN_REPS times and the VMTests
    replay once, in the order A B B A, and must give the first run's
    final state and verdicts."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.laser.conformance import load_vmtests, run_cases
    from mythril_tpu_torch.ops import u256
    from mythril_tpu_torch.support import hostsync

    fixed = {
        "data-dependent": None,
        "fixed u256 bits": (u256, "_top_bit",
                            lambda x: x.shape[-1] * u256.LIMB_BITS - 1),
    }
    _, code = program()
    rng = np.random.default_rng(1)
    calldata = [rng.integers(0, 256, CALLDATA_BYTES, dtype=np.uint8).tobytes()
                for _ in range(LANES)]
    table = make_code_table([code])
    batch = make_batch(LANES, calldata=calldata)
    cases, _ = load_vmtests()
    run(batch, table, max_steps=LOOP_STEPS)
    sync()
    ref = None
    results = {name: {"main_ms_per_step": [], "vm_s": []} for name in fixed}
    for name in list(fixed) + list(fixed)[::-1]:
        saved = None
        if fixed[name] is not None:
            mod, attr, fn = fixed[name]
            saved = getattr(mod, attr)
            setattr(mod, attr, fn)
        try:
            main_s = []
            for _ in range(AB_MAIN_REPS):
                hostsync.COUNT = 0
                t0 = time.perf_counter()
                final, steps = run(batch, table, max_steps=STEPS)
                sync()
                main_s.append(time.perf_counter() - t0)
                main_syncs = hostsync.COUNT
            hostsync.COUNT = 0
            t0 = time.perf_counter()
            verdicts = run_cases(cases, max_steps=VM_MAX_STEPS, hybrid=False,
                                 straggler_steps=VM_STRAGGLER_STEPS)
            sync()
            vm_s = time.perf_counter() - t0
            vm_syncs = hostsync.COUNT
        finally:
            if saved is not None:
                setattr(mod, attr, saved)
        if ref is None:
            ref = (final, verdicts)
        elif verdicts != ref[1] or not all(
                torch.equal(x, y) for x, y in zip(final, ref[0])):
            raise SystemExit(f"{name}: the result differs from the data-dependent run")
        r = results[name]
        ms = [t / steps * 1e3 for t in main_s]
        r["main_ms_per_step"] += ms
        r["vm_s"].append(vm_s)
        r["main_syncs_per_step"] = main_syncs / steps
        r["vm_syncs"] = vm_syncs
        log(f"[ab] {name}: main path {', '.join(f'{x:.3f}' for x in ms)} ms/step "
            f"({main_syncs / steps:.2f} syncs/step), VMTests {vm_s:.2f} s "
            f"({vm_syncs} syncs) on {card}")
    log(json.dumps({"card": card, "ab_host_reads": results}))


def ab_windows(card):
    """The full-width wave with the shadow's per-lane memory windows (as
    shipped) against the full-width path forced on every SHA3 and copy
    step (the JAX kernel's [N, mem_cap] masks), in the order A B B A: each
    visit times one unprofiled wave and profiles a second whole wave, and
    must give the first visit's result."""
    import importlib

    import torch

    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch import symbolic as sym

    stepmod = importlib.import_module("mythril_tpu_torch.laser.batch.step")
    present = stepmod._present

    def full_width(op, ex, flag=None):
        return present(op, ex, flag) | {stepmod.FLAG}

    variants = {"windows": present, "full width": full_width}
    symb, table = wave.make_wave(WAVE_STRIPES, WAVE_LANES_PER_STRIPE)
    sym.sym_run(symb, table, max_steps=WAVE_COLD_STEPS)
    sync()
    ref = None
    results = {name: {"ms_per_step": [], "busy_ms_per_step": [], "kernels_per_step": []}
               for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        stepmod._present = variants[name]
        try:
            t0 = time.perf_counter()
            out, steps, _ = sym.sym_run(symb, table, max_steps=WAVE_MAX_STEPS)
            sync()
            ms = (time.perf_counter() - t0) / steps * 1e3
            busy, kernels = profile_steps(
                f"ab {name}", lambda: sym.sym_run(symb, table, max_steps=WAVE_MAX_STEPS),
                steps, card, ms)
        finally:
            stepmod._present = present
        if ref is None:
            ref = out
        elif not all(torch.equal(x, y) for (_, x), (_, y) in zip(sym_fields(out),
                                                                sym_fields(ref))):
            raise SystemExit(f"{name}: the wave differs from the first visit's")
        del out
        r = results[name]
        r["ms_per_step"].append(ms)
        r["busy_ms_per_step"].append(busy)
        r["kernels_per_step"].append(kernels)
        r["steps"] = steps
    log(json.dumps({"card": card, "ab_windows": results}))


def pinned_frontier_programs():
    """The pinned wave's frontier programs, the wave run on the card: the
    4 queries the flip phase's generation 0 solves."""
    from mythril_tpu_torch.laser import flip_frontier as ff
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch.arena import ArenaView
    from mythril_tpu_torch.laser.batch.symbolic import sym_run
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower

    settings = wave.load_pinned()["settings"]
    symb, table = wave.make_wave(settings["stripes"], settings["lanes_per_stripe"])
    out, _, _ = sym_run(symb, table, max_steps=settings["max_steps"])
    code_ids, _, _ = wave.wave_inputs(wave.load_contracts(), settings["stripes"],
                                      settings["lanes_per_stripe"])
    view, tracks, by_contract = ArenaView(out), {}, ff.lanes_by_contract(code_ids)
    ff.harvest(view, tracks, by_contract)
    cands, _, _ = ff.collect_candidates(view, tracks, by_contract)
    lowered, _ = ff.lower_flips([conds for _, _, conds, _ in cands], lower)
    progs = [pf.compile_program_relaxed(lw)[0] for lw in lowered]
    return [p for p in progs if p is not None and p.var_slots]


def portfolio_times(label):
    """Both portfolio kernels of the package on sys.path, on the pinned
    frontier's programs at the flip's shapes: one JSON line of device ms
    (torch.profiler) and ms a call between CUDA events, each after a warm
    call."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.native import build
    from mythril_tpu_torch.ops import portfolio_eval as pe
    from mythril_tpu_torch.ops import portfolio_sls as ps

    build.build()
    progs = pinned_frontier_programs()
    prog = max(progs, key=lambda p: p.n_real_nodes)
    rng = np.random.default_rng(4)
    out = {"label": label, "package": str(Path(pe.__file__).resolve().parents[1]),
           "programs": [p.n_real_nodes for p in progs]}
    for K in (ENUM_K, (len(prog.var_slots) + 1) * RANK_PROBES, RANK_PROBES):
        X = rng.integers(0, 1 << 16, (len(prog.var_slots), K, prog.limbs))
        for v, (_n, w) in enumerate(prog.var_slots):
            X[v] &= np.array(pe.width_mask(w, prog.limbs))[None, :]
        args = pe.program_tensors(prog, "cuda") + (torch.as_tensor(X, device="cuda"),)
        out[f"eval K={K}"] = kernel_ms(
            lambda: pe.portfolio_eval(*args, n_nodes=prog.n_real_nodes),
            "portfolio_eval_kernel", 10)
    knobs = dict(pf.PORTFOLIO_DEFAULTS)
    cubes = cube_programs(progs)
    for name, group, steps in (("sls Q=4 16 steps", progs, SLS_CHECK_STEPS),
                               ("sls Q=4 192 steps", progs, FLIP_STEPS),
                               (f"sls cube fan Q={len(cubes)} 192 steps", cubes, FLIP_STEPS)):
        stacked = pf.stack_programs(group, "cuda")
        out[name] = kernel_ms(lambda: ps.portfolio_sls(*stacked, seed=7, steps=steps, K=64,
                                                       knobs=knobs),
                              "portfolio_sls_kernel", 3)
    sync()
    print(json.dumps(out), flush=True)


def ab_portfolio(card, parent):
    """The portfolio kernels of a parent checkout (`parent`, unpacked
    beside this one) against this checkout's, each in its own process on
    this card, in the order parent, change, change, parent."""
    rows = []
    for label, root in (("parent", parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", parent)):
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--portfolio-times", root, label],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise SystemExit(f"--portfolio-times {root} failed:\n{done.stdout}{done.stderr}")
        rows.append(json.loads(done.stdout.strip().splitlines()[-1]))
        log(f"[ab] {label} ({root}): " + ", ".join(
            f"{k} {v[0]:.4f} ms [{v[1]:.4f} a call]" for k, v in rows[-1].items()
            if k.startswith(("eval", "sls")) and v[0] is not None))
    log(json.dumps({"card": card, "ab_portfolio": rows}))


def checkout_dir(path: str) -> str:
    """`path` resolved, where it is this checkout or a directory under its
    git-ignored `_archive/` (a parent unpacked with `git archive`); any
    other directory is refused, so the A/B modes import and build no
    package from outside the checkout."""
    p = Path(path).resolve()
    if p != ROOT and ROOT / "_archive" not in p.parents:
        raise SystemExit(f"chip_smoke.py: {path} is neither this checkout nor a directory "
                         f"under {ROOT / '_archive'}")
    return str(p)


def main() -> int:
    args = sys.argv[1:]
    if not (ROOT / "mythril_tpu_torch" / "__init__.py").exists():
        print("chip_smoke.py: run from a checkout of the repository", file=sys.stderr)
        return 2
    # --portfolio-times ROOT LABEL times the package of this checkout or of
    # one unpacked under _archive/
    package_root = checkout_dir(args[1]) if args[:1] == ["--portfolio-times"] else str(ROOT)
    sys.path.insert(0, package_root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    if args[:1] == ["--portfolio-times"]:
        portfolio_times(args[2])
        return 0
    kind, card = phase_device()
    if args[:1] == ["--ab-portfolio"]:
        ab_portfolio(card, checkout_dir(args[1]))
        return 0
    phase_build()
    sync()
    if args == ["--ab-host-reads"]:
        ab_host_reads(card)
        return 0
    if args == ["--ab-windows"]:
        ab_windows(card)
        return 0
    kern = {"keccak_f1600": phase_kernel(card), "keccak_sponge": phase_sponge(card),
            "slot_write": phase_slot_write(card)}
    sync()
    host_us = host_cost_us(card)
    sync()
    if args == ["--kernels"]:
        phase_portfolio_kernels(card, [])
        return 0
    main_path = phase_main_path(card)
    sync()
    phase_profile(card, main_path["wall"] / main_path["steps"] * 1e3)
    sync()
    phase_bignum(card)
    sync()
    sym_wave = phase_wave(card)
    sync()
    phase_sym_parity()
    sync()
    flip = phase_flip(card, sym_wave["frontier"])
    sync()
    kern.update(phase_portfolio_kernels(card, flip["programs"], flip["solving"]))
    sync()
    phase_vmtests()
    sync()

    where = {
        "keccak_f1600": ("mythril_tpu_torch/csrc/keccak_f.cu",
                         "mythril_tpu/ops/keccak_pallas.py:44"),
        "keccak_sponge": ("mythril_tpu_torch/csrc/keccak_f.cu",
                          "mythril_tpu/ops/keccak_pallas.py:44"),
        "slot_write": ("mythril_tpu_torch/csrc/slot_write.cu",
                       "tools/pallas_stack_probe.py:62"),
        "portfolio_eval": ("mythril_tpu_torch/csrc/portfolio.cu",
                           "mythril_tpu/laser/smt/solver/portfolio.py:517"),
        "portfolio_sls": ("mythril_tpu_torch/csrc/portfolio_sls.cu",
                          "mythril_tpu/laser/smt/solver/portfolio.py:635"),
    }
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": where[name][0],
        "replaces": where[name][1],
        "on_path": name in PATH_KERNELS + FLIP_KERNELS,
        "launches": main_path["launches"][name],
        "launches_symbolic_wave": sym_wave["launches"][name],
        "launches_flip": flip["launches"][name],
        **({"launches_many": main_path["launches"]["slot_write_many"],
            "launches_many_symbolic_wave": sym_wave["launches"]["slot_write_many"],
            "host_us_per_call_many": host_us["slot_write_many, 8 banks"]}
           if name == "slot_write" else {}),
        "mismatches": k.pop("mismatches"),
        "max_abs_err": k.pop("max_abs_err"),
        "ms": k.pop("kernel_ms"),
        "plain_ms": k.pop("plain_ms"),
        "bound_ms": k.pop("bound_ms"),
        "bound_by": k.pop("bound_by"),
        "library_ms": k.pop("library_ms", None),
        "host_us_per_call": host_us.get(name),
        **k,
    } for name, k in kern.items()]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
