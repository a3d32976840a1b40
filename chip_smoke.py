#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mythril_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels         # device, build, the kernel
                                            # phases and the wrappers' host cost
    python3 chip_smoke.py --ab-host-reads   # device, build, then only the
                                            # A/B of the u256 loops' host read
    python3 chip_smoke.py --ab-windows      # device, build, then only the
                                            # A/B of the wave's memory windows

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
   (mythril_tpu_torch/laser/symbolic_wave_digests.json), and a 128-lane
   wave on the card must equal a device="cpu" run, every field;
7. VMTests: every vendored suite through run_cases(hybrid=False) on the
   card, name by name against the JAX package's pinned verdicts
   (mythril_tpu_torch/laser/vmtests_device_verdicts.json), with no
   mismatch and no "fail:";
8. report: the `kernels` JSON line, then the result line.

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
    log(f"[device] host CPU {host_cpu()}; dispatch {dispatch_us():.2f} us per trivial "
        f"CUDA launch (median of 1000)")
    return name, card.splitlines()[0]


def phase_build():
    from mythril_tpu_torch.native import build

    t0 = time.perf_counter()
    built = build.build(verbose=True)
    for stem, (secs, report) in built.items():
        log(f"[build] csrc/{stem}.cu: done by {secs:.2f} s")
        if report:
            log(report)
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


def reset_launches():
    from mythril_tpu_torch.ops import keccak_cuda, slot_write

    keccak_cuda.LAUNCHES = keccak_cuda.SPONGE_LAUNCHES = 0
    slot_write.LAUNCHES = slot_write.MANY_LAUNCHES = 0


def read_launches():
    """Launches since reset_launches(), by kernel; slot_write counts both
    of its forms, slot_write_many the multi-table form alone."""
    from mythril_tpu_torch.ops import keccak_cuda, slot_write

    return {"keccak_f1600": keccak_cuda.LAUNCHES, "keccak_sponge": keccak_cuda.SPONGE_LAUNCHES,
            "slot_write": slot_write.LAUNCHES, "slot_write_many": slot_write.MANY_LAUNCHES}


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
    return dict(launches=launches, wall=wall, steps=steps)


def phase_sym_parity():
    """The card's symbolic wave against the JAX package's pinned digests
    and against a CPU run."""
    import numpy as np

    from mythril_tpu_torch.interop import symbatch_to_numpy
    from mythril_tpu_torch.laser import symbolic_wave as wave
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


def main() -> int:
    args = sys.argv[1:]
    if not (ROOT / "mythril_tpu_torch" / "__init__.py").exists():
        print("chip_smoke.py: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    kind, card = phase_device()
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
    phase_vmtests()
    sync()

    where = {
        "keccak_f1600": ("mythril_tpu_torch/csrc/keccak_f.cu",
                         "mythril_tpu/ops/keccak_pallas.py:44"),
        "keccak_sponge": ("mythril_tpu_torch/csrc/keccak_f.cu",
                          "mythril_tpu/ops/keccak_pallas.py:44"),
        "slot_write": ("mythril_tpu_torch/csrc/slot_write.cu",
                       "tools/pallas_stack_probe.py:62"),
    }
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": where[name][0],
        "replaces": where[name][1],
        "on_path": name in PATH_KERNELS,
        "launches": main_path["launches"][name],
        "launches_symbolic_wave": sym_wave["launches"][name],
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
        "host_us_per_call": host_us[name],
        **k,
    } for name, k in kern.items()]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
