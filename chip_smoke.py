#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mythril_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-host-reads   # device, build, then only the
                                            # A/B of the u256 loops' host read

Phases, each followed by torch.cuda.synchronize(); any failure exits
non-zero (nothing is caught):

1. device: require CUDA; print the card's name and power limit;
2. build: compile csrc/keccak_f.cu with nvcc for sm_90a (seconds, printed);
3. kernel: keccak-f[1600] on 16384 seeded random states, bit-equal to
   the plain PyTorch version on the same tensors; keccak256 of b"" and of
   a 64-byte mapping key on the card equal to the pure-Python oracle;
   kernel time (CUDA events around a CUDA-graph replay of 50 launches,
   median of 25) and plain time (median of 25 eager calls) beside the
   bound, the compiled kernel's SASS instruction count, and the kernel's
   time at 4x and 16x the main path's n;
4. main path: after one cold loop iteration (42 steps, timed apart),
   16384 lanes x 256 steps of the demo loop (calldata ->
   arithmetic -> storage -> loop) extended with a Solidity mapping-slot
   hash (SHA3 over 64 bytes, SLOAD/SSTORE of that slot) and a 3-block
   SHA3 over 320 bytes of calldata copied to memory, through
   make_code_table / make_batch / run on the card. The SHA3 phase must
   have launched the kernel, sampled lanes' storage must equal values
   computed in Python with the port's keccak oracle, and the first 128
   lanes must equal, field by field, a device="cpu" run of those lanes;
5. VMTests: every vendored suite through run_cases(hybrid=False) on the
   card, name by name against the JAX package's pinned verdicts
   (mythril_tpu_torch/laser/vmtests_device_verdicts.json), with no
   mismatch and no "fail:";
6. report: the `kernels` JSON line, then the result line.

Between 4 and 5 it also prints where a main-path step's time goes
(torch.profiler: CUDA kernels per step, device busy share, top kernels)
and the times of the bit-serial u256 loops (DIV/SDIV/MOD/SMOD,
ADDMOD/MULMOD, EXP) at full width.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
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

# H100 SXM peaks (NVIDIA data sheet; the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
# INT32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s
# float32 figure is 128 lanes x 2 for FMA at the same clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
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


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    return name, card.splitlines()[0]


def phase_build():
    from mythril_tpu_torch.native import build

    secs = build.build("keccak_f", verbose=True)
    log(f"[build] nvcc {build.nvcc()} built csrc/keccak_f.cu in {secs:.2f} s")
    return secs


def sass_histogram():
    """The built keccak kernel's SASS instructions by opcode (NOPs left
    out), from cuobjdump; the kernel is straight-line code, so this is
    what every thread issues. None where the toolkit has no cuobjdump."""
    from mythril_tpu_torch.native import build

    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path("keccak_f"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
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
    for msg in (b"", mapping_key):
        digest = plain.keccak256(msg).cpu().numpy().tobytes()
        if digest != oracle.keccak256(msg):
            raise SystemExit(f"keccak256({msg.hex()}) on the card disagrees")
    sync()
    log("[kernel] keccak256(b'') and keccak256(mapping key) equal the oracle")

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
    scaling = []
    for n in (4 * LANES, 16 * LANES):
        big = torch.tensor(
            rng.integers(0, 2**64, (n, 25), dtype=np.uint64).view(np.int64),
            device="cuda")
        ms = graph_ms(lambda: keccak_cuda.keccak_f(big))
        scaling.append(f"n={n}: {ms:.4f} ms, {ms / max(keccak_bounds(n)):.2f}x bound")
        del big
    log(f"[kernel] scaling: {'; '.join(scaling)} on {card}")
    return dict(mismatches=mismatches, max_abs_err=max_abs_err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_main_path(card):
    import numpy as np
    import torch

    from mythril_tpu_torch.interop import batch_to_numpy
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.laser.batch.state import Status, storage_dict
    from mythril_tpu_torch.ops import keccak_cuda
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

    keccak_cuda.LAUNCHES = 0
    hostsync.COUNT = 0
    t0 = time.perf_counter()
    final, steps = run(batch, table, max_steps=STEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = keccak_cuda.LAUNCHES
    syncs = hostsync.COUNT
    log(f"[main] {LANES} lanes x {steps} steps: {wall:.3f} s, "
        f"{LANES * steps / wall:,.0f} transitions/s, {wall / steps * 1e3:.3f} ms/step, "
        f"{syncs / steps:.2f} host syncs/step, {launches} keccak_f1600 launches "
        f"on {card}")
    if steps != STEPS:
        raise SystemExit(f"run stopped after {steps} of {STEPS} steps")
    if launches == 0:
        raise SystemExit("the SHA3 phase never launched keccak_f1600")
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


def phase_profile(card, ms_per_step):
    """Where a main-path step's time goes: CUDA kernels per step, device
    busy time per step, and the kernels that take most of it, from
    torch.profiler over LOOP_STEPS steps of the same workload. The
    idle share divides busy time by the wall time of the same profiled
    window; the window's ms/step beside the unprofiled run's shows what
    the profiler costs."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run

    _, code = program()
    rng = np.random.default_rng(1)
    calldata = [rng.integers(0, 256, CALLDATA_BYTES, dtype=np.uint8).tobytes()
                for _ in range(LANES)]
    table = make_code_table([code])
    batch, _ = run(make_batch(LANES, calldata=calldata), table, max_steps=LOOP_STEPS)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batch, table, max_steps=LOOP_STEPS)
        sync()
        window_ms = (time.perf_counter() - t0) / LOOP_STEPS * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        log("[profile] the profiler recorded no device activity: not measured")
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    per_step_ms = busy_us / LOOP_STEPS / 1e3
    log(f"[profile] {LOOP_STEPS} steps: {len(kernels) / LOOP_STEPS:.1f} CUDA "
        f"kernels/step, device busy {per_step_ms:.3f} ms/step of {window_ms:.3f} "
        f"ms/step wall in the same profiled window (idle share "
        f"{1 - per_step_ms / window_ms:.3f}; unprofiled {ms_per_step:.3f} ms/step) "
        f"on {card}")
    for name, us in top:
        log(f"  {us / busy_us:6.1%}  {name[:100]}")
    return per_step_ms


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


def main() -> int:
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
    if sys.argv[1:] == ["--ab-host-reads"]:
        ab_host_reads(card)
        return 0
    kern = phase_kernel(card)
    sync()
    main_path = phase_main_path(card)
    sync()
    phase_profile(card, main_path["wall"] / main_path["steps"] * 1e3)
    sync()
    phase_bignum(card)
    sync()
    phase_vmtests()
    sync()

    report = {"kernels": [{
        "name": "keccak_f1600",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/keccak_f.cu",
        "replaces": "mythril_tpu/ops/keccak_pallas.py:44",
        "launches": main_path["launches"],
        "mismatches": kern["mismatches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"],
        "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
