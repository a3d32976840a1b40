#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mythril_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels         # device, build, the kernel
                                            # phases and the wrappers' host cost
                                            # (portfolio kernels on the
                                            # solving and synthetic programs)
    python3 chip_smoke.py --explore         # device, build, then only the
                                            # device explorer (phase 8)
    python3 chip_smoke.py --analyze         # device, build, then the host
                                            # engine's phases: the engine
                                            # differential, the hybrid
                                            # VMTests and the analysis
                                            # (phases 11, 12, 9)
    python3 chip_smoke.py --specialize      # device, build, then only the
                                            # specialization phase (5b)
    python3 chip_smoke.py --serve           # device, build, the kernel
                                            # phases, then only the
                                            # analysis service (phase 9b)
    python3 chip_smoke.py --facade          # device, build, the kernel
                                            # phases, then only the analyzer
                                            # facade's command-line checks
                                            # and SymExecWrapper's prepass
    python3 chip_smoke.py --ab-overlap      # device, build, the kernel
                                            # phases, then the 13 vendored
                                            # contracts through `analyze`:
                                            # the overlapped corpus prepass
                                            # against prepass-first, in the
                                            # order O, P, P, O
    python3 chip_smoke.py --solver          # device, build, the pinned wave
                                            # (phase 6), then only the host
                                            # solver stack (phase 6b)
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
    python3 chip_smoke.py --ab-substep DIR  # the same for the substep kernel,
                                            # at the specialize phase's states
                                            # (16384 and 416 lanes)
    python3 chip_smoke.py --ab-main DIR     # the same for the main path (phase
                                            # 4's run, 3 warm runs a visit), in
                                            # the order DIR, this, this, DIR,
                                            # twice

Phases, each followed by torch.cuda.synchronize(); any failure exits
non-zero (nothing is caught). They run one at a time, each alone on
the card, in the order 1-12 (5b after 5, 9b after 9); 9 runs (b), (a) (a
process of its own), the command-line checks (through the analyzer
facade, in this process, one at a time) and the wrapper's own prepass.

1. device: require CUDA; print the card's name and power limit, the
   host's CPU model and the host's dispatch time per trivial CUDA launch
   (median of 1000), which sets the pace of a host-bound step;
2. build: compile every csrc/*.cu with nvcc for sm_90a, one nvcc per
   source, all started together (seconds and ptxas report printed), and
   meanwhile the host solver library (native/host/cdcl.cpp + blast.cpp)
   with g++ (its seconds printed);
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
5b. specialization (laser/batch/specialize.py, blockjit.py): the substep
   kernel (csrc/substep.cu) in each mode, fuse and block, concrete and
   symbolic, generic and pruned, against its plain version on every lane
   of tests/torch_substep_cases.py (a lane a hazard) and on its seeded
   sweep over 16384 lanes (programs that start on each ALU op, SWAPn,
   DUPn and PUSHn, with random and edge operands); then on the vendored
   corpus's own buckets (the explorer's: static summaries attached),
   against its plain version on the same 16384 lanes after 8 and after
   25 full steps (every field it updates and its counts; 0 mismatches
   everywhere), timed (profiler, each launch from the same state) beside
   its plain version and its bound (the least bytes this state's
   executed substeps move, by class: substep_traffic), and timed with
   its bound on the first 416 lanes of each state (the analysis' and leg
   A's lane count); then the 16384-lane vendored wave on the
   generic loop, the fuse-only bucket and the block bucket: iterations,
   wall, ms and CUDA kernels an iteration, active and substep
   lane-steps, blocks entered, and each specialized wave's final state
   equal to the generic one's (term ids compared by their terms'
   structure: the arena's row order follows when lanes reach their
   nodes);
6. symbolic parity: the pinned 260-lane wave on the card must hash, field
   by field, to the JAX package's digests
   (mythril_tpu_torch/laser/symbolic_wave_digests.json), its flip
   frontier decoded on the card (candidates, path conditions, lowered
   queries) must equal the JAX package's canonical digests
   (mythril_tpu_torch/laser/flip_frontier_pinned.json), and a 128-lane
   wave on the card must equal a device="cpu" run, every field;
6b. solver (laser/smt/solver: check_terms, the CDCL sprint and marathon),
   outside any exploration: the solving queries, six 256-bit EVM-shaped
   queries (selector extract, addition overflow, division, signed
   compare, two unsat) and the pinned wave's generation-0 flip queries,
   once each; every verdict held to the JAX package's
   (tests/test_torch_solver_chip_pinned.json: a sat/unsat disagreement
   fails, unknown never does), every sat witness through
   validate_witness (0 invalid), 0 race errors (the sprint decides
   every query, so no race starts here: the races run under the host
   walk, phase 9 (b)); then the
   --parallel-solving escape (the card held as the explorer's ladder
   holds it, so no race starts) on a query the CDCL cannot
   decide in 300 ms, which must launch portfolio_sls on the card (the
   search scores its own candidates; portfolio_eval does not launch
   here); the kernels line's `launches_solver`;
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
8. device explorer (laser/batch/explore.py, DeviceCorpusExplorer): leg A
   at the JAX package's small-corpus prepass geometry (the 13 vendored
   contracts x 32 lanes, calldata the longest required_calldata_len,
   mem_cap 16384, storage_cap 128, 512 steps a wave, 2 transactions, 64
   candidates and cube depth 3 in the device-first funnel) with a fixed
   cap of 2 waves a phase and no wall budget, first pipelined, then
   lock-step (the default schedule) with the same seed: per wave its
   wall, steps, active lane-steps and readback ms; per reseed the flip
   candidates, opaque targets, queries lowered, device-solve ms,
   verdicts by mode, witnesses (an invalid one fails the run) and
   survivors the absent host ladder deferred; carries, poison carries,
   wave_overlap_ratio, device_idle_frac, the kernels' launches
   (keccak_sponge, slot_write, portfolio_eval and portfolio_sls must all
   launch in both schedules; the kernels line's `launches_explore` is
   the lock-step run's) and every contract's fingerprint (coverage,
   trigger pcs by kind, evidence), whose triggers and evidence must
   agree between the schedules (their coverage may not: the pipelined
   schedule draws its second slot's seeds from the same RNG the
   mutation top-up draws from); leg B at corpus scale (64 tracks
   cycling the contracts x 16 lanes, mem_cap 4096, storage_cap 64, 2
   waves a phase), its first wave held to the same explorer's first
   wave on the CPU and its first batch of queries (its first 16
   programs) held to the plain SLS and evaluation; leg C on the milestone corpus
   (gated_kill must report a selfdestruct at pc 15 with input byte 0 =
   0x42, always_assert an assert-violation at pc 0), its first wave held
   to the CPU's. A degradation record after any leg fails the run;
9. analyze (the main path's step 4, analysis/corpus.py): the 13
   vendored contracts through analyze_corpus on the card at the
   small-corpus prepass geometry, the waves a phase capped at 8 (the JAX
   package's cap is 48), with kernel specialization and blockjit on (the
   default, as in the JAX package: the bucket held to the pin's, and
   block_substep must launch), with the host escalation ladder on and the host
   walk (SymExecWrapper + fire_lasers, the prepass outcome injected) of
   every contract the device does not own, twice, both with the static
   pass on (analysis/static, the default as in the JAX package: the
   static-answer triage, the explorer's prune feed and the walk's module
   screen; its counters, the modules each walk skipped and the seconds
   each walk took are printed). (b) the default funnel
   and cap, the walk's solver queries racing the card: per contract
   owned or not and its issue fingerprints, held to the JAX package's
   (tests/test_torch_analyze_vendored_ladder_pinned.json, the same run
   of the JAX package's analyze_corpus on the CPU; the fingerprints carry
   no witness values), all 13 complete, host_sat (it fails at 0),
   ladder_deferred, the races started, won and lost, race errors and
   invalid race witnesses (0 each), the states each contract walked, the
   report rendered in every form and the wall to the report split into
   prepass, synthesis, walk and rendering; then a one-contract corpus
   whose INVALID sits behind a 64-bit factoring (RACE_GATE), walked under
   `--device-ownership never` (the device may own it), whose queries
   outlast the CDCL sprint on any host, so its walk must start a race on
   the card (whether a vendored walk query races depends on the host's
   speed); the vendored walks' races and launches (`launches_walk`) are
   reported apart from the gate's (`launches_walk_gate`). (a) in a
   process of its own, the ladder at a cap that does not bind under
   deterministic_solving (so the walk races nothing) and the
   enumeration-only device solver, held to the same pin, all 13
   complete. Every device witness of both is replayed on the CPU to its
   pc (analysis/replay.py; a walk's witnesses that do not replay are
   counted); all four of the explorer's kernels must launch in (b) (the
   kernels line's `launches_analyze`). Then the command line, through
   the analyzer facade (mythril/: `MythrilDisassembler`,
   `MythrilAnalyzer.fire_lasers`, as the JAX `myth analyze` runs it),
   in this process (`cli.main`, so the kernels stay loaded and the
   launch counters read each run), each run held to the JAX facade's
   pin (tests/test_torch_facade_pinned.json, the command line's
   defaults): `-c` gated_kill and `-c` HASHKILL (SymExecWrapper's own
   prepass on the card, then the walk; their launches are the kernels
   line's `launches_facade`, where keccak_sponge and slot_write must
   launch); `-c` gated_kill under `--no-specialize` (no explorer
   specialized) and `-c` always_assert under `--no-blockjit` (no block
   substep), each with the default's issues; gated_kill, always_assert,
   CLEAN and HASHKILL as four `-f` files (the overlapped corpus prepass
   on a thread beside the walk of every contract, on the card: SWC-106
   and SWC-110, exit 0, not partial; the prepass's waves and wall, the
   walks it served with the card off and the walks' waits on
   HOST_SYMBOLIC_LOCK printed; its launches `launches_facade_corpus`),
   and again under `--device-ownership never` (the prepass owning
   nothing, the same issues); `--deadline 1` on the race gate,
   gated_kill and always_assert (partial, the gate complete and the
   rest skipped, exit 0; with `--on-timeout fail`, exit 1 and "Analysis
   deadline expired"); origin.sol.o, which the device does not own,
   through `-f`; the race gate under `--device-prepass never
   --device-solving never` (no portfolio launch, the gate closed in the
   loss waterfall); `-j` (the statespace's node and edge counts) and
   `-g` on gated_kill; `disassemble` of suicide.sol.o and
   `function-to-hash` (the JAX text); and
   `python -m mythril_tpu_torch lint -f ... -o json` on the 13 vendored
   contracts (no card), its rows but the wall times equal to the JAX
   `myth lint` rows pinned in tests/test_torch_static_lint_pinned.json.
   Last, SymExecWrapper on gated_kill with no outcome injected: its own
   device prepass on the card must give SWC-106 at pc 15 and launch
   slot_write. Phase 8 runs with the ladder off (a zero cap), as it did
   before the ladder was ported;
9b. analysis service (service/: `serve`'s engine, HTTP server and client)
   at `serve`'s own geometry (4 stripes x 8 lanes, 256 steps and 2 waves
   a job, 68 B calldata, code_cap 2048, 2 transactions, the host walk on
   at 8 s with one worker, specialization, blockjit and the static
   answer on, arena warmup on): serve_jobs()'s ten submissions, in two
   groups (the milestone pair, KILLABLE, exceptions.sol.o device-only,
   WRITER and BRANCHER; then KILLABLE again, HASHKILL, and with a
   deadline of 0 HASHKILL device-only and WRITER), queued before the
   engine starts. First at `serve`'s defaults (SERVE_DEFAULTS:
   lock-step, buckets warmed in the background from a cold kernel
   cache) with fixed job ids: the seconds until /healthz?ready=1 leaves
   arena-warming; every job's state, waves, device block but its
   lane-steps, issue fingerprints, degradations and static answer held
   to the JAX engine's lock-step pin with the walks on
   (tests/test_torch_service_pinned.json, "full_lockstep_walks"); a
   warmup and both kinds of wave must run; keccak_sponge, slot_write and
   block_substep must launch (the kernels line's `launches_serve`).
   Then pipelined (SERVE_CONFIG), the groups submitted concurrently
   through ServiceClient, each report equal to the pipelined pin
   ("full"). Then the same submissions device-only straight into
   engines with fixed job ids, pipelined and lock-step in turns (P, L,
   L, P), each held to its schedule's pin, `serve` and `submit` through
   the command line's entry with its defaults (the card; in-process, on
   a thread), and one profiled wave of exceptions.sol.o: its idle
   share. The `serve` line (before the kernels line) carries the
   defaults' jobs, waves, wall per wave, max jobs resident, seconds to
   ready and to the first report, job latency p50 and max, the same
   numbers of the pipelined run under `pipelined`, the schedules'
   walls and the idle share;
10. portfolio kernels: portfolio_eval and portfolio_sls on the frontier's
   own programs (the search also on the cube fan's first CUBE_CHECK_Q;
   all of them are timed), on queries the
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
11. engine differential: tests/laser/test_engine_differential.py's 48
   random straight-line, memory/SHA3 and branch programs (copied here)
   as lanes of one batch through run.py on the card and one by one
   through the port's host LASER engine: equal final storage;
12. VMTests: every vendored suite through run_cases on the card with its
   defaults (the hybrid replay: a lane the device halts UNSUPPORTED
   continues on the host engine; and the straggler re-run), every case
   passing, as the JAX package's hybrid manifest pins (536), the host
   takeovers counted (the stragglers run on from the main pass's state);
13. report: the `serve` line, then the `kernels` JSON line (each kernel's
   launches on every path: main, symbolic wave, flip frontier, explore,
   analyze, the vendored walks of analyze (b), the race gate's walk,
   solver, serve, the facade's `-c` runs and its corpus run; for
   fused_substep and block_substep also `launches_spec_wave`, the 5b
   wave of their mode), then the result line.

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
BATCH_CHECK_Q = 16  # programs of an explorer batch held to the portfolio's plain versions
CUBE_CHECK_Q = 8  # cube-fan programs held to the plain search (all of them are timed)
PROFILE_TRIES = 10  # profiles kernel_ms takes before it reports a kernel as not measured
# (a profile sometimes records no device activity at all: 5 tries missed
# one kernels-line shape on an H100 in one run, while the shapes timed
# before and after it were seen)
ENUM_K = 4096  # device_enumerate's chunk: portfolio_eval's timed shape
SPEC_CHECK_STEPS = (8, 25)  # full steps before each substep check: straight-line
# dispatcher code, then lanes inside fusible runs and lowered blocks
SPEC_REPS = 10  # profiled substep launches per check
SPEC_ANALYSIS_LANES = 416  # the analysis' and leg A's lanes (13 contracts x 32): the
# substep kernel is also timed on the first 416 lanes of each checked state
SWEEP_SEED = 12  # tests/torch_substep_cases.py:sweep_state over LANES lanes
SPEC_PROFILE_STEPS = 4  # profiled loop iterations of each 5b wave (from iteration 32)
# the substep kernel's least traffic (substep_traffic): a lane not
# RUNNING reads its status (4 B); a RUNNING one reads its status, code
# id, pc, sp (4 B each), gas bounds and budget (8 B each), and one that
# executed writes pc, sp and the gas bounds back; a stack slot is 64 B,
# its tid 4 B, a coverage word 4 B; an ALU op is counted as 16 int32
# operations (bytes bound it either way)
STATUS_BYTES, LANE_READ_BYTES, LANE_WRITE_BYTES = 4, 40, 24
SLOT_BYTES, TID_BYTES, WORD_BYTES = 64, 4, 4
ALU_OPS = 16

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
    `reps` calls (another profile, up to PROFILE_TRIES in all, while none
    of them was seen: a profile sometimes records no kernel of the run,
    or only some of them, so the mean is over the launches it recorded;
    None where no profile did), and the median time between CUDA events
    around one call, which also holds the wrapper's host work. The second
    is never a stand-in for the first."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: the card's clocks rise under load
    call = time_cuda(fn, reps)
    for _ in range(PROFILE_TRIES):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA" and kernel in e.name]
        if us:
            return sum(us) / len(us) / 1e3, call
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
    from concurrent.futures import ThreadPoolExecutor

    from mythril_tpu_torch.native import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host solver library (g++) builds while nvcc runs
        host = pool.submit(build.build_host)
        built = build.build(verbose=True)
        host_s = host.result()
    log(f"[build] host solver library {build.lib_path(build.HOST_STEM).name} from "
        f"native/host/{' + '.join(build.HOST_SOURCES)}: g++ {build.gxx()} "
        + (f"{host_s:.2f} s" if host_s else "already built from these sources"))
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
    from mythril_tpu_torch.ops import (
        keccak_cuda,
        portfolio_eval,
        portfolio_sls,
        slot_write,
        substep,
    )

    keccak_cuda.LAUNCHES = keccak_cuda.SPONGE_LAUNCHES = 0
    slot_write.LAUNCHES = slot_write.MANY_LAUNCHES = 0
    portfolio_eval.LAUNCHES = portfolio_sls.LAUNCHES = 0
    substep.LAUNCHES = substep.FUSE_LAUNCHES = substep.BLOCK_LAUNCHES = 0


def read_launches():
    """Launches since reset_launches(), by kernel; slot_write counts both
    of its forms, slot_write_many the multi-table form alone; the
    substep kernel is named by its mode (fused_substep, block_substep)."""
    from mythril_tpu_torch.ops import (
        keccak_cuda,
        portfolio_eval,
        portfolio_sls,
        slot_write,
        substep,
    )

    return {"keccak_f1600": keccak_cuda.LAUNCHES, "keccak_sponge": keccak_cuda.SPONGE_LAUNCHES,
            "slot_write": slot_write.LAUNCHES, "slot_write_many": slot_write.MANY_LAUNCHES,
            "portfolio_eval": portfolio_eval.LAUNCHES, "portfolio_sls": portfolio_sls.LAUNCHES,
            "fused_substep": substep.FUSE_LAUNCHES, "block_substep": substep.BLOCK_LAUNCHES}


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


SPEC_KERNELS = ("fused_substep", "block_substep")


def vendored_buckets():
    """The vendored corpus's specialization as the explorer makes it
    (static summaries attached, the default): {mode: (PhaseSet, table on
    the card)} for the fuse-only bucket (blockjit off) and the block
    bucket (blockjit on)."""
    import torch

    from mythril_tpu_torch.analysis.static import summary_for
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch import blockjit as bj
    from mythril_tpu_torch.laser.batch import specialize as sp
    from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket

    codes = wave.load_contracts()
    sums = [summary_for(c.hex()) for c in codes]
    cap = code_cap_bucket(max(len(c) for c in codes))
    out = {}
    for mode, block in (("fuse", False), ("block", True)):
        phases = sp.union_phases([
            sp.phases_for(sp.signature_for(c, s), fuse=sp.fuse_profitable(c, s),
                          block_depth=bj.block_depth_for(c, s) if block else 0)
            for c, s in zip(codes, sums)])
        table = (bj.build_block_table if block else sp.build_fuse_table)(codes, cap, sums)
        out[mode] = (phases, torch.from_numpy(table).to("cuda"))
    return out


def substep_state_fields(batch, tid):
    """The tensors a substep launch updates, by name."""
    out = {"pc": batch.pc, "sp": batch.sp, "gas_min": batch.gas_min,
           "gas_max": batch.gas_max, "stack": batch.stack, "pc_seen": batch.pc_seen}
    if tid is not None:
        out["stack_tid"] = tid
    return out


def substep_traffic(base, code, table, phases, tid):
    """The least bytes and int32 operations of one launch of the substep
    kernel from this state. The plain substeps are replayed one at a
    time; each executed lane-substep is charged by its class: PUSHn its
    opcode and n immediate bytes and one slot written, DUPn one slot read
    and one written, SWAPn two read and two written, an ALU op its
    operands read (one for ISZERO and NOT) and one slot written, POP,
    JUMPDEST and the rest no slot; each reads its table byte and sets a
    coverage bit. Each input is read once and each output written once
    over the launch: a slot (and its tid on symbolic lanes) is read only
    where its value comes from the launch's input, a slot or coverage
    word written several times is written once, and a code or table byte
    or a code length is read once however many lanes read it. A lane not
    RUNNING reads its status; a RUNNING one reads its lane words and one
    that executed writes them back. Returns (bytes, operations,
    {class: lane-substeps})."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.batch.blockjit import block_substep
    from mythril_tpu_torch.laser.batch.specialize import fused_substep
    from mythril_tpu_torch.laser.batch.state import StateBatch
    from mythril_tpu_torch.ops import substep

    depth, block = substep.plan(phases)
    b = StateBatch(*(t.clone() for t in base))
    t = None if tid is None else tid.clone()
    pcs, sps, ran = [], [], []
    for _ in range(depth):
        pc0, sp0 = b.pc.clone(), b.sp.clone()
        if block:
            b = block_substep(b, code, table, stack_tid=t, phases=phases)[0]
        else:
            b = fused_substep(b, code, table, stack_tid=t)[0]
        pcs.append(pc0)
        sps.append(sp0)
        ran.append(b.pc != pc0)  # an executed op always advances pc
    pcs, sps, ran = (torch.stack(x).cpu().numpy() for x in (pcs, sps, ran))
    ops = code.ops.cpu().numpy()
    ops_w, tbl_w = ops.shape[1], table.shape[1]
    cid = base.code_id.cpu().numpy().clip(0, ops.shape[0] - 1)
    running = int((base.status == 0).sum())
    code_bytes, table_bytes, words, codes, op_kinds = set(), set(), set(), set(), set()
    slots = 0
    classes = dict(push=0, dup=0, swap=0, alu=0, other=0)
    for lane in np.flatnonzero(ran.any(axis=0)):
        c = int(cid[lane])
        codes.add(c)
        read, written = set(), set()
        for d in np.flatnonzero(ran[:, lane]):
            pc, sp = int(pcs[d, lane]), int(sps[d, lane])
            at = min(pc, ops_w - 33)
            op = int(ops[c, at])
            op_kinds.add(op)
            nb = op - 0x5F if 0x60 <= op <= 0x7F else 0
            code_bytes.update((c, at + i) for i in range(nb + 1))
            table_bytes.add((c, min(pc, tbl_w - 1)))
            words.add((int(lane), pc // 32))
            if nb:
                kind, r, w = "push", (), (sp,)
            elif 0x80 <= op <= 0x8F:
                kind, r, w = "dup", (sp - 1 - (op - 0x80),), (sp,)
            elif 0x90 <= op <= 0x9F:
                pair = (sp - 1, sp - 1 - (op - 0x8F))
                kind, r, w = "swap", pair, pair
            elif block and (0x01 <= op <= 0x03 or op == 0x0B or 0x10 <= op <= 0x1D):
                r = (sp - 1,) if op in (0x15, 0x19) else (sp - 1, sp - 2)
                kind, w = "alu", (sp - len(r),)
            else:
                kind, r, w = "other", (), ()
            classes[kind] += 1
            read.update(s for s in r if s not in written)
            written.update(w)
        slots += len(read) + len(written)
    moved = int(ran.any(axis=0).sum())
    nbytes = ((base.pc.shape[0] - running) * STATUS_BYTES + running * LANE_READ_BYTES
              + moved * LANE_WRITE_BYTES + len(code_bytes) + len(table_bytes)
              + 4 * len(codes)  # code lengths
              + 6 * 4 * len(op_kinds)  # the ops' meta rows
              + slots * (SLOT_BYTES + (TID_BYTES if tid is not None else 0))
              + 2 * WORD_BYTES * len(words)  # coverage words read and written
              + 2 * 8)  # the two counts
    return nbytes, classes["alu"] * ALU_OPS, classes


def substep_against_plain(base, tid, code, table, phases):
    """One launch of the substep kernel and its plain version from copies
    of the same state: (lanes whose updated fields differ, plus 1 if the
    counts differ; the largest absolute difference; the plain version's
    counts; the lanes it moved)."""
    import torch

    from mythril_tpu_torch.laser.batch.state import StateBatch
    from mythril_tpu_torch.ops import substep

    runs = {}
    for kind in ("plain", "kernel"):
        b = StateBatch(*(t.clone() for t in base))
        t = None if tid is None else tid.clone()
        counts = torch.zeros(2, dtype=torch.int64, device="cuda")
        fn = substep.substep_plain if kind == "plain" else substep.substep_run
        out = fn(b, code, table, phases, counts, stack_tid=t)
        sync()
        runs[kind] = (substep_state_fields(out, t), counts.tolist())
    (want, want_counts), (got, got_counts) = runs["plain"], runs["kernel"]
    lanes_bad = torch.zeros(base.pc.shape[0], dtype=torch.bool, device="cuda")
    err = 0
    for name, w in want.items():
        diff = (got[name].long() - w.long()).reshape(w.shape[0], -1)
        lanes_bad |= (diff != 0).any(dim=1)
        err = max(err, int(diff.abs().max()))
    moved = int((want["pc"] != base.pc).sum())
    return int(lanes_bad.sum()) + (got_counts != want_counts), err, want_counts, moved


def first_lanes(base, tid, k):
    """Copies of the first `k` lanes of a state (and of its tids)."""
    from mythril_tpu_torch.laser.batch.state import StateBatch

    n = base.pc.shape[0]
    sub = StateBatch(*(t[:k].clone() if t.dim() and t.shape[0] == n else t.clone()
                       for t in base))
    return sub, None if tid is None else tid[:k].clone()


def time_substep(base, tid, code, table, phases, with_bound=True):
    """The substep kernel's time from this state (profiler, SPEC_REPS
    launches, each from the same state), its time a call between events,
    and its bound for this state's executed substeps (substep_traffic;
    None where not `with_bound`): (ms, call ms, bound ms, bound by,
    bytes, {class: lane-substeps})."""
    import torch

    from mythril_tpu_torch.laser.batch.state import StateBatch
    from mythril_tpu_torch.ops import substep

    # each profiled launch restores the state first (copy kernels, not
    # counted under the substep kernel's name)
    work = StateBatch(*(t.clone() for t in base))
    work_tid = None if tid is None else tid.clone()
    saved = {k: v.clone() for k, v in substep_state_fields(base, tid).items()}
    live = substep_state_fields(work, work_tid)
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")

    def kernel_call():
        for k, v in saved.items():
            live[k].copy_(v)
        counts.zero_()
        substep.substep_run(work, code, table, phases, counts, stack_tid=work_tid)

    dev_ms, call_ms = kernel_ms(kernel_call, "substep_kernel", SPEC_REPS)
    if not with_bound:
        return dev_ms, call_ms, None, None, None, None
    nbytes, n_ops, classes = substep_traffic(base, code, table, phases, tid)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    bound, by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return dev_ms, call_ms, bound, by, nbytes, classes


def check_substep_kernel(card, mode, phases, table, mid, code, symbolic):
    """One launch of the substep kernel against its plain version on the
    same 16384 lanes (every updated field and the counts), then its time
    (time_substep), the plain version's, and its time and bound on the
    first SPEC_ANALYSIS_LANES lanes of the same state."""
    import torch

    from mythril_tpu_torch.laser.batch.state import StateBatch
    from mythril_tpu_torch.ops import substep

    base = mid.base
    tid = mid.stack_tid if symbolic else None
    mismatches, err, (executed, heads), moved = substep_against_plain(
        base, tid, code, table, phases)
    work = StateBatch(*(t.clone() for t in base))
    work_tid = tid.clone() if symbolic else None
    saved = {k: v.clone() for k, v in substep_state_fields(base, tid).items()}
    live = substep_state_fields(work, work_tid)
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")

    def plain_call():
        for k, v in saved.items():
            live[k].copy_(v)
        counts.zero_()
        substep.substep_plain(work, code, table, phases, counts, stack_tid=work_tid)

    plain_ms = time_cuda(plain_call, 2)
    dev_ms, call_ms, bound, by, nbytes, classes = time_substep(base, tid, code, table, phases)
    if sum(classes.values()) != executed:
        raise SystemExit(f"substep_traffic counted {sum(classes.values())} lane-substeps, "
                         f"the plain version {executed}")
    k = SPEC_ANALYSIS_LANES
    ms_k, _, bound_k, by_k, bytes_k, classes_k = time_substep(
        *first_lanes(base, tid, k), code, table, phases)
    n = base.pc.shape[0]
    log(f"[specialize] {mode} substeps x{substep.plan(phases)[0]} "
        f"{'symbolic' if symbolic else 'concrete'}, {n} lanes: {mismatches} mismatches "
        f"against the plain version (max abs err {err}); {executed} lane-substeps executed "
        f"{classes}, {heads} block heads, {moved} lanes moved; kernel {ms_text(dev_ms)} "
        f"({call_ms:.4f} ms a call between events, state restore included), plain "
        f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by} ({nbytes:,} B); its first {k} "
        f"lanes ({sum(classes_k.values())} lane-substeps): kernel {ms_text(ms_k)}, bound "
        f"{bound_k:.5f} ms by {by_k} ({bytes_k:,} B) on {card}")
    return dict(mismatches=mismatches, max_abs_err=err, kernel_ms=dev_ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes=nbytes,
                executed=executed, classes=classes, heads=heads, moved=moved,
                kernel_ms_416=ms_k, bound_ms_416=bound_k, bound_by_416=by_k,
                executed_416=sum(classes_k.values()))


def check_substep_hazards(card):
    """The substep kernel against its plain version on every lane of
    tests/torch_substep_cases.py (a lane a hazard) and on its seeded sweep
    over LANES lanes (each a program that starts on an ALU op, a SWAPn, a
    DUPn or a PUSHn, with random and edge operands), in both modes,
    concrete and symbolic, generic and pruned: every updated field and
    the counts. Returns {mode: [row, ...]}."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_substep_cases as cases

    from mythril_tpu_torch import interop
    from mythril_tpu_torch.laser.batch import blockjit as bj
    from mythril_tpu_torch.laser.batch import specialize as sp
    from mythril_tpu_torch.laser.batch.step import PhaseSet

    t0 = time.perf_counter()
    sweep = cases.sweep_state(LANES, SWEEP_SEED)
    log(f"[specialize] the sweep's {LANES} lanes built in {time.perf_counter() - t0:.1f} s")
    modes = {"fuse": PhaseSet(fuse_depth=sp.FUSE_DEPTH),
             "block": PhaseSet(block_depth=bj.BLOCK_DEPTH)}
    rows = {mode: [] for mode in modes}
    for label, (_names, fields, ops, length, table, tids) in (
            ("hazard lanes", cases.substep_state()), ("ALU sweep", sweep)):
        jumpdest = np.zeros((ops.shape[0], ops.shape[1] - 33), bool)
        code = interop.code_table_from_numpy((ops, jumpdest, length), device="cuda")
        tbl = torch.from_numpy(table).to("cuda")
        base = interop.batch_from_numpy(fields, device="cuda")
        tid0 = torch.from_numpy(tids).to("cuda")
        for mode, generic in modes.items():
            for pruned in (False, True):
                phases = generic._replace(arith=False, shifts=False) if pruned else generic
                for symbolic in (False, True):
                    mismatches, err, (executed, heads), moved = substep_against_plain(
                        base, tid0 if symbolic else None, code, tbl, phases)
                    state = (f"{label}, {'pruned' if pruned else 'generic'}, "
                             f"{'symbolic' if symbolic else 'concrete'}")
                    log(f"[specialize] {mode} substeps, {state}, {base.pc.shape[0]} lanes: "
                        f"{mismatches} mismatches against the plain version (max abs err "
                        f"{err}); {executed} lane-substeps executed, {heads} block heads, "
                        f"{moved} lanes moved")
                    rows[mode].append(dict(state=state, mismatches=mismatches,
                                           max_abs_err=err, executed=executed, heads=heads,
                                           moved=moved))
    return rows


def spec_wave(label, card, fresh, phases=None, table=None):
    """The 16384-lane vendored wave to completion (or WAVE_MAX_STEPS loop
    iterations) on the generic loop (phases None) or a specialized one:
    wall, iterations, active and substep lane-steps, blocks entered,
    host reads, the kernels' launches, then a profile of
    WAVE_PROFILE_STEPS iterations from a state WAVE_PROFILE_STEPS
    iterations in. `fresh()` gives a copy of the seeded wave and its
    code table."""
    from mythril_tpu_torch.laser.batch import specialize as sp
    from mythril_tpu_torch.laser.batch import symbolic as sym
    from mythril_tpu_torch.support import hostsync

    def go(symb, code, steps):
        if phases is None:
            out, it, active = sym.sym_run_inplace(symb, code, max_steps=steps)
            return out, it, active, 0, 0
        return sp.SpecializedKernel(phases).sym_run(symb, code, table, steps, donate=True)

    symb, code = fresh()
    sync()
    reset_launches()
    hostsync.COUNT = 0
    t0 = time.perf_counter()
    out, steps, active, fused, blocks = go(symb, code, WAVE_MAX_STEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    syncs = hostsync.COUNT
    running = int((out.base.status == 0).sum())
    active, fused, blocks = int(active), int(fused), int(blocks)
    prof_in, code2 = fresh()
    prof_in = go(prof_in, code2, WAVE_PROFILE_STEPS)[0]
    sync()
    per_iter_ms, kernels = profile_steps(
        f"specialize {label} profile", lambda: go(prof_in, code2, SPEC_PROFILE_STEPS),
        SPEC_PROFILE_STEPS, card, wall / steps * 1e3)
    del prof_in
    log(f"[specialize] {label} wave, {symb.base.pc.shape[0]} lanes: {steps} iterations, "
        f"{wall:.3f} s, {wall / steps * 1e3:.3f} ms/iteration, {active} active lane-steps "
        f"+ {fused} substep lane-steps ({(active + fused) / wall:,.0f} instructions/s), "
        f"{blocks} blocks entered, {syncs / steps:.2f} host reads/iteration, "
        f"{running} lanes still running, launches {launches} on {card}")
    return dict(out=out, steps=steps, wall=wall, active=active, substep_steps=fused,
                blocks=blocks, launches=launches, running=running, busy_ms=per_iter_ms,
                kernels=kernels)


def shadow_canonical(symb):
    """The symbolic wave's state with each term id replaced by its term's
    structure: the arena row order depends on when lanes reach their
    nodes, which the substeps change, so two runs of the same lanes are
    compared up to it. Returns {field: tensor on the card}: the base
    fields, the non-id shadow fields, the id fields mapped to canonical
    ints (a term's (op, children, operand values), numbered in the order
    of the sorted structures; ids <= 0 kept), and the sorted canonical
    ids of the arena's rows. The arena's rows are read to the host; the
    id fields are mapped on the card."""
    import torch

    count = int(symb.ar_count)
    rows = [t[:count].cpu().numpy() for t in (symb.ar_op, symb.ar_a, symb.ar_b,
                                               symb.ar_va, symb.ar_vb)]
    keys = []
    for op, a, b, va, vb in zip(*rows):
        keys.append((int(op), int(a) if a <= 0 else keys[a - 1],
                     int(b) if b <= 0 else keys[b - 1], va.tobytes(), vb.tobytes()))
    canon = {k: i + 1 for i, k in enumerate(sorted(set(keys), key=repr))}
    ids = torch.tensor([0] + [canon[k] for k in keys] + [-1], dtype=torch.int64,
                       device=symb.ar_op.device)

    def mapped(t):
        t = t.long()
        # an id past ar_count would name no row: it maps to -1
        idx = torch.where(t <= count, t.clamp(min=0), count + 1)
        return torch.where(t > 0, ids[idx], t)

    out = {f"base.{k}": v for k, v in zip(symb.base._fields, symb.base)}
    id_fields = ("stack_tid", "mem_tid", "skey_tid", "sval_tid", "br_tid", "ev_tid", "ev_vtid")
    for name, v in zip(symb._fields[1:], symb[1:]):
        if name.startswith("ar_") and name != "ar_count":
            continue
        out[name] = mapped(v) if name in id_fields else v
    out["arena"] = torch.tensor(sorted(canon.values()), dtype=torch.int64)
    return out


def phase_specialize(card):
    """Kernel specialization and blockjit on the card: the substep kernel
    in each mode (fuse, block; concrete, symbolic) against its plain
    version on the hazard lanes and the sweep (check_substep_hazards) and
    on the vendored wave's 16384 lanes after a few full steps,
    then the vendored wave on the generic loop, the fuse-only bucket and
    the block bucket, whose final states must equal the generic one's
    where both run to completion."""
    import torch

    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch import symbolic as sym

    t0 = time.perf_counter()
    buckets = vendored_buckets()
    for mode, (phases, _) in buckets.items():
        log(f"[specialize] vendored {mode} bucket: pruned {list(phases.pruned)}, fuse_depth "
            f"{phases.fuse_depth}, block_depth {phases.block_depth}")
    checks = {mode: [] for mode in buckets}
    hazards = check_substep_hazards(card)
    seeded, code = wave.make_wave(WAVE_STRIPES, WAVE_LANES_PER_STRIPE)

    def fresh():
        return sym.clone_sym_batch(seeded), code

    symb = fresh()[0]
    done = 0
    for steps in SPEC_CHECK_STEPS:
        symb, _, _ = sym.sym_run_inplace(symb, code, max_steps=steps - done)
        done = steps
        for mode, (phases, table) in buckets.items():
            for symbolic in (False, True):
                row = check_substep_kernel(card, mode, phases, table, symb, code, symbolic)
                row["state"] = f"{steps} full steps, {'symbolic' if symbolic else 'concrete'}"
                checks[mode].append(row)
    del symb
    t_checks = time.perf_counter()
    bad = sum(r["mismatches"] for group in (checks, hazards) for rows in group.values()
              for r in rows)
    if bad:
        raise SystemExit(f"the substep kernel disagrees with its plain version: {bad} "
                         f"mismatches")
    if not all(any(r["executed"] for r in rows) for rows in checks.values()):
        raise SystemExit("a substep check executed no lane")
    if not all(r["executed"] for rows in hazards.values() for r in rows):
        raise SystemExit("a hazard or sweep check of the substep kernel executed no lane")

    t_waves = time.perf_counter()
    generic = spec_wave("generic", card, fresh)
    fuse = spec_wave("fuse-only", card, fresh, *buckets["fuse"])
    block = spec_wave("block", card, fresh, *buckets["block"])
    t_compare = time.perf_counter()
    want = None if generic["running"] else shadow_canonical(generic["out"])
    for label, run, kernel in (("fuse-only", fuse, "fused_substep"),
                               ("block", block, "block_substep")):
        if not run["launches"][kernel]:
            raise SystemExit(f"the {label} wave never launched {kernel}")
        if generic["running"] or run["running"]:
            log(f"[specialize] {label} against generic: not compared, lanes still running "
                f"({run['running']}; generic {generic['running']})")
            continue
        got = shadow_canonical(run["out"])
        differ = [name for name in want if not torch.equal(want[name], got[name])]
        if differ:
            raise SystemExit(f"the {label} wave's final state differs from the generic "
                             f"one's in {differ}")
        log(f"[specialize] {label} wave equal to the generic wave in every field (term ids "
            f"up to the arena's row order); "
            f"{generic['steps']} -> {run['steps']} iterations, wall {generic['wall']:.3f} -> "
            f"{run['wall']:.3f} s, CUDA kernels/iteration {generic['kernels']} -> "
            f"{run['kernels']} on {card}")
    log(f"[specialize] seconds: buckets, wave and checks {t_checks - t0:.1f}, the three "
        f"waves with their profiles {t_compare - t_waves:.1f}, the comparisons "
        f"{time.perf_counter() - t_compare:.1f}")
    kern = {}
    for mode, name in (("fuse", "fused_substep"), ("block", "block_substep")):
        main = checks[mode][-1]
        rows = checks[mode] + hazards[mode]
        kern[name] = dict(mismatches=sum(r["mismatches"] for r in rows),
                          max_abs_err=max(r["max_abs_err"] for r in rows),
                          kernel_ms=main["kernel_ms"], plain_ms=main["plain_ms"],
                          bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                          library_ms=None, shape=f"16384 lanes, {main['state']}",
                          ms_416_lanes=main["kernel_ms_416"],
                          bound_ms_416_lanes=main["bound_ms_416"],
                          bound_by_416_lanes=main["bound_by_416"],
                          checks=[{k: v for k, v in r.items()} for r in checks[mode]],
                          hazard_checks=hazards[mode])
        if main["kernel_ms"] is None:
            raise SystemExit(f"the profiler saw no {name} kernel at the kernels line's shape")
    waves = {label: {k: v for k, v in run.items() if k != "out"}
             for label, run in (("generic", generic), ("fuse", fuse), ("block", block))}
    return dict(kern=kern, waves=waves,
                launches={"fused_substep": fuse["launches"]["fused_substep"],
                          "block_substep": block["launches"]["block_substep"]})


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
    view = ArenaView(out)
    frontier = ff.pinned_wave_frontier(view, symb.base.code_id.cpu().numpy())
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
    return flip_queries(view, symb.base.code_id.cpu().numpy())


def flip_queries(view, code_ids):
    """Generation 0's flip queries of the pinned wave's view (the port's,
    or the JAX package's for the solver phase's pin): [(name, raw
    constraints)], named by contract file and target (pc, taken)."""
    from mythril_tpu_torch.laser import flip_frontier as ff
    from mythril_tpu_torch.laser import symbolic_wave as wave

    names = [p.name for p in sorted(wave.CONTRACTS.glob("*.sol.o"))]
    tracks = {}
    by = ff.lanes_by_contract(code_ids)
    ff.harvest(view, tracks, by)
    cands, _tried, _opaque = ff.collect_candidates(view, tracks, by)
    return [(f"flip:{names[int(code_ids[lane])]}:{target[0]}:{target[1]}",
             [c.raw for c in conds]) for lane, _k, conds, target in cands]



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
# seed: one a seeded lane solves before the first step, others after a
# few steps (found with the plain version). Built on the term layer T
# (the port's here; the JAX pin of the solver phase builds the same
# queries on the JAX package's)
def solving_queries(T):
    x, y = T.bv_var("chip_sx", 32), T.bv_var("chip_sy", 32)
    s, t = T.bv_var("chip_ss", 16), T.bv_var("chip_st", 16)
    c = lambda v: T.bv_const(v, 32)  # noqa: E731
    return [
        [T.ult(s, t), T.ult(T.bv_const(0x8000, 16), s)],
        [T.slt(x, c(0)), T.eq(T.extract(7, 0, x), T.bv_const(0x80, 8))],
        [T.eq(T.mul(x, c(3)), c(0x300)), T.ult(x, c(0x1000))],
        [T.ult(x, c(1000)), T.ult(c(500), x), T.eq(T.urem(x, c(7)), c(3))],
        [T.eq(T.sub(x, y), c(3)), T.ult(y, c(4))],
        [T.eq(T.add(x, y), c(0x1234)), T.ult(x, c(100))],
        [T.eq(T.lshr(x, c(4)), c(0x12))],
    ]


def solving_programs():
    from mythril_tpu_torch.laser.smt import terms as T
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower

    return [pf.compile_program(lower(q)[0]) for q in solving_queries(T)]


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


def rand_candidates(rng, prog, K):
    """K random candidate assignments of `prog`'s vars, [V, K, L] limbs
    inside each var's width, some high limbs and some whole candidates
    zero."""
    import numpy as np

    from mythril_tpu_torch.ops import portfolio_eval as pe

    X = rng.integers(0, 1 << 16, (len(prog.var_slots), K, prog.limbs))
    X[:, ::4, 2:] = 0
    X[:, 1::5, :] = 0
    for v, (_n, w) in enumerate(prog.var_slots):
        X[v] &= np.array(pe.width_mask(w, prog.limbs))[None, :]
    return X


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
        return rand_candidates(rng, prog, K)

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
        groups.append(("cube fan", cubes[:CUBE_CHECK_Q], SLS_CHECK_K[:1], knobs))
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
    last = read_launches()
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


# phase_solver: the host solver stack (check_terms: the CDCL sprint and
# marathon, the --parallel-solving escape on the card) outside any
# exploration, on queries
# whose verdicts the JAX package's check_terms gave on the CPU
# (tests/test_torch_solver.py --pin-chip)
SOLVER_PIN = ROOT / "tests" / "test_torch_solver_chip_pinned.json"
SOLVER_TIMEOUT_MS = 10_000
#: the --parallel-solving escape's query gets this budget: the CDCL cannot
#: factor its 64-bit product in it
ESCAPE_TIMEOUT_MS = 300
ESCAPE_N = 2690070737 * 3210234581  # two 32-bit primes


def evm_queries(T):
    """256-bit queries of the shapes the analysis poses (those of
    tests/laser/smt/test_solver.py): a selector extract, an addition
    overflow, a division, a signed compare, and two unsat ones."""
    b = lambda v: T.bv_const(v, 256)  # noqa: E731
    cd, x, y = (T.bv_var(f"chip_evm_{n}", 256) for n in ("calldata", "x", "y"))
    return [
        ("evm_selector", [T.eq(T.extract(255, 224, cd), T.bv_const(0xA9059CBB, 32)),
                          T.ult(T.lshr(T.shl(cd, b(32)), b(96)), b(1 << 160))]),
        ("evm_add_overflow", [T.ult(T.add(x, y), x), T.ult(y, b(1 << 200))]),
        ("evm_division", [T.eq(T.udiv(x, b(3)), b(5)), T.eq(T.urem(x, b(3)), b(1))]),
        ("evm_signed_compare", [T.slt(x, b(0)), T.slt(b((1 << 256) - 5), x)]),
        ("evm_no_overflow_unsat", [T.ult(T.add(x, y), x), T.ult(x, b(1 << 100)),
                                   T.ult(y, b(1 << 100))]),
        ("evm_even_unsat", [T.eq(T.mul(x, b(2)), b(1)), T.ult(y, x)]),
    ]


def escape_query(T):
    x, y = T.bv_var("chip_esc_x", 64), T.bv_var("chip_esc_y", 64)
    c = lambda v: T.bv_const(v, 64)  # noqa: E731
    return [T.eq(T.mul(x, y), c(ESCAPE_N)), T.ult(c(1), x), T.ult(x, c(1 << 32)),
            T.ult(c(1), y), T.ult(y, c(1 << 32))]


def solver_corpus(T, flips):
    """[(name, raw constraints)] of the solver phase on the term layer T:
    solving_queries, the EVM shapes and generation 0's flip queries."""
    return ([(f"solving{i}", q) for i, q in enumerate(solving_queries(T))]
            + evm_queries(T) + list(flips))


def phase_solver(card, flips):
    """check_terms on the card, outside any exploration: every query of
    the corpus once (the sprint decides each, so no race starts), each
    verdict held to the JAX pin (a sat/unsat disagreement fails; unknown
    is never one), every sat witness through validate_witness, race
    errors must be 0. Then the --parallel-solving escape on one query
    the CDCL cannot decide in ESCAPE_TIMEOUT_MS, with the card held
    (DEVICE_BUSY) as the explorer's ladder holds it, so no race starts:
    one portfolio_sls search on the card."""
    from mythril_tpu_torch.laser.smt import terms as T
    from mythril_tpu_torch.laser.smt.evalterm import eval_term
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.laser.smt.solver import solver as S
    from mythril_tpu_torch.laser.smt.solver.device_race import DEVICE_BUSY
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower
    from mythril_tpu_torch.laser.smt.solver.solver_statistics import SolverStatistics
    from mythril_tpu_torch.support import resilience
    from mythril_tpu_torch.support.support_args import args

    pin = json.loads(SOLVER_PIN.read_text())["verdicts"]
    corpus = solver_corpus(T, flips)
    if sorted(pin) != sorted([n for n, _ in corpus] + ["escape"]):
        raise SystemExit(f"solver: the corpus {[n for n, _ in corpus]} is not the pinned one "
                         f"{sorted(pin)}")
    saved = (args.deterministic_solving, args.parallel_solving)
    args.deterministic_solving, args.parallel_solving = False, False
    stats = SolverStatistics()
    stats.reset()
    resilience.DegradationLog().reset()
    S.reset_blast_session()

    def valid(raw, model):
        lowered = lower(raw)[0]
        prog = pf.compile_program(lowered) if lowered else None
        if prog is not None:
            return pf.validate_witness(prog, model.assignment)
        return all(eval_term(c, model.assignment) for c in raw)

    sync()
    reset_launches()
    results = {}
    t_phase = time.perf_counter()
    try:
        for name, raw in corpus:
            t0 = time.perf_counter()
            verdict, model = S.check_terms(raw, timeout_ms=SOLVER_TIMEOUT_MS)
            ms = (time.perf_counter() - t0) * 1e3
            results[name] = (verdict, ms, valid(raw, model) if verdict == "sat" else None)
        args.parallel_solving = True
        before = read_launches()
        t0 = time.perf_counter()
        # as on the explorer's ladder: the card is held, so no race starts
        DEVICE_BUSY.acquire()
        try:
            escape, escape_model = S.check_terms(escape_query(T),
                                                 timeout_ms=ESCAPE_TIMEOUT_MS)
        finally:
            DEVICE_BUSY.release()
        escape_ms = (time.perf_counter() - t0) * 1e3
        sync()
        after = read_launches()
        escape_launches = {k: after[k] - before[k] for k in FLIP_KERNELS}
    finally:
        args.deterministic_solving, args.parallel_solving = saved
        S.reset_blast_session()
    sync()
    wall = time.perf_counter() - t_phase
    launches = read_launches()
    disagree, invalid = [], []
    for name, _raw in corpus:
        verdict, ms, ok = results[name]
        log(f"[solver] {name}: {verdict} {ms:.1f} ms (JAX pin {pin[name]})")
        if {verdict, pin[name]} == {"sat", "unsat"}:
            disagree.append((name, verdict, pin[name]))
        if ok is False:
            invalid.append(name)
    if {escape, pin["escape"]} == {"sat", "unsat"}:
        disagree.append(("escape", escape, pin["escape"]))
    if escape == "sat" and not all(eval_term(c, escape_model.assignment)
                                   for c in escape_query(T)):
        invalid.append("escape")
    sats = sum(v == "sat" for v, _, _ in results.values())
    log(f"[solver] {len(corpus)} queries in {wall:.3f} s: {sats} sat witnesses, "
        f"{len(invalid)} invalid; {len(disagree)} sat/unsat disagreements with the JAX pin; "
        f"races started {stats.race_started}, errors {stats.race_errors}; sprint "
        f"{stats.sprint_time * 1e3:.1f} ms, marathon {stats.marathon_time * 1e3:.1f} ms; "
        f"sat from the card {stats.device_sat_count}, from the CDCL {stats.cdcl_sat_count}; "
        f"launches {launches} on {card}")
    log(f"[solver] --parallel-solving escape (card held, no race, {ESCAPE_TIMEOUT_MS} ms): "
        f"{escape} in "
        f"{escape_ms:.1f} ms (JAX pin {pin['escape']}), launches {escape_launches}")
    if disagree or invalid:
        raise SystemExit(f"solver: disagreements {disagree}, invalid witnesses {invalid}")
    if stats.race_errors or resilience.DegradationLog().marker():
        raise SystemExit(f"solver: {stats.race_errors} race errors, degradation log "
                         f"{resilience.DegradationLog().events}")
    if not escape_launches["portfolio_sls"]:
        raise SystemExit("solver: the --parallel-solving escape never launched portfolio_sls")
    return dict(launches=launches)


# phase_explore: the explorer's small-corpus prepass geometry
# (analysis/corpus.py:251-281 of the JAX package: 32 lanes a contract
# under 64 contracts, roomy caps, 512 steps a wave, the -t 2 threat
# model) with a fixed wave cap in place of its wall budget; the corpus
# scale geometry (64 tracks, 16 lanes, lean caps); the milestone corpus
# (__graft_entry__.py:203-204). The wave caps keep the whole script,
# the host walk's phases included, inside its time limit (PERF.md
# section 4).
EXPLORE_LANES = 32
EXPLORE_WAVES = 2
CORPUS_TRACKS = 64
CORPUS_LANES = 16
CORPUS_WAVES = 2
MILESTONE = (("gated_kill", "604260003560f81c14600d57005b33ff"),
             ("always_assert", "fe00000000"))
MILESTONE_KILL_PC = 15
EXPLORE_KERNELS = PATH_KERNELS + FLIP_KERNELS


def explore_kwargs(codes, lanes, waves, mem_cap, storage_cap, **kw):
    from mythril_tpu_torch.laser.batch.explore import required_calldata_len

    return dict(calldata_len=max(required_calldata_len(c) for c in codes),
                lanes_per_contract=lanes, waves=waves, steps_per_wave=512,
                mem_cap=mem_cap, storage_cap=storage_cap, transaction_count=2,
                portfolio_candidates=64, budget_s=None, **kw)


def explore_fingerprint(contract):
    """One contract's issue-bearing outcome: coverage, trigger pcs per
    kind, evidence (class, pc) (the JAX pipeline suite's fingerprint)."""
    return (tuple(map(tuple, contract["covered_branches"])),
            tuple((kind, tuple(sorted(t["pc"] for t in bucket)))
                  for kind, bucket in sorted(contract["triggers"].items())),
            tuple(sorted((e["class"], e["pc"]) for e in contract["evidence"])))


def run_explore(label, codes, names, card, **kw):
    """One DeviceCorpusExplorer run on the card, logged per wave, per
    reseed and per contract; fails on an invalid witness or a
    degradation record. Returns the outcome, the explorer, the kernels'
    launches during the run, its wall and its first wave's snapshot."""
    from mythril_tpu_torch.laser.batch.explore import DeviceCorpusExplorer, snapshot_waves
    from mythril_tpu_torch.support import resilience

    resilience.DegradationLog().reset()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    ex = DeviceCorpusExplorer(codes, **kw)
    snaps = snapshot_waves(ex)
    out = ex.run()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = out["stats"]
    for w in ex.wave_log:
        log(f"[explore {label}] phase {w['txn']} wave {w['serial']}: wall {w['wall_ms']:.1f} "
            f"ms, {w['steps']} steps, {w['active']} active lane-steps of {w['lanes']} lanes, "
            f"readback {w['readback_ms']:.1f} ms (seed {w['seed_ms']:.1f} ms "
            f"{'in place' if w['warm'] else 'cold'}, run {w['run_ms']:.1f} ms, harvest wait "
            f"{w['wait_ms']:.1f} ms) on {card}")
    for r in ex.reseed_log:
        log(f"[explore {label}] reseed for wave {r['wave']}: {r['candidates']} flip candidates "
            f"+ {r['steering']} steering queries, {r['opaque']} opaque targets, {r['lowered']} "
            f"queries lowered, device solve {r['solve_ms']:.1f} ms, verdicts {r['verdicts']}, "
            f"{r['witnesses']} witnesses ({r['witness_invalid']} invalid), {r['deferred']} "
            f"survivors deferred by the host ladder's cap")
    poison = sum(len(t.poison_carries) for t in ex.tracks)
    log(f"[explore {label}] {len(codes)} contracts x {kw['lanes_per_contract']} lanes: "
        f"{wall:.3f} s, {st['waves']} waves over {st['transactions']} phases, {st['device_steps']} "
        f"active lane-steps ({st['device_steps_raw']} raw), carries banked "
        f"{st['carries_banked']}, poison carries {poison} (last phase), forks tried "
        f"{st['forks_tried']} / feasible {st['forks_feasible']}, device sat {st['device_sat']} "
        f"/ unsat {st['device_unsat']} (enumerated {st['device_enumerated']}, cube "
        f"{st['device_cube_sat']}), deferred {ex.ladder_deferred}, waves in flight max "
        f"{st['waves_inflight_max']}, overlapped {st['waves_overlapped']}, "
        f"wave_overlap_ratio {st['wave_overlap_ratio']}, device_idle_frac "
        f"{st['device_idle_frac']}, evidence {st['evidence_bytes']} B of "
        f"{st['evidence_bytes_full']} B, launches {launches} on {card}")
    log(f"[explore {label}] specialization: bucket "
        f"{None if ex.kernel_phases is None else list(ex.kernel_phases.pruned)} pruned, "
        f"block_depth {getattr(ex.kernel_phases, 'block_depth', None)}, "
        f"{st['spec_fused_steps']} fused + {st['blockjit_steps']} block substep lane-steps, "
        f"{st['blockjit_blocks']} blocks entered, {st['blockjit_fallbacks']} blocks not "
        f"lowered, {st['spec_fallbacks']} generic retries")
    for name, contract in zip(names, out["contracts"]):
        cov, trig, evid = explore_fingerprint(contract)
        log(f"[explore {label}] {name}: {len(cov)} directions covered {list(cov)}, triggers "
            f"{dict(trig)}, evidence {list(evid)}, device_complete "
            f"{contract['device_complete']}, corpus {contract['corpus_size']}")
    invalid = sum(r["witness_invalid"] for r in ex.reseed_log)
    if invalid:
        raise SystemExit(f"explore {label}: {invalid} witnesses failed validation")
    degraded = resilience.DegradationLog().marker()
    if degraded:
        raise SystemExit(f"explore {label}: the degradation log holds {degraded}: "
                         f"{resilience.DegradationLog().events}")
    return dict(out=out, explorer=ex, launches=launches, wall=wall,
                first=snaps[0] if snaps else None)


def first_wave_on_cpu(codes, kw):
    """The same explorer's first wave on the CPU (the plain kernels):
    its wave_snapshot, taken before any witness enters. A stop event
    set at the first consume ends the run there."""
    import threading

    from mythril_tpu_torch.laser.batch.explore import DeviceCorpusExplorer, wave_snapshot

    stop = threading.Event()
    ex = DeviceCorpusExplorer(codes, stop_event=stop, **dict(kw, device="cpu"))
    first = []
    consume = ex._consume_wave

    def _consume(view, payload):
        consume(view, payload)
        if not first:
            first.append(wave_snapshot(ex, payload))
            stop.set()

    ex._consume_wave = _consume
    ex.run()
    return first[0]


def first_batch(run):
    """Run `run()` and return its result and the query list of the
    first device_solve_batch call it made (the explorer's first reseed
    that lowered queries), passed on unchanged."""
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf

    real = pf.device_solve_batch
    seen = []

    def recording(queries, **kw):
        if not seen:
            seen.append(list(queries))
        return real(queries, **kw)

    pf.device_solve_batch = recording
    try:
        return run(), seen[0] if seen else []
    finally:
        pf.device_solve_batch = real


def hold_batch_to_plain(label, queries, card):
    """A real reseed's queries, compiled as device_solve_batch compiles
    them, the first BATCH_CHECK_Q of them (the launch plan follows the
    programs' padded sizes, not Q; the plain search's CPU time grows with
    Q): portfolio_sls over all of
    them in one launch, at the plan's choice, bit-equal to sls_plain
    (SLS_CHECK_STEPS steps, the explorer's 64 candidates), and
    portfolio_eval on each at K = 64 random candidates equal to
    eval_plain. Both plain versions run on CPU copies."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.ops import portfolio_eval as pe
    from mythril_tpu_torch.ops import portfolio_sls as ps

    progs = []
    for q in queries:
        prog, _dropped, _loss = pf.compile_program_relaxed(q)
        if prog is not None and prog.var_slots:
            progs.append(prog)
    progs = progs[:BATCH_CHECK_Q]
    if not progs:
        raise SystemExit(f"explore {label}: the first batch compiled no program to check")
    knobs = dict(pf.PORTFOLIO_DEFAULTS)
    t0 = time.perf_counter()
    want = ps.sls_plain(*pf.stack_programs(progs, "cpu"), seed=7, steps=SLS_CHECK_STEPS,
                        K=64, **ps.search_args(64, knobs))
    sls_plain_s = time.perf_counter() - t0
    got = ps.portfolio_sls(*pf.stack_programs(progs, "cuda"), seed=7, steps=SLS_CHECK_STEPS,
                           K=64, knobs=knobs)
    sync()
    sls_bad = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
    plan = plan_text(sls_stack_plan(progs, 64))
    rng = np.random.default_rng(6)
    eval_bad = 0
    for prog in progs:
        X = rand_candidates(rng, prog, 64)
        want = pe.eval_plain(*pe.program_tensors(prog, "cpu"), torch.as_tensor(X),
                             n_nodes=prog.n_real_nodes)
        got_e = pe.portfolio_eval(*pe.program_tensors(prog, "cuda"),
                                  torch.as_tensor(X, device="cuda"), n_nodes=prog.n_real_nodes)
        eval_bad += int((got_e[0].cpu() != want[0]).sum() + (got_e[1].cpu() != want[1]).sum())
    sync()
    log(f"[explore {label}] the first batch's {len(queries)} queries, {len(progs)} programs "
        f"checked (L {sorted({p.limbs for p in progs})}, up to "
        f"{max(p.n_real_nodes for p in progs)} nodes): portfolio_sls Q={len(progs)} K=64 "
        f"{SLS_CHECK_STEPS} steps ({plan}) {sls_bad} mismatches against sls_plain, "
        f"{int(got[0].sum())} solved; portfolio_eval K=64 on each: {eval_bad} mismatches "
        f"against eval_plain (CPU: sls_plain {sls_plain_s:.1f} s, in all "
        f"{time.perf_counter() - t0:.1f} s) on {card}")
    if sls_bad or eval_bad:
        raise SystemExit(f"explore {label}: the portfolio kernels disagree with their plain "
                         f"versions on the first batch: sls {sls_bad}, eval {eval_bad}")


#: stats a wave snapshot holds that count the process's history, not
#: the wave: the kernel cache's lookups (a bucket the card run missed is
#: a hit for the CPU run that follows it)
PROCESS_STATS = ("kernel_cache_hits", "kernel_cache_misses")


def hold_first_wave(label, codes, kw, card_first):
    """The leg's first wave on the card against the same explorer's
    first wave on the CPU (every snapshot field but PROCESS_STATS)."""
    t0 = time.perf_counter()
    cpu_first = first_wave_on_cpu(codes, kw)
    for snap in (cpu_first, card_first):
        for key in PROCESS_STATS:
            snap["stats"].pop(key)
    if cpu_first != card_first:
        differ = [k for k in cpu_first if cpu_first[k] != card_first[k]]
        raise SystemExit(f"explore {label}: the first wave differs from the CPU's in {differ}")
    log(f"[explore {label}] first wave equal to a device='cpu' run of the same explorer "
        f"(seeded calldata, coverage, triggers, evidence, carries, every count; CPU "
        f"{time.perf_counter() - t0:.1f} s)")


def phase_explore(card):
    """The device explorer (laser/batch/explore.py) on the card: leg A at
    the small-corpus prepass geometry, pipelined then lock-step (the
    default) with the same seed; leg B at corpus scale, its first wave
    held to a CPU run and its first batch of queries to the portfolio's
    plain versions; leg C on the milestone corpus, its first wave held
    to a CPU run. Legs B and C take the default schedule. The host
    ladder is off here (a zero cap: every device survivor deferred), as
    this phase has measured the funnel since it was written; the analyze
    phase runs the ladder."""
    from mythril_tpu_torch.support.support_args import args

    saved = args.sprint_cap_s
    args.sprint_cap_s = 0.0
    try:
        return _phase_explore(card)
    finally:
        args.sprint_cap_s = saved


def _phase_explore(card):
    from mythril_tpu_torch.laser import symbolic_wave as wave

    codes = [c.hex() for c in wave.load_contracts()]
    names = [p.name for p in sorted(wave.CONTRACTS.glob("*.sol.o"))]
    kw = explore_kwargs(codes, EXPLORE_LANES, EXPLORE_WAVES, 16384, 128)
    log(f"[explore] leg A: {len(codes)} vendored contracts x {EXPLORE_LANES} lanes, "
        f"calldata {kw['calldata_len']} B, mem_cap 16384, storage_cap 128, 512 steps a wave, "
        f"{EXPLORE_WAVES} waves a phase, 2 transactions, 64 candidates, cube depth 3")
    piped = run_explore("A pipelined", codes, names, card, pipeline=True, **kw)
    lock = run_explore("A lock-step", codes, names, card, pipeline=False, **kw)
    for name in EXPLORE_KERNELS + ("block_substep",):
        if not (piped["launches"][name] and lock["launches"][name]):
            raise SystemExit(f"explore leg A never launched {name} in one schedule")
    same = differ = 0
    for name, p, q in zip(names, piped["out"]["contracts"], lock["out"]["contracts"]):
        fp, fq = explore_fingerprint(p), explore_fingerprint(q)
        if fp == fq:
            same += 1
            continue
        differ += 1
        only_p = sorted(set(fp[0]) - set(fq[0]))
        only_q = sorted(set(fq[0]) - set(fp[0]))
        log(f"[explore A] {name}: the schedules differ: covered only pipelined {only_p}, only "
            f"lock-step {only_q}; triggers {dict(fp[1])} / {dict(fq[1])}; evidence "
            f"{list(fp[2])} / {list(fq[2])}")
        if fp[1:] != fq[1:]:
            raise SystemExit(f"explore leg A: {name}'s triggers or evidence differ between "
                             f"the schedules")
    log(f"[explore A] fingerprints: {same} contracts equal under both schedules, {differ} "
        f"differ in coverage only")

    tracks = [codes[i % len(codes)] for i in range(CORPUS_TRACKS)]
    track_names = [names[i % len(names)] for i in range(CORPUS_TRACKS)]
    kw_b = explore_kwargs(tracks, CORPUS_LANES, CORPUS_WAVES, 4096, 64)
    log(f"[explore] leg B: {CORPUS_TRACKS} tracks cycling the {len(codes)} contracts x "
        f"{CORPUS_LANES} lanes ({CORPUS_TRACKS * CORPUS_LANES} lanes), mem_cap 4096, "
        f"storage_cap 64, {CORPUS_WAVES} waves a phase, 2 transactions")
    corpus, batch = first_batch(lambda: run_explore("B", tracks, track_names, card, **kw_b))
    sizes = [r["lowered"] for r in corpus["explorer"].reseed_log]
    log(f"[explore B] queries a device_solve_batch: {sizes} (largest {max(sizes, default=0)})")
    hold_first_wave("B", tracks, kw_b, corpus["first"])
    hold_batch_to_plain("B", batch, card)

    m_codes = [code for _, code in MILESTONE]
    kw_c = explore_kwargs(m_codes, EXPLORE_LANES, EXPLORE_WAVES, 16384, 128)
    log(f"[explore] leg C: the milestone corpus {[n for n, _ in MILESTONE]} x "
        f"{EXPLORE_LANES} lanes, mem_cap 16384, storage_cap 128, {EXPLORE_WAVES} waves a "
        f"phase, 2 transactions")
    mile = run_explore("C", m_codes, [n for n, _ in MILESTONE], card, **kw_c)
    gated, asserts = mile["out"]["contracts"]
    kills = [t for t in gated["triggers"].get("selfdestruct", [])
             if t["pc"] == MILESTONE_KILL_PC and bytes.fromhex(t["input"])[:1] == b"\x42"]
    if not kills:
        raise SystemExit(f"explore leg C: no selfdestruct at pc {MILESTONE_KILL_PC} with input "
                         f"byte 0 = 0x42 in gated_kill: {gated['triggers']}")
    if not any(t["pc"] == 0 for t in asserts["triggers"].get("assert-violation", [])):
        raise SystemExit(f"explore leg C: no assert-violation at pc 0 in always_assert: "
                         f"{asserts['triggers']}")
    log(f"[explore C] gated_kill: selfdestruct at pc {MILESTONE_KILL_PC}, input "
        f"{kills[0]['input'][:8]}..., prefix {kills[0]['prefix']}; always_assert: "
        f"assert-violation at pc 0")
    hold_first_wave("C", m_codes, kw_c, mile["first"])
    return dict(launches=lock["launches"], piped_launches=piped["launches"],
                corpus_launches=corpus["launches"], milestone_launches=mile["launches"])


# phase_analyze: `python -m mythril_tpu_torch analyze` and analyze_corpus
# on the card. The 13 vendored contracts run twice at the small-corpus
# prepass geometry (32 lanes a contract, 2 transactions) with the waves a
# phase capped at VENDORED_WAVES (8, the JAX package's cap is 48), both
# with the host escalation ladder on: (a) pinned, with the ladder at
# VENDORED_LADDER_CAP_S (it does not bind) under deterministic_solving
# and the enumeration-only device solver, from a fresh solver session in
# a process of its own, held to the JAX pin VENDORED_LADDER_PIN (per
# contract: name, owned, issue fingerprints; made by
# `tests/test_torch_analyze.py --pin-vendored-ladder`); (b) the default:
# the card's whole funnel, then the ladder at its default cap.
VENDORED_WAVES = 8
VENDORED_LADDER_PIN = ROOT / "tests" / "test_torch_analyze_vendored_ladder_pinned.json"
VENDORED_LADDER_CAP_S = 120.0
#: a vendored contract the device does not own, through the command line
CLI_UNOWNED = "origin.sol.o"
#: analyze (b)'s race gate: INVALID behind x * y == ESCAPE_N for two
#: 32-bit calldata words above 1 (x, y = CALLDATALOAD(0), (32) & 2**32 - 1).
#: Whether a vendored walk query outlasts the CDCL sprint's wall cap, and
#: so races, depends on the host's speed (0-7 races a run on an H100); this
#: query outlasts its conflict budget on any host, so its walk races the
#: card every run. Its walk queries get RACE_GATE_TIMEOUT_MS each.
RACE_GATE = ("600035" "63ffffffff16" "602035" "63ffffffff16" "81600110" "81600110" "16" "91"
             "02" "67" + (2690070737 * 3210234581).to_bytes(8, "big").hex()
             + "14" "16" "602c" "57" "00" "5b" "fe")
RACE_GATE_TIMEOUT_MS = 3000
ANALYZE_SWC = {"gated_kill": ("106", 15, "Unprotected Selfdestruct", "High"),
               "always_assert": ("110", 0, "Exception State", "Medium")}
#: a provably clean contract (the JAX corpusgen's clean_contract(0)): every
#: detection module screens off, so analyze answers it statically
CLEAN = ("clean", "600035" "60e01c" "80" "63c0ffee00" "14" "601a" "57" "630ddba110" "14"
         "6024" "57" "00" "5b" "6001" "6002" "01" "6000" "55" "00"
         "5b" "602a" "6000" "52" "6020" "6000" "f3")
#: the JAX `myth lint` rows of the 13 vendored contracts (no wall times, no
#: contract names; tests/test_torch_static.py --pin-lint)
LINT_PIN = ROOT / "tests" / "test_torch_static_lint_pinned.json"
STATIC_COUNTERS = ("static_summaries", "static_pruned_flips", "static_seeds_dropped")


#: the JAX facade's results on the command line's defaults
#: (tests/test_torch_facade.py --pin-facade, "chip")
FACADE_PIN = ROOT / "tests" / "test_torch_facade_pinned.json"
#: a --deadline that expires during the first walk of the deadline check's
#: corpus, the race gate's (its queries outlast the CDCL sprint on any
#: host, and clamp to the deadline), before gated_kill and always_assert
FACADE_DEADLINE_S = 1.0
#: the facade's corpus check: the milestone corpus, CLEAN, and HASHKILL,
#: the one whose waves run SHA3 (no other does, so keccak_sponge would
#: not launch)
FACADE_CORPUS_NAMES = ("gated_kill", "always_assert", "clean", "hashkill")


def facade_cli(*argv, command="analyze"):
    """One `python -m mythril_tpu_torch COMMAND ARGV` in this process
    (`cli.main`, which the module's entry calls), on the card: (exit
    code, stdout, stderr, seconds). In-process, so that the kernels stay
    loaded and the launch counters read the run; the flag bag is put
    back after, so later phases keep their own settings."""
    import contextlib
    import io

    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args as flags

    saved = dict(vars(flags))
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = cli.main([command, *argv])
            except SystemExit as exit_:
                rc = exit_.code
    finally:
        vars(flags).clear()
        vars(flags).update(saved)
    sync()
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def facade_fingerprints(doc):
    """{contract file name: sorted [swc-id, address, title, severity,
    function]} of a json report (the facade pin's form)."""
    out = {}
    for i in doc["issues"]:
        out.setdefault(Path(i["contract"]).name, []).append(
            [i["swc-id"], i["address"], i["title"], i["severity"], i["function"]])
    return {name: sorted(rows) for name, rows in out.items()}


@contextmanager
def recorded_prepasses():
    """Every OverlappedPrepass the facade starts, with its device, its
    final outcomes, how many walks it served with the device off, and
    how long the walks (this thread) waited on HOST_SYMBOLIC_LOCK."""
    import threading

    from mythril_tpu_torch.analysis import corpus

    real = corpus.OverlappedPrepass
    seen = []

    class TimedLock:
        def __init__(self, lock, record):
            self.lock, self.record = lock, record

        def __enter__(self):
            t0 = time.perf_counter()
            self.lock.acquire()
            if threading.current_thread() is threading.main_thread():
                self.record["walk_lock_wait_s"] += time.perf_counter() - t0
            return self

        def __exit__(self, *exc):
            self.lock.release()

    class Recorded(real):
        def __init__(self, *a, **kw):
            self.record = {"device": str(kw.get("device")), "ownership": kw.get("ownership"),
                           "walk_lock_wait_s": 0.0, "final": None, "t0": time.perf_counter()}
            seen.append(self.record)
            super().__init__(*a, **kw)
            self.lock = TimedLock(self.lock, self.record)

        def finish(self):
            final = super().finish()
            self.record.update(final=final, deviceless=self.deviceless,
                               wall_s=time.perf_counter() - self.record["t0"])
            return final

    corpus.OverlappedPrepass = Recorded
    try:
        yield seen
    finally:
        corpus.OverlappedPrepass = real


def prepass_line(rec):
    """The overlapped prepass's numbers, for the log."""
    stats = next((o["stats"] for o in (rec["final"] or {}).values() if o.get("stats")), {})
    return (f"prepass on {rec['device']}: {stats.get('waves')} waves, "
            f"{stats.get('wall_s')} s of exploration, {rec.get('wall_s', 0):.3f} s "
            f"start to finish; {rec.get('deviceless')} walk(s) device-less; the walks waited "
            f"{rec['walk_lock_wait_s']:.3f} s on HOST_SYMBOLIC_LOCK")


def static_counters(explorers):
    """The explorers' static-pass counters, summed."""
    return {k: sum(getattr(e.stats, k) for e in explorers) for k in STATIC_COUNTERS}


def spec_counters(explorers):
    """The explorers' specialization counters: the bucket's (the JAX pin
    holds `specialized`, `spec_pruned_phases` and `blockjit_fallbacks`)
    and the substeps' work, with `specialize_failed`."""
    out = {k: max((getattr(e.stats, k) for e in explorers), default=0)
           for k in ("specialized", "spec_pruned_phases", "blockjit_fallbacks")}
    out.update({k: sum(getattr(e.stats, k) for e in explorers)
                for k in ("spec_fused_steps", "blockjit_steps", "blockjit_blocks",
                          "spec_fallbacks")})
    out["specialize_failed"] = sum(e.specialize_failed for e in explorers)
    return out


def walk_lines(results):
    """Per walked contract: its seconds, states and the modules the
    static screen left out (of the 14)."""
    from mythril_tpu_torch.analysis.module import ModuleLoader

    every = sorted(type(m).__name__ for m in ModuleLoader().get_detection_modules())
    out = {}
    for r in results:
        if r.get("owned") or r.get("static_answered") or "static_screen" not in r:
            continue
        screen = r["static_screen"]
        out[r["name"]] = {"walk_s": r["wall_s"], "states": r["states"],
                          "mounted": len(every) if screen is None else len(screen),
                          "skipped": [] if screen is None else sorted(set(every) - set(screen))}
    return out


def enum_only_solver(pf, **enum_kw):
    """A `device_solve_batch` that only enumerates (`device_enumerate`),
    as tests/test_torch_explore.py builds it: a verdict depends on the
    query alone."""

    def solve(queries, **_kw):
        out = []
        for q in queries:
            prog, _, loss = pf.compile_program_relaxed(q)
            if prog is None or not prog.var_slots:
                out.append(pf.DeviceVerdict("unknown", None, loss or "QUERY_TRIVIAL", None))
                continue
            verdict, asn = pf.device_enumerate(prog, **enum_kw)
            if verdict == "unknown":
                out.append(pf.DeviceVerdict("unknown", None, "SLS_NONCONVERGED", None))
            else:
                out.append(pf.DeviceVerdict(verdict, asn, None, "enum"))
        return out

    return solve


def vendored_rows():
    from mythril_tpu_torch.laser import symbolic_wave as wave

    return [(p.read_text().strip(), "", p.name) for p in sorted(wave.CONTRACTS.glob("*.sol.o"))]


def issue_fingerprints(result):
    return sorted([i["swc-id"], i["address"], i["title"], i["severity"], i["function"],
                   i["description"]] for i in result["issues"])


@contextmanager
def recorded_explorers():
    """The DeviceCorpusExplorers run inside, in a list (for their
    ladder_deferred)."""
    from mythril_tpu_torch.laser.batch import explore

    seen, run = [], explore.DeviceCorpusExplorer.run

    def recording(self):
        seen.append(self)
        return run(self)

    explore.DeviceCorpusExplorer.run = recording
    try:
        yield seen
    finally:
        explore.DeviceCorpusExplorer.run = run


def replay_all(results):
    """(witnesses replayed, [(contract, swc, pc) of a device witness that
    does not replay], [(contract, swc, pc) of a host walk's witness that
    does not]) on the CPU. A device witness (`provenance` device-...)
    claims that it replays on the concrete interpreter; a walk's witness
    is the walk's model, whose block context and call results the
    interpreter's replay context may not give, so it is counted, not
    held."""
    from mythril_tpu_torch.analysis.replay import replays_to

    done, bad, walk_bad = 0, [], []
    for r in results:
        for i in r["issues"]:
            done += 1
            if not replays_to(i, device="cpu"):
                where = bad if i.get("provenance", "").startswith("device") else walk_bad
                where.append((r["name"], i["swc-id"], i["address"]))
    return done, bad, walk_bad


@contextmanager
def timed_walks(spent):
    """corpus._analyze_one timed inside: its seconds added to
    spent["walk"], the kernels' launches during it to spent["launches"]
    (the solver races' portfolio_eval and portfolio_sls). A race the
    CDCL beat runs on in its thread; the walk's window waits for it, so
    that its launch counts here."""
    from mythril_tpu_torch.analysis import corpus
    from mythril_tpu_torch.laser.smt.solver import device_race

    walk = corpus._analyze_one

    def timing(*a, **kw):
        before = read_launches()
        t0 = time.perf_counter()
        try:
            return walk(*a, **kw)
        finally:
            if not device_race.wait_idle(timeout=120):
                raise SystemExit("a race of the walk was still running after 120 s")
            sync()
            spent["walk"] += time.perf_counter() - t0
            after = read_launches()
            for name in after:
                spent["launches"][name] = spent["launches"].get(name, 0) + after[name] - before[name]

    corpus._analyze_one = timing
    try:
        yield
    finally:
        corpus._analyze_one = walk


def vendored_ladder_run(out_path, device=None):
    """(a) in its own process (`chip_smoke.py --vendored-ladder OUT`):
    the 13 vendored contracts through analyze_corpus with the ladder at
    VENDORED_LADDER_CAP_S under deterministic_solving, the
    enumeration-only device solver, a fresh solver session and memo
    cache, every contract the device does not own walked on the host;
    writes the per-contract results (with the states each walk took),
    host_sat, ladder_deferred, the wall and the walks' share of it, the
    kernels' launches, the witnesses' replays and the degradation log to
    OUT as JSON."""
    from mythril_tpu_torch.analysis import corpus
    from mythril_tpu_torch.laser.smt.solver import portfolio as pf
    from mythril_tpu_torch.laser.smt.solver import solver as S
    from mythril_tpu_torch.support import model, resilience
    from mythril_tpu_torch.support.support_args import args

    args.deterministic_solving = True
    args.sprint_cap_s = VENDORED_LADDER_CAP_S
    S.reset_blast_session()
    model.clear_cache()
    pf.device_solve_batch = enum_only_solver(pf, device=device)
    rows = vendored_rows()
    resilience.DegradationLog().reset()
    sync()
    reset_launches()
    spent = {"walk": 0.0, "launches": {}}
    t0 = time.perf_counter()
    with recorded_explorers() as explorers, timed_walks(spent):
        results = corpus.analyze_corpus(rows, transaction_count=2, execution_timeout=86400,
                                        waves=VENDORED_WAVES, device=device)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = next((r["device_prepass"] for r in results if r.get("device_prepass")), {})
    replayed, not_replayed, walk_not_replayed = replay_all(results)
    Path(out_path).write_text(json.dumps({
        "contracts": [[r["name"], bool(r.get("owned")), issue_fingerprints(r)] for r in results],
        "errors": {r["name"]: r.get("error") or r.get("skipped")
                   for r in results if not r["complete"]},
        "states": {r["name"]: r["states"] for r in results if not r.get("owned")},
        "host_sat": stats.get("host_sat"), "waves": stats.get("waves"),
        "ladder_deferred": sum(e.ladder_deferred for e in explorers), "wall_s": wall,
        "walk_s": spent["walk"], "launches": launches, "launches_walk": spent["launches"],
        "replayed": replayed, "not_replayed": not_replayed,
        "walk_not_replayed": walk_not_replayed,
        "static": static_counters(explorers), "walks": walk_lines(results),
        "spec": spec_counters(explorers),
        "static_answered": sorted(r["name"] for r in results if r.get("static_answered")),
        "static_prune": args.static_prune, "static_answer": args.static_answer,
        "degraded": resilience.DegradationLog().counts}))


def facade_checks(card):
    """The command line, through the analyzer facade, on the card, in
    this process (`facade_cli`), each run held to the JAX facade's pin
    (FACADE_PIN): `-c` gated_kill and `-c` HASHKILL (SymExecWrapper's own
    prepass, then the walk; together `launches_facade`), `-c` gated_kill
    under `--no-specialize` and `-c` always_assert under `--no-blockjit`,
    the four-file corpus (FACADE_CORPUS_NAMES: the overlapped prepass
    beside the walks, `launches_facade_corpus`), the same corpus under
    `--device-ownership never`, origin.sol.o through `-f` (the device does
    not own it), `--deadline` expiring mid-corpus (partial, exit 0; with
    `--on-timeout fail`, exit 1), `--device-solving never` on the race
    gate (no portfolio launch, the gate closed), `-j` and `-g`,
    `disassemble` and `function-to-hash` against the JAX text, and
    `lint` against the JAX rows."""
    import tempfile

    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.smt.solver import device_race

    pin = json.loads(FACADE_PIN.read_text())["chip"]
    out = {}
    # -c: one contract, its own device prepass then the walk
    reset_launches()
    for name, code in (MILESTONE[0], ("hashkill", HASHKILL)):
        rc, text, err, secs = facade_cli("--bin-runtime", "-c", code, "-t", "2", "-o", "json")
        doc = json.loads(text) if rc in (0, 1) else {}
        got = facade_fingerprints(doc) if doc else None
        log(f"[facade] -c {name}: exit {rc}, {secs:.1f} s, issues {got} on {card}")
        if rc != 0 or doc.get("partial") or got != pin[name]:
            raise SystemExit(f"facade: -c {name} gave exit {rc}, {got}; want the JAX "
                             f"facade's {pin[name]}; stderr {err[-2000:]!r}")
    device_race.wait_idle()
    out["launches"] = read_launches()
    log(f"[facade] -c launches {out['launches']}")
    check_path_launches("facade's -c runs", out["launches"])
    # each milestone contract alone, one on the generic kernel and one on
    # the fuse-only kernels (the flags reach SymExecWrapper's explorer
    # through the flag bag): the same issues as the default's
    for (name, code), flag in zip(MILESTONE, ("--no-specialize", "--no-blockjit")):
        reset_launches()
        with recorded_explorers() as explorers:
            rc, text, err, secs = facade_cli("--bin-runtime", "-c", code, "-t", "2", "-o",
                                             "json", flag)
        device_race.wait_idle()
        spent = read_launches()
        doc = json.loads(text) if rc in (0, 1) else {}
        got = facade_fingerprints(doc) if doc else None
        want = {"MAIN": [list(ANALYZE_SWC[name]) + ["fallback"]]}
        spec = spec_counters(explorers)
        log(f"[facade] -c {name} {flag}: exit {rc}, {secs:.1f} s, issues {got}, "
            f"{len(explorers)} explorer(s), specialization {spec}, launches {spent}")
        off = (spec["specialized"] == 0 if flag == "--no-specialize"
               else spec["blockjit_steps"] == 0 and spent["block_substep"] == 0)
        if rc != 0 or doc.get("partial") or got != want or not explorers or not off:
            raise SystemExit(f"facade: -c {name} {flag} gave exit {rc}, {got}, specialization "
                             f"{spec}; want {want} with {flag} in force; stderr {err[-2000:]!r}")
    with tempfile.TemporaryDirectory() as tmp:
        codes = dict((MILESTONE + (CLEAN, ("hashkill", HASHKILL))))
        files = []
        for name in FACADE_CORPUS_NAMES:
            (Path(tmp) / name).write_text(codes[name] + "\n")
            files += ["-f", str(Path(tmp) / name)]
        # the corpus: the overlapped prepass beside the walks
        reset_launches()
        with recorded_prepasses() as pres:
            rc, text, err, secs = facade_cli("--bin-runtime", *files, "-t", "2", "-o", "json")
        device_race.wait_idle()
        out["launches_corpus"] = read_launches()
        doc = json.loads(text) if rc in (0, 1) else {}
        got = facade_fingerprints(doc) if doc else None
        swcs = sorted({row[0] for rows in (got or {}).values() for row in rows})
        log(f"[facade] the milestone corpus, CLEAN and HASHKILL as four -f files: exit {rc}, "
            f"{secs:.1f} s, issues {got}, partial {doc.get('partial', False)}; "
            f"{prepass_line(pres[0]) if pres else 'no prepass'}; launches "
            f"{out['launches_corpus']}")
        if rc != 0 or doc.get("partial") or got != pin["corpus"] or swcs != ["106", "110"] \
                or len(pres) != 1 or not pres[0]["device"].startswith("cuda"):
            raise SystemExit(f"facade: the corpus gave exit {rc}, {got}, prepasses "
                             f"{[prepass_line(p) for p in pres]}; "
                             f"want the JAX facade's {pin['corpus']}; stderr {err[-2000:]!r}")
        check_path_launches("facade's corpus run", out["launches_corpus"])
        out["corpus_s"], out["prepass"] = secs, {
            k: v for k, v in pres[0].items() if k not in ("final", "t0")}
        # the same corpus, the prepass owning nothing: the same issues
        with recorded_prepasses() as pres:
            rc, text, err, secs = facade_cli("--bin-runtime", *files, "-t", "2", "-o", "json",
                                             "--device-ownership", "never")
        device_race.wait_idle()
        doc = json.loads(text) if rc in (0, 1) else {}
        got = facade_fingerprints(doc) if doc else None
        log(f"[facade] the four files under --device-ownership never: exit {rc}, {secs:.1f} s, "
            f"issues {got}, prepass ownership {[p['ownership'] for p in pres]}")
        if rc != 0 or doc.get("partial") or got != pin["corpus"] \
                or [p["ownership"] for p in pres] != [False]:
            raise SystemExit(f"facade: --device-ownership never gave exit {rc}, {got}; want the "
                             f"JAX facade's {pin['corpus']}; stderr {err[-2000:]!r}")
        # --deadline: expires during the first walk, the rest skipped
        (Path(tmp) / "race_gate").write_text(RACE_GATE + "\n")
        deadline_files = ["-f", str(Path(tmp) / "race_gate")] + files[:4]
        argv = ("--bin-runtime", *deadline_files, "-t", "2", "-o", "json", "--deadline",
                str(FACADE_DEADLINE_S))
        rc, text, err, secs = facade_cli(*argv)
        doc = json.loads(text)
        status = [(Path(c["contract"]).name, c["complete"], c.get("skipped"))
                  for c in doc.get("degradation", {}).get("contracts", [])]
        log(f"[facade] --deadline {FACADE_DEADLINE_S}: exit {rc}, {secs:.1f} s, partial "
            f"{doc.get('partial')}, contracts {status}")
        if rc != 0 or not doc.get("partial") or not any(c[1] for c in status) \
                or not any(c[2] for c in status):
            raise SystemExit(f"facade: --deadline gave exit {rc}, {status}; want a partial "
                             f"report with complete and skipped contracts")
        rc, text, err, secs = facade_cli(*argv, "--on-timeout", "fail")
        log(f"[facade] --deadline {FACADE_DEADLINE_S} --on-timeout fail: exit {rc}, "
            f"{secs:.1f} s, {text.strip()[:200]!r}")
        if rc != 1 or "Analysis deadline expired" not in text:
            raise SystemExit(f"facade: --on-timeout fail gave exit {rc}, {text[-500:]!r}")
    # a contract the device does not own, walked on the host
    rc, text, err, secs = facade_cli("--bin-runtime", "-f", str(wave.CONTRACTS / CLI_UNOWNED),
                                     "-t", "2", "-o", "json")
    doc = json.loads(text)
    got = facade_fingerprints(doc)
    log(f"[facade] -f {CLI_UNOWNED} (not owned): exit {rc}, {secs:.1f} s, issues {got}")
    if rc != 0 or doc.get("partial") or got != pin[CLI_UNOWNED]:
        raise SystemExit(f"facade: -f {CLI_UNOWNED} gave exit {rc}, {got}; want the JAX "
                         f"facade's {pin[CLI_UNOWNED]}")
    # --device-solving never: the race gate's walk starts no race
    reset_launches()
    rc, text, err, secs = facade_cli(
        "--bin-runtime", "-c", RACE_GATE, "-t", "1", "-o", "jsonv2", "--device-prepass", "never",
        "--device-solving", "never", "--solver-timeout", str(RACE_GATE_TIMEOUT_MS))
    device_race.wait_idle()
    spent = read_launches()
    (doc,) = json.loads(text)
    losses = doc["meta"].get("solver_loss_reasons", {})
    log(f"[facade] --device-solving never on the race gate: exit {rc}, {secs:.1f} s, issues "
        f"{[i['swcID'] for i in doc['issues']]}, loss reasons {losses}, launches {spent}")
    if rc != 0 or spent["portfolio_sls"] or spent["portfolio_eval"] \
            or not losses.get("GATE_DISABLED") or losses.get("RACE_NOT_STARTED"):
        raise SystemExit(f"facade: --device-solving never gave exit {rc}, launches {spent}, "
                         f"losses {losses}")
    # -j and -g
    with tempfile.TemporaryDirectory() as tmp:
        space, graph = Path(tmp) / "space.json", Path(tmp) / "graph.html"
        rc_j, _, _, secs_j = facade_cli("--bin-runtime", "-c", MILESTONE[0][1], "-j", str(space))
        rc_g, _, _, secs_g = facade_cli("--bin-runtime", "-c", MILESTONE[0][1], "-g", str(graph))
        nodes_edges = ([len(v) for v in (lambda d: (d["nodes"], d["edges"]))(
            json.loads(space.read_text()))] if space.exists() else None)
        html = graph.read_text() if graph.exists() else ""
    log(f"[facade] -j: exit {rc_j}, {secs_j:.1f} s, nodes and edges {nodes_edges} (JAX "
        f"{pin['statespace']}); -g: exit {rc_g}, {secs_g:.1f} s, {len(html)} bytes of HTML")
    if rc_j or rc_g or nodes_edges != pin["statespace"] or "vis.Network" not in html:
        raise SystemExit(f"facade: -j/-g gave {rc_j}, {rc_g}, {nodes_edges}")
    # the host-only commands against the JAX text
    argv = pin["disassemble"]["argv"]
    rc, text, _, _ = facade_cli(*argv[1:], command=argv[0])
    rc_h, text_h, _, _ = facade_cli(pin["function_to_hash"]["signature"],
                                    command="function-to-hash")
    log(f"[facade] disassemble {argv[-1]}: exit {rc}, {len(text.splitlines())} lines, equal to "
        f"the JAX text {text == pin['disassemble']['stdout']}; function-to-hash "
        f"{text_h.strip()}")
    if rc or rc_h or text != pin["disassemble"]["stdout"] \
            or text_h != pin["function_to_hash"]["stdout"]:
        raise SystemExit("facade: disassemble or function-to-hash differ from the JAX text")
    # the static layer alone, no card: the JAX `myth lint` rows, from an
    # empty summary cache as in a fresh process (the explorers of the
    # earlier phases count their dropped seeds on the cached summaries)
    from mythril_tpu_torch.analysis.static.summary import clear_static_cache

    clear_static_cache()
    lint_pin = json.loads(LINT_PIN.read_text())
    files = [a for path in lint_pin["paths"] for a in ("-f", path)]
    rc, text, _, secs = facade_cli(*files, "-o", "json", command="lint")
    rows = [{k: v for k, v in row.items() if k not in ("contract", "wall_ms")}
            for row in json.loads(text)]
    for row in rows:
        row["taint"].pop("wall_ms", None)
    differ = [path for path, got, want in zip(lint_pin["paths"], rows, lint_pin["rows"])
              if got != want]
    log(f"[facade] lint on the {len(rows)} vendored contracts: exit {rc}, {secs:.1f} s, "
        f"{len(rows) - len(differ)} rows equal to the JAX pin, findings "
        f"{sum(len(r['findings']) for r in rows)}")
    if rc != 0 or len(rows) != len(lint_pin["rows"]) or differ:
        raise SystemExit(f"lint: exit {rc}, rows unlike the JAX pin: {differ}")
    return out


#: ab_overlap's visits: the facade's schedule (overlapped) against the
#: prepass drained before the first walk, in turns
AB_OVERLAP_VISITS = ("overlapped", "prepass-first", "prepass-first", "overlapped")


def ab_overlap(card):
    """`--ab-overlap`: the 13 vendored contracts through `analyze` (the
    facade, its defaults, in this process), the overlapped corpus
    prepass (the walks beside it, the JAX facade's schedule) against the
    prepass run first (drained before the first walk, so that every walk
    gets the final outcome and the whole card: the JAX `analyze_corpus`
    order on a single core, analysis/corpus.py:1420-1470 of the JAX
    package), in turns. Prints each visit's wall, the prepass's waves and
    wall, the device-less walks and the walks' lock waits, and whether
    the issue sets agree."""
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.mythril import MythrilAnalyzer

    files = [a for path in sorted(wave.CONTRACTS.glob("*.sol.o")) for a in ("-f", str(path))]
    start = MythrilAnalyzer._corpus_prepass
    drains = []

    def prepass_first(self, transaction_count):
        pre = start(self, transaction_count)
        t0 = time.perf_counter()
        pre.drain()
        drains.append(time.perf_counter() - t0)
        return pre

    visits = []
    for label in AB_OVERLAP_VISITS:
        if label == "prepass-first":
            MythrilAnalyzer._corpus_prepass = prepass_first
        try:
            with recorded_prepasses() as pres:
                rc, text, err, secs = facade_cli("--bin-runtime", *files, "-t", "2", "-o",
                                                 "json")
        finally:
            MythrilAnalyzer._corpus_prepass = start
        doc = json.loads(text)
        fps = facade_fingerprints(doc)
        visits.append({"schedule": label, "wall_s": round(secs, 3), "exit": rc,
                       "partial": bool(doc.get("partial")),
                       "issues": sum(len(v) for v in fps.values()),
                       "drain_s": round(drains[-1], 3) if label == "prepass-first" else None,
                       "deviceless": pres[0].get("deviceless"),
                       "walk_lock_wait_s": round(pres[0]["walk_lock_wait_s"], 3),
                       "fingerprints": fps})
        log(f"[ab-overlap] {label}: exit {rc}, {secs:.1f} s, {visits[-1]['issues']} issues; "
            f"{prepass_line(pres[0])} on {card}")
        if rc != 0:
            raise SystemExit(f"ab-overlap: {label} exited {rc}: {err[-2000:]!r}")
    same = all(v["fingerprints"] == visits[0]["fingerprints"] for v in visits)
    for visit in visits[1:]:
        for name in sorted(set(visit["fingerprints"]) | set(visits[0]["fingerprints"])):
            a = {tuple(r) for r in visits[0]["fingerprints"].get(name, [])}
            b = {tuple(r) for r in visit["fingerprints"].get(name, [])}
            if a != b:
                log(f"[ab-overlap] {visit['schedule']} visit against the first, {name}: "
                    f"only in the first {sorted(a - b)}, only in this one {sorted(b - a)}")
    walls = {label: [v["wall_s"] for v in visits if v["schedule"] == label]
             for label in ("overlapped", "prepass-first")}
    log(f"[ab-overlap] walls {walls}, issue sets equal across visits {same}")
    print(json.dumps({"ab_overlap": {"card": card, "walls_s": walls, "issue_sets_equal": same,
                                     "visits": [{k: v for k, v in visit.items()
                                                 if k != "fingerprints"}
                                                for visit in visits]}}))


def analyze_pinned_ladder(card):
    """(a), alone on the card: vendored_ladder_run in a process of its own
    (its solver settings and enumeration-only device solver stay out of
    this one), its output in a directory of its own; its results held to
    the JAX pin."""
    import tempfile

    pin = json.loads(VENDORED_LADDER_PIN.read_text())
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        t0 = time.perf_counter()
        with open(out / "stdout.log", "w") as so, open(out / "stderr.log", "w") as se:
            proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                     "--vendored-ladder", str(out / "vendored_ladder.json")],
                                    cwd=ROOT, stdout=so, stderr=se)
            try:
                rc = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"analyze (a): the pinned ladder-on run failed ({rc}):\n"
                             f"{(out / 'stderr.log').read_text()[-4000:]}")
        got = json.loads((out / "vendored_ladder.json").read_text())
    pinned = {name: (owned, fps) for name, owned, fps in pin["contracts"]}
    mismatched = []
    for name, owned, fps in got["contracts"]:
        log(f"[analyze a] {name}: owned {owned} (JAX pin: {pinned[name][0]}), issues "
            f"{[fp[:5] for fp in fps]}" + (f"; {got['errors'][name]}" if name in got["errors"]
                                           else ""))
        if (owned, fps) != tuple(pinned[name]):
            mismatched.append(name)
    owned = sum(o for _, o, _ in got["contracts"])
    log(f"[analyze a] pinned ladder-on run (cap {VENDORED_LADDER_CAP_S} s, deterministic "
        f"solving, enumeration-only device solver): {got['wall_s']:.3f} s to the results "
        f"({secs:.1f} s with the process), of it the host walks {got['walk_s']:.3f} s (share "
        f"{got['walk_s'] / got['wall_s']:.4f}), waves {got['waves']}, owned {owned} of "
        f"{len(got['contracts'])} (JAX pin {sum(o for o, _ in pinned.values())}), complete "
        f"{len(got['contracts']) - len(got['errors'])} of {len(got['contracts'])}, states "
        f"walked {got['states']}, host_sat {got['host_sat']} (JAX pin {pin['host_sat']}), "
        f"ladder_deferred {got['ladder_deferred']}, {got['replayed']} witnesses replayed (walk "
        f"witnesses that do not: {got['walk_not_replayed']}), launches {got['launches']} "
        f"(in the walks {got['launches_walk']}) on {card}")
    log(f"[analyze a] static pass (static_prune {got['static_prune']}, static_answer "
        f"{got['static_answer']}): {got['static']} (JAX pin {pin['static']}), statically "
        f"answered {got['static_answered']} (JAX pin {pin['static_answered']})")
    log(f"[analyze a] specialization: {got['spec']} (JAX pin {pin['specialized']})")
    if any(got["spec"][k] != v for k, v in pin["specialized"].items()) \
            or got["spec"]["specialize_failed"]:
        raise SystemExit(f"analyze (a): the explorer's specialization {got['spec']} differs "
                         f"from the JAX pin's {pin['specialized']}")
    for name, w in got["walks"].items():
        log(f"[analyze a] walk {name}: {w['walk_s']} s, {w['states']} states, "
            f"{w['mounted']} modules mounted, skipped {w['skipped']}")
    if not (got["static_prune"] and got["static_answer"]) \
            or got["static_answered"] != pin["static_answered"]:
        raise SystemExit(f"analyze (a): the static pass was off or answered "
                         f"{got['static_answered']} (JAX pin {pin['static_answered']})")
    if mismatched or sorted(pinned) != sorted(n for n, _, _ in got["contracts"]):
        raise SystemExit(f"analyze (a): owned flags or fingerprints differ from the JAX "
                         f"ladder pin: {mismatched}")
    if got["errors"]:
        raise SystemExit(f"analyze (a): contracts not analyzed: {got['errors']}")
    if got["not_replayed"] or got["degraded"]:
        raise SystemExit(f"analyze (a): witnesses that do not replay {got['not_replayed']}, "
                         f"degradations {got['degraded']}")
    # enumeration only: portfolio_eval launches only where a query's
    # space is small enough to enumerate, which none of these may be
    for name in PATH_KERNELS + ("block_substep",):
        if not got["launches"][name]:
            raise SystemExit(f"analyze (a): the vendored corpus never launched {name}")


def corpus_report(contracts, results):
    """(Report, errors): the JAX package's Report over `analyze_corpus`'s
    results for `contracts` (EVMContracts in the same order), with, in
    `errors`, one line for each contract that was not analyzed."""
    from mythril_tpu_torch.analysis.report import Report

    errors = [f"{r['name']}: {r.get('error') or 'skipped: ' + str(r.get('skipped'))}"
              for r in results if not r["complete"]]
    report = Report(contracts=contracts, exceptions=errors)
    for contract, result in zip(contracts, results):
        for issue in result["issue_objects"]:
            issue.add_code_info(contract)
            report.append_issue(issue)
    return report, errors


def analyze_default(card):
    """(b): the 13 vendored contracts through analyze_corpus on the card
    with the default funnel (SLS, cube fan, enumeration), the ladder at
    its default cap and the host walk of every contract the device does
    not own, its solver queries racing the card; per contract owned and
    its issue fingerprints, held to VENDORED_LADDER_PIN, host_sat,
    ladder_deferred, the races started, won and lost, race errors and
    invalid race witnesses (both must be 0), the states each contract
    walked, the wall to the report with its shares (prepass, synthesis,
    walk, rendering), every witness replayed. Then RACE_GATE in a corpus
    of its own: it must be walked, and its walk must start a race. The
    vendored walks' launches (`launches_walk`) and races are reported
    apart from the gate's (`launches_walk_gate`)."""
    from mythril_tpu_torch.analysis import corpus
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.laser.smt.solver.solver_statistics import SolverStatistics
    from mythril_tpu_torch.observe import querylog
    from mythril_tpu_torch.support import resilience
    from mythril_tpu_torch.support.support_args import args

    pin = json.loads(VENDORED_LADDER_PIN.read_text())
    pinned = {name: (owned, fps) for name, owned, fps in pin["contracts"]}
    rows = vendored_rows()
    spent = {"prepass": 0.0, "synthesis": 0.0, "walk": 0.0, "launches": {}}
    timed = {}
    for key, attr in (("prepass", "corpus_device_prepass"), ("synthesis", "_owned_result")):
        fn = timed[attr] = getattr(corpus, attr)

        def timing(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                sync()
                spent[_key] += time.perf_counter() - t0

        setattr(corpus, attr, timing)
    resilience.DegradationLog().reset()
    stats_solver = SolverStatistics()
    stats_solver.reset()
    losses = querylog.loss_marker()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with recorded_explorers() as explorers, timed_walks(spent):
            results = corpus.analyze_corpus(rows, transaction_count=2,
                                            execution_timeout=86400, waves=VENDORED_WAVES)
    finally:
        for attr, fn in timed.items():
            setattr(corpus, attr, fn)
    sync()
    analyze_s = time.perf_counter() - t0
    launches = read_launches()
    race_keys = ("race_started", "race_wins", "race_losses", "race_errors")
    races = {k: getattr(stats_solver, k) for k in race_keys}
    invalid = querylog.loss_reasons(since=losses).get(querylog.LOSS_WITNESS_INVALID, 0)
    walk_s = spent["walk"]
    static = static_counters(explorers)
    spec = spec_counters(explorers)
    answered = sorted(r["name"] for r in results if r.get("static_answered"))
    # the race gate, in a corpus of its own (its lanes and budget would
    # change the 13's exploration), under --device-ownership never, its
    # walk racing the card
    t_gate = time.perf_counter()
    owning = args.device_ownership
    args.device_ownership = "never"  # the device may own it: walk it all the same
    spent_gate = {"walk": 0.0, "launches": {}}
    try:
        with timed_walks(spent_gate):
            (gate,) = corpus.analyze_corpus(
                [(RACE_GATE, "", "race_gate")], transaction_count=1,
                execution_timeout=86400, waves=VENDORED_WAVES,
                solver_timeout=RACE_GATE_TIMEOUT_MS)
    finally:
        args.device_ownership = owning
    sync()
    gate_s = time.perf_counter() - t_gate
    gate_races = {k: getattr(stats_solver, k) - races[k] for k in race_keys}
    invalid = querylog.loss_reasons(since=losses).get(querylog.LOSS_WITNESS_INVALID, 0)
    log(f"[analyze b] race gate (INVALID behind a 64-bit factoring, {RACE_GATE_TIMEOUT_MS} ms "
        f"a walk query): {gate_s:.3f} s, owned {bool(gate.get('owned'))}, complete "
        f"{gate['complete']}, walked {gate.get('states')} states in {gate.get('wall_s')} s, "
        f"issues {[(i['swc-id'], i['address']) for i in gate['issues']]}, races {gate_races}, "
        f"launches in its walk {spent_gate['launches']} on {card}")
    t1 = time.perf_counter()
    contracts = [EVMContract(code=code, name=name) for code, _, name in rows]
    report, errors = corpus_report(contracts, results)
    rendered = {form: len(getattr(report, form)()) for form in
                ("as_text", "as_markdown", "as_json", "as_swc_standard_format")}
    render_s = time.perf_counter() - t1
    stats = next((r["device_prepass"] for r in results if r.get("device_prepass")), {})
    budget = corpus.resolve_prepass_budget_s(len(rows), execution_timeout=86400)
    by_swc, mismatched, states = {}, [], {}
    for r in results:
        for i in r["issues"]:
            by_swc[i["swc-id"]] = by_swc.get(i["swc-id"], 0) + 1
        got = (bool(r.get("owned")), issue_fingerprints(r))
        if got != tuple(pinned.get(r["name"], (None, None))):
            mismatched.append(r["name"])
        if not r.get("owned"):
            states[r["name"]] = r.get("states")
        log(f"[analyze b] {r['name']}: owned {got[0]} (JAX pin: "
            f"{pinned.get(r['name'], (None,))[0]}), issues {[fp[:5] for fp in got[1]]}"
            + ("" if r.get("owned") else f", walked {r.get('states')} states in "
               f"{r.get('wall_s')} s") + ("" if r["complete"] else f"; {r['error']}"))
    replayed, not_replayed, walk_not_replayed = replay_all(results)
    owned = sum(bool(r.get("owned")) for r in results)
    complete = sum(bool(r["complete"]) for r in results)
    deferred = sum(e.ladder_deferred for e in explorers)
    wall = analyze_s + render_s
    log(f"[analyze b] default run ({len(rows)} vendored contracts x 32 lanes, 2 transactions, "
        f"waves capped at {VENDORED_WAVES} a phase, budget {budget:.0f} s, ladder cap "
        f"{args.sprint_cap_s} s): {analyze_s:.3f} s to the results (prepass "
        f"{spent['prepass']:.3f} s, synthesis {spent['synthesis']:.3f} s, host walks "
        f"{walk_s:.3f} s), rendering every form {render_s:.3f} s ({rendered} chars); "
        f"wall to report {wall:.3f} s, shares prepass {spent['prepass'] / wall:.4f}, "
        f"synthesis {spent['synthesis'] / wall:.4f}, walk {walk_s / wall:.4f}, "
        f"rendering {render_s / wall:.4f}; waves {stats.get('waves')}, owned {owned} of "
        f"{len(rows)}, complete {complete} of {len(rows)}, states walked {states}, host_sat "
        f"{stats.get('host_sat')}, ladder_deferred {deferred}, device sat "
        f"{stats.get('device_sat')}, flip solve {stats.get('flip_solve_s')} s, races of the "
        f"vendored walks {races}, "
        f"invalid race witnesses {invalid}, issues by SWC {dict(sorted(by_swc.items()))}, "
        f"{replayed} witnesses replayed (walk witnesses that do not: {walk_not_replayed}), "
        f"{len(mismatched)} contracts unlike the JAX ladder pin, launches {launches} (in the "
        f"walks {spent['launches']}) on {card}")
    log(f"[analyze b] static pass (static_prune {args.static_prune}, static_answer "
        f"{args.static_answer}): {static}, statically answered {len(answered)} of {len(rows)} "
        f"{answered}")
    log(f"[analyze b] specialization (specialize {args.specialize}, blockjit "
        f"{args.blockjit}): {spec} (JAX pin {pin['specialized']})")
    if any(spec[k] != v for k, v in pin["specialized"].items()) or spec["specialize_failed"]:
        raise SystemExit(f"analyze (b): the explorer's specialization {spec} differs from "
                         f"the JAX pin's {pin['specialized']}")
    walks = walk_lines(results)
    for name, w in walks.items():
        log(f"[analyze b] walk {name}: {w['walk_s']} s, {w['states']} states, "
            f"{w['mounted']} modules mounted, skipped {w['skipped']}")
    if not (args.static_prune and args.static_answer) or not static["static_summaries"] \
            or answered != pin["static_answered"]:
        raise SystemExit(f"analyze (b): the static pass did not run as the JAX default: "
                         f"{static}, answered {answered}")
    if mismatched or sorted(pinned) != sorted(r["name"] for r in results):
        raise SystemExit(f"analyze (b): owned flags or fingerprints differ from the JAX "
                         f"ladder pin: {mismatched}")
    if errors:
        raise SystemExit(f"analyze (b): contracts not analyzed: {errors}")
    if not_replayed:
        raise SystemExit(f"analyze (b): device witnesses that do not replay to their pc: "
                         f"{not_replayed}")
    if not stats.get("host_sat"):
        raise SystemExit("analyze (b): the ladder decided nothing (host_sat == 0)")
    if not gate["complete"] or gate.get("owned"):
        raise SystemExit(f"analyze (b): the race gate was not walked: {gate.get('error')}")
    if not gate_races["race_started"] or races["race_errors"] or gate_races["race_errors"] \
            or invalid:
        raise SystemExit(f"analyze (b): the walk's races {races}, the race gate's {gate_races}, "
                         f"invalid witnesses {invalid}: want the gate to start one, no error, "
                         f"none invalid")
    for name in EXPLORE_KERNELS + ("block_substep",):
        if not launches[name]:
            raise SystemExit(f"analyze (b): the vendored corpus never launched {name}")
    # a race is at most one search on the card (portfolio.device_check:
    # one portfolio_sls launch that scores its own candidates, none for a
    # query the portfolio cannot compile), and portfolio_eval never
    if not (spent["launches"].get("portfolio_sls")
            or spent_gate["launches"].get("portfolio_sls")):
        raise SystemExit(f"analyze (b): the walks' races ({races}, the gate's {gate_races}) "
                         f"never launched portfolio_sls")
    if resilience.DegradationLog().marker():
        raise SystemExit(f"analyze (b): the degradation log holds "
                         f"{resilience.DegradationLog().events}")
    return dict(launches=launches, launches_walk=spent["launches"],
                launches_walk_gate=spent_gate["launches"], owned=owned,
                host_sat=stats.get("host_sat"), ladder_deferred=deferred, wall=wall,
                walk_s=walk_s, races=races, gate_races=gate_races, states=states,
                static=static, walks=walks)


def wrapper_prepass(card):
    """SymExecWrapper with no outcome injected (a library caller's entry
    point, as the JAX package's analyzer calls it): its own device
    prepass on the card, then the walk. gated_kill must give SWC-106 at
    pc 15 from the prepass's witness and in the report, and the prepass
    must launch slot_write."""
    from mythril_tpu_torch.analysis.corpus import DEFAULT_ADDRESS
    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract

    name, code = MILESTONE[0]
    sync()
    reset_launches()
    t0 = time.perf_counter()
    sym = SymExecWrapper(EVMContract(code=code, name=name), DEFAULT_ADDRESS, "bfs",
                         execution_timeout=60, create_timeout=10, transaction_count=2)
    issues = fire_lasers(sym)
    sync()
    secs = time.perf_counter() - t0
    launches = read_launches()
    stats = sym.device_exploration["stats"]
    device = [(i.swc_id, i.address) for i in sym.device_issues]
    got = sorted((i.swc_id, i.address, i.title, i.severity) for i in issues)
    log(f"[analyze wrapper] SymExecWrapper on {name}, no outcome injected: {secs:.3f} s, "
        f"prepass {stats['waves']} waves in {stats['wall_s']:.3f} s, device issues {device}, "
        f"walked {sym.laser.total_states} states ({sym.laser.device_precovered_skips} "
        f"feasibility queries skipped as precovered), issues {got}, launches {launches} "
        f"on {card}")
    if device != [ANALYZE_SWC[name][:2]] or got != [ANALYZE_SWC[name]] \
            or not launches["slot_write"]:
        raise SystemExit(f"analyze wrapper: device issues {device}, issues {got}, "
                         f"launches {launches}")


def phase_analyze(card):
    """Phase 9, each part alone on the card: (b), (a), the command line,
    the wrapper's own prepass."""
    analyze = analyze_default(card)
    analyze_pinned_ladder(card)
    facade_checks(card)
    wrapper_prepass(card)
    return analyze


# ---------------------------------------------------------------------------
# the analysis service (phase 9b): `serve` at its own geometry
# ---------------------------------------------------------------------------
SERVE_PIN = ROOT / "tests" / "test_torch_service_pinned.json"
WRITER = "6001600055600060015500"  # PUSH1 1 PUSH1 0 SSTORE PUSH1 0 PUSH1 1 SSTORE STOP
KILLABLE = "33ff"  # CALLER SELFDESTRUCT
BRANCHER = "600035600757005b600160005500"  # CALLDATALOAD(0) branches to an SSTORE
# CALLDATALOAD(0) -> memory, SSTORE(0, SHA3 of it), CALLER SELFDESTRUCT: a SHA3
# on every lane (keccak_sponge) before an unprotected selfdestruct
HASHKILL = "6000356000526020600020600055" "33ff"
#: `serve`'s geometry (the JAX package's `myth serve`: 4 stripes x 8 lanes,
#: 256 steps and 2 waves a job, 68 B calldata, code_cap 2048, 2 transactions,
#: the host walk at 8 s with one worker, specialization, blockjit and the
#: static answer on), pipelined (the JAX default; the port's `serve` runs
#: lock-step) with a bucket warmed on its dispatching wave ("sync"): the
#: pins' configuration, at which which waves run specialized does not hang
#: on a warmup thread's timing. A pipelined job's second wave repeats its
#: seeds, so its report does not hang on the mutation RNG, which the job id
#: seeds and the HTTP path draws at random; lock-step runs fix the ids
SERVE_CONFIG = dict(stripes=4, lanes_per_stripe=8, steps_per_wave=256, max_waves=2,
                    calldata_len=68, code_cap=2048, transaction_count=2, host_walk=True,
                    execution_timeout=8, host_workers=1, specialize=True, blockjit=True,
                    static_answer=True, pipeline=True, specialize_warmup="sync")
#: `serve`'s own defaults: lock-step, a bucket warmed in the background
SERVE_DEFAULTS = dict(SERVE_CONFIG, pipeline=False, specialize_warmup="background")
#: the tests' geometry (the JAX service tests' arena: 2 stripes x 4 lanes, 64 steps)
SERVE_SMALL = dict(SERVE_CONFIG, stripes=2, lanes_per_stripe=4, steps_per_wave=64)
SERVE_READY_S = 600.0  # the most the phase waits for readiness or a report


def serve_groups():
    """The phase's submissions, by admission group: ((label, code hex,
    submit kwargs), ...) twice. Group 1 fills the arena's 4 stripes (the
    milestone pair, KILLABLE, and exceptions.sol.o, the vendored contract
    whose block depth is 6: its device phase alone, as its walk outlasts
    the walk's 8 s) beside two submissions the static answer settles at
    admission (WRITER, BRANCHER); group 2 is queued behind it: KILLABLE
    again (a code-cache hit), HASHKILL (SHA3 on the card) and, with a
    deadline of 0, HASHKILL device-only (one wave, deadline-expired) and
    WRITER. Group 1 fills the arena and group 2 waits behind it, so
    which jobs share a wave, and so each job's lane-steps, does not hang
    on the order of the submissions within a group."""
    from mythril_tpu_torch.laser import symbolic_wave as wave

    exceptions = (wave.CONTRACTS / "exceptions.sol.o").read_text().strip()
    return (
        (("gated_kill", MILESTONE[0][1], {}), ("always_assert", MILESTONE[1][1], {}),
         ("killable", KILLABLE, {}), ("exceptions", exceptions, {"host_walk": False}),
         ("writer", WRITER, {}), ("brancher", BRANCHER, {})),
        (("killable_again", KILLABLE, {}), ("hashkill", HASHKILL, {}),
         ("hashkill_deadline", HASHKILL, {"deadline_s": 0.0, "host_walk": False}),
         ("writer_deadline", WRITER, {"deadline_s": 0.0})),
    )


def serve_jobs(device_only=False):
    """serve_groups() in submission order; `device_only` turns every
    job's host walk off."""
    return [(label, code, dict(kw, host_walk=False) if device_only else kw)
            for group in serve_groups() for label, code, kw in group]


def serve_fields(job) -> dict:
    """What a job's report is held to the pin by (`job` is the HTTP job
    dict): its state and waves, the report's device block, its issues'
    fingerprints, the walk's error, the degradations and the static
    answer. Left out: the job and journey ids (random over HTTP) and the
    timings (`timings`, `static.wall_ms`)."""
    report = job.get("report") or {}
    return {
        "state": job["state"],
        "waves": job["waves"],
        "code_hash": report.get("code_hash"),
        "device": report.get("device"),
        "issues": issue_fingerprints(report) if "issues" in report else None,
        "host_error": (report.get("host") or {}).get("error"),
        "degraded": report.get("degraded", []),
        "static_answered": report.get("static_answered", False),
    }


def serve_differences(got: dict, pin: dict) -> list:
    """The labels whose fields differ from the pin, with both sides."""
    return [(label, got.get(label), want) for label, want in sorted(pin.items())
            if got.get(label) != want]


def serve_pin(part):
    pin = json.loads(SERVE_PIN.read_text())[part]
    want = dict(SERVE_CONFIG, pipeline=pin["config"]["pipeline"])
    if pin["config"] != want:
        raise SystemExit(f"serve: the pin's {part} was taken at {pin['config']}, not {want}")
    return pin


def serve_http(card, config, submit, label):
    """An AnalysisServer at `config` with its arena warmup: `submit(srv)`
    queues the submissions and returns {label: job id} before the engine
    starts, then the engine starts (the launch counts set to 0 just
    before) and every report is read over HTTP. Returns ({label: job
    dict}, the numbers of the serve line, the launches, /stats)."""
    from mythril_tpu_torch.laser.smt.solver import device_race
    from mythril_tpu_torch.observe.spans import flight_recorder, overlap_fraction
    from mythril_tpu_torch.service.client import ServiceClient, ServiceError
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(ServiceConfig(arena_warmup=True, **config),
                         start_engine=False).start()
    try:
        client = ServiceClient(srv.url)
        probe = ServiceClient(srv.url, honor_retry_after=False)
        ids = submit(srv, client)
        if len(ids) != len(serve_jobs()):
            raise SystemExit(f"serve ({label}): submissions lost: {sorted(ids)}")
        sync()
        reset_launches()
        start_mono = time.monotonic()
        p0 = time.perf_counter()
        srv.engine.start()
        ready_s = None
        while ready_s is None:
            try:
                probe.healthz(ready=True)
                ready_s = time.perf_counter() - p0
            except ServiceError as why:
                if why.status != 503 or time.perf_counter() - p0 > SERVE_READY_S:
                    raise SystemExit(f"serve ({label}): readiness {why.status}: {why}")
                time.sleep(0.02)
        jobs = {name: client.report(job_id, wait_s=SERVE_READY_S)
                for name, job_id in ids.items()}
        if not device_race.wait_idle(timeout=120):
            raise SystemExit(f"serve ({label}): a walk's race is still running")
        sync()
        wall = time.perf_counter() - p0
        launches = read_launches()
        stats = client.stats()
        finished = {name: srv.engine.queue.get(job_id).finished_t
                    for name, job_id in ids.items()}
        waves = [w for w in flight_recorder().tail(8192)
                 if w.name == "wave.device" and w.track == "service" and w.t0 >= p0]
    finally:
        srv.close()
    arena = [name for name, job in jobs.items()
             if not (job.get("report") or {}).get("static_answered")]
    latencies = sorted(job["latency_s"] for job in jobs.values())
    wave_s = [w.t1 - w.t0 for w in waves]
    out = {
        "jobs": len(jobs),
        "waves": stats["waves"]["count"],
        "spec_waves": stats["kernel"]["spec_waves"],
        "generic_waves": stats["kernel"]["generic_waves"],
        "warmups_launched": stats["kernel"]["warmups_launched"],
        "wave_wall_s_mean": round(statistics.mean(wave_s), 6) if wave_s else None,
        "wave_wall_s_median": round(statistics.median(wave_s), 6) if wave_s else None,
        "max_jobs_resident": stats["arena"]["max_jobs_resident"],
        "ready_s": round(ready_s, 6),
        "first_report_s": round(min(finished[name] for name in arena) - start_mono, 6),
        "latency_p50_s": statistics.median(latencies),
        "latency_max_s": latencies[-1],
        "wall_s": round(wall, 6),
        # the share of the waves' dispatch-to-ready time with two of them
        # in flight (the pipelined slots; 0 lock-step)
        "waves_in_flight_together": overlap_fraction(waves),
        "code_cache_hits": stats["warm"]["code_cache"]["hits"],
        "static_answered": stats["static"]["static_answered"],
        "walks": stats["host_pool"]["completed"],
        "blockjit_blocks": stats["kernel"]["blockjit_blocks"],
    }
    log(f"[serve] {label}: {len(jobs)} jobs through the HTTP server at serve's geometry "
        f"(4 x 8 lanes, 256 steps, 2 waves a job, the walks on): {out}; "
        f"launches {launches} on {card}")
    return jobs, out, launches, stats


def serve_check(label, jobs, pin, without=()):
    """Hold every job of `jobs` to `pin` (serve_fields, the device block
    less the keys in `without`); fail on a job that is not done or
    differs."""
    def fields(f):
        device = f["device"] and {k: v for k, v in f["device"].items() if k not in without}
        return dict(f, device=device)

    got = {name: fields(serve_fields(job)) for name, job in jobs.items()}
    for name in sorted(got):
        log(f"  {name}: {got[name]['state']}, waves {got[name]['waves']}, device "
            f"{got[name]['device']}, issues {[i[:2] for i in got[name]['issues'] or []]}, "
            f"degraded {got[name]['degraded']}, static {got[name]['static_answered']}")
    diffs = serve_differences(got, {name: fields(f) for name, f in pin.items()})
    failed = sorted(name for name, job in jobs.items() if job["state"] != "done")
    if failed or diffs:
        raise SystemExit(f"serve ({label}): failed jobs {failed}; differences from the pin "
                         f"{diffs}")


def serve_default(card):
    """The pinned submissions through the HTTP server at `serve`'s own
    defaults (SERVE_DEFAULTS: lock-step, a bucket warmed in the
    background from a cold kernel cache, the walks on): both groups
    queued in order with fixed job ids (they seed the mutation RNG, as
    the pin's did) before the engine starts, so group 1 fills the arena.
    Every report is held to the JAX engine's lock-step pin with the walks
    on but in its lane-steps (a generic wave counts steps, a specialized
    one its loop's iterations, and which waves run specialized hangs on
    the warmup thread); a warmup must have run and both kinds of wave;
    keccak_sponge, slot_write and block_substep must launch. Returns the
    serve line's numbers and the launches (`launches_serve`)."""
    from mythril_tpu_torch.laser.batch import specialize
    from mythril_tpu_torch.service.jobs import Job

    def submit(srv, client):
        ids = {}
        for i, (name, code, kw) in enumerate(serve_jobs()):
            job = Job(code, **kw)
            job.id = job.journey_id = f"{i + 1:012x}"
            ids[name] = srv.engine.submit(job).id
        return ids

    # the phases before this one warmed buckets in the process-wide kernel
    # cache: start from a cold one, as a fresh `serve` does
    specialize.clear_kernel_cache()
    jobs, out, launches, _ = serve_http(card, SERVE_DEFAULTS, submit, "defaults")
    serve_check("defaults", jobs, serve_pin("full_lockstep_walks")["jobs"],
                without=("lane_steps",))
    missing = [name for name in ("keccak_sponge", "slot_write", "block_substep")
               if not launches[name]]
    if missing or not (out["warmups_launched"] and out["generic_waves"] and out["spec_waves"]):
        raise SystemExit(f"serve (defaults): the service never launched {missing}, or "
                         f"ran no warmup or not both kinds of wave: {out}")
    return out, launches


def serve_pipelined(card):
    """The pinned submissions through the HTTP server, pipelined with
    each bucket warmed on its dispatching wave (SERVE_CONFIG), group 1
    then group 2 submitted concurrently by ServiceClient threads; every
    report equal to the JAX engine's pipelined pin (a pipelined job's
    second wave repeats its seeds, so its report does not hang on the
    random ids of the HTTP path). Returns the numbers, labelled
    pipelined in the serve line."""
    import threading

    def submit(srv, client):
        ids = {}
        for group in serve_groups():
            threads = [threading.Thread(target=lambda n=name, c=code, k=kw: ids.__setitem__(
                n, client.submit(c, **k))) for name, code, kw in group]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return ids

    jobs, out, _, _ = serve_http(card, SERVE_CONFIG, submit, "pipelined")
    serve_check("pipelined", jobs, serve_pin("full")["jobs"])
    return out


def serve_schedule_run(pipeline):
    """serve_jobs(device_only=True) straight into an engine on the card
    (fixed job ids, the mutation RNG's seeds, as the pin's), pipelined or
    lock-step: (wall from start to the last report, {label: fields})."""
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    engine = AnalysisEngine(ServiceConfig(**dict(SERVE_CONFIG, pipeline=pipeline)))
    submitted = []
    for i, (label, code, kw) in enumerate(serve_jobs(device_only=True)):
        job = Job(code, **kw)
        job.id = job.journey_id = f"{i + 1:012x}"
        submitted.append((label, engine.submit(job)))
    sync()
    try:
        t0 = time.perf_counter()
        engine.start()
        for _, job in submitted:
            if not engine.queue.wait_terminal(job.id, SERVE_READY_S).terminal:
                raise SystemExit(f"serve: job {job.id} never settled")
        sync()
        wall = time.perf_counter() - t0
    finally:
        engine.drain()
    return wall, {label: serve_fields(job.as_dict()) for label, job in submitted}


def serve_schedules(card):
    """The pipelined and the lock-step schedule on the same device-only
    submissions, in turns (pipelined, lock-step, lock-step, pipelined),
    each run held to the JAX engine's pin of its schedule: the lock-step
    pin, and the pipelined pin's device fields (that pin's jobs walk;
    a walk does not feed back into the waves)."""
    pins = {True: serve_pin("full")["jobs"], False: serve_pin("full_lockstep")["jobs"]}
    walls = {True: [], False: []}
    for pipeline in (True, False, False, True):
        wall, got = serve_schedule_run(pipeline)
        want = pins[pipeline]
        if pipeline:
            # the pinned pipelined run walks: hold the device half
            got = {k: {f: v[f] for f in ("state", "waves", "device")} for k, v in got.items()}
            want = {k: {f: v[f] for f in ("state", "waves", "device")} for k, v in want.items()}
        diffs = serve_differences(got, want)
        if diffs:
            raise SystemExit(f"serve: {'pipelined' if pipeline else 'lock-step'} run "
                             f"differs from its pin: {diffs}")
        walls[pipeline].append(round(wall, 6))
    log(f"[serve] schedules, device-only, in turns (P, L, L, P): pipelined "
        f"{walls[True]} s, lock-step {walls[False]} s from start to the last report, "
        f"each equal to its schedule's pin on {card}")
    return {"pipelined_s": walls[True], "lockstep_s": walls[False]}


def serve_cli(card):
    """`python -m mythril_tpu_torch serve`'s own entry with its defaults
    (the card, lock-step, arena warmup), in-process on a thread so that
    it finds the kernels loaded: `submit` through the command line's
    entry, KILLABLE device-only, must print a done job with its
    selfdestruct trigger; POST /v1/drain then ends `serve`, which must
    return 0."""
    import contextlib
    import io
    import socket
    import threading

    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.service.client import ServiceClient, ServiceError

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    rc = {}
    server = threading.Thread(target=lambda: rc.setdefault(
        "serve", cli.main(["serve", "--port", str(port), "--no-host-walk"])), daemon=True)
    t0 = time.perf_counter()
    server.start()
    client = ServiceClient(url, honor_retry_after=False)
    while True:
        try:
            client.healthz(ready=True)
            break
        except (ServiceError, OSError):
            if time.perf_counter() - t0 > SERVE_READY_S or not server.is_alive():
                raise SystemExit(f"serve (command line): never ready ({rc})")
            time.sleep(0.02)
    ready_s = time.perf_counter() - t0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc["submit"] = cli.main(["submit", "-c", KILLABLE, "--url", url, "--no-host-walk"])
    job = json.loads(out.getvalue())
    client.drain()
    server.join(timeout=SERVE_READY_S)
    log(f"[serve] the command line: `serve --port {port} --no-host-walk` ready in "
        f"{ready_s:.3f} s on {card}; `submit -c "
        f"{KILLABLE}`: {job['state']}, waves {job['waves']}, device "
        f"{job['report']['device']}; exits {rc}")
    if server.is_alive() or rc != {"serve": 0, "submit": 0} or job["state"] != "done" \
            or job["report"]["device"]["triggers"] != {"selfdestruct": 1}:
        raise SystemExit(f"serve (command line): {rc}, {job}")


def serve_profile(card):
    """One wave profiled: a lock-step engine's device-only run of
    exceptions.sol.o alone (one job, one wave: max_waves 1), under
    torch.profiler; the idle share is 1 - the CUDA kernels' busy time over
    the wave's own span (dispatch to readback-ready)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mythril_tpu_torch.observe.spans import flight_recorder
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    code = dict((label, code) for label, code, _ in serve_jobs())["exceptions"]
    engine = AnalysisEngine(ServiceConfig(**dict(SERVE_CONFIG, pipeline=False,
                                                 host_walk=False, max_waves=1)))
    job = engine.submit(Job(code))
    sync()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.start()
        engine.queue.wait_terminal(job.id, SERVE_READY_S)
        sync()
    engine.drain()
    (wave,) = [s for s in flight_recorder().tail(8192)
               if s.name == "wave.device" and s.track == "service" and s.t0 >= t0]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        log(f"[serve] the profiler recorded no device activity: idle share not measured")
        return None
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    wave_s = wave.t1 - wave.t0
    idle = 1 - busy_s / wave_s
    log(f"[serve] one profiled wave (exceptions.sol.o, 8 lanes of 32, block bucket): "
        f"{len(kernels)} CUDA kernels, device busy {busy_s * 1e3:.3f} ms of the wave's "
        f"{wave_s * 1e3:.3f} ms (idle share {idle:.4f}), steps {job.report['device']['lane_steps'] // 8} "
        f"on {card}")
    return round(idle, 6)


def phase_serve(card):
    """Phase 9b: the analysis service on the card (see the docstring's
    list)."""
    out, launches = serve_default(card)
    out["pipelined"] = serve_pipelined(card)
    out["schedules"] = serve_schedules(card)
    serve_cli(card)
    out["idle_share_one_wave"] = serve_profile(card)
    return {"serve": out, "launches": launches}


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
    """Every vendored suite through run_cases on the card with its
    defaults: the hybrid replay (a lane the device halts UNSUPPORTED or
    at its memory cap continues on the host engine,
    laser/batch/takeover.py) and the straggler re-run. Every case must
    pass, as the JAX package's hybrid manifest pins
    (tests/laser/vmtests_manifest.json, total_pass), and every case the
    device passes alone (the pinned device verdicts,
    mythril_tpu_torch/laser/vmtests_device_verdicts.json) must pass."""
    from mythril_tpu_torch.laser.conformance import load_vmtests, run_cases
    from mythril_tpu_torch.support import resilience

    pinned = json.loads(
        (ROOT / "mythril_tpu_torch" / "laser" / "vmtests_device_verdicts.json").read_text())
    manifest = json.loads((ROOT / "tests" / "laser" / "vmtests_manifest.json").read_text())
    cases, _ = load_vmtests()
    marker = resilience.DegradationLog().marker()
    t0 = time.perf_counter()
    verdicts = run_cases(cases)
    sync()
    wall = time.perf_counter() - t0
    takeovers = resilience.DegradationLog().counts_since(marker).get("host-takeover", 0)
    passes = sum(v == "pass" for v in verdicts.values())
    device_skips = sorted(k for k, v in pinned["verdicts"].items() if v != "pass")
    not_passed = sorted(k for k, v in verdicts.items() if v != "pass")
    log(f"[vmtests] {len(cases)} cases, hybrid, the stragglers run on, in {wall:.1f} s: "
        f"{passes} pass (JAX manifest {manifest['total_pass']}), {takeovers} host takeovers; "
        f"the {len(device_skips)} cases the device alone skips: "
        f"{[(k, verdicts.get(k)) for k in device_skips]}")
    for k in not_passed[:10]:
        log(f"  {k}: {verdicts.get(k)} (device alone: {pinned['verdicts'].get(k)})")
    if not_passed or passes != manifest["total_pass"] or len(verdicts) != len(pinned["verdicts"]):
        raise SystemExit(f"VMTests: {len(not_passed)} cases do not pass")
    return dict(wall=wall, passes=passes, takeovers=takeovers)


# tests/laser/test_engine_differential.py's program generators, copied
# (chip_smoke.py imports nothing of the JAX package's suite);
# tests/test_torch_walk_engine.py holds the copies to the originals
DIFF_TRIALS = 48
DIFF_CALLER, DIFF_ADDRESS = 0xDEADBEEFDEADBEEF, 0x1234
DIFF_ARITH = [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x0A, 0x0B, 0x10,
              0x11, 0x12, 0x13, 0x14, 0x16, 0x17, 0x18, 0x1A, 0x1B, 0x1C, 0x1D]


def diff_program(rng, n_ops: int = 24) -> bytes:
    code, depth = bytearray(), 0
    for _ in range(n_ops):
        choice = rng.random()
        if depth >= 2 and choice < 0.45:
            code.append(rng.choice(DIFF_ARITH))
            depth -= 1
        elif depth >= 3 and choice < 0.55:
            code.append(rng.choice([0x08, 0x09]))
            depth -= 2
        elif depth >= 1 and choice < 0.65:
            code.append(rng.choice([0x15, 0x19]))
        elif depth >= 1 and choice < 0.72 and depth < 14:
            code.append(0x80 + rng.randrange(min(depth, 4)))
            depth += 1
        else:
            n = rng.randrange(1, 5)
            code.append(0x60 + n - 1)
            code += rng.randbytes(n)
            depth += 1
    slot = 0
    while depth > 0:
        code += bytes([0x60, slot, 0x55])
        depth -= 1
        slot += 1
    code.append(0x00)
    return bytes(code)


def diff_memory_program(rng, n_ops: int = 10) -> bytes:
    code = bytearray()
    for _ in range(n_ops):
        value = rng.randbytes(rng.randrange(1, 33))
        offset = rng.randrange(0, 8) * 32
        code.append(0x60 + len(value) - 1)
        code += value
        code += bytes([0x60, offset, 0x52])
    start = rng.randrange(0, 4) * 32
    length = rng.choice([32, 64, 96])
    code += bytes([0x60, length, 0x60, start, 0x20, 0x60, 0x00, 0x55])
    code += bytes([0x60, start, 0x51, 0x60, 0x01, 0x55])
    code.append(0x00)
    return bytes(code)


def diff_branch_program(rng) -> bytes:
    a, b = rng.randrange(0, 256), rng.randrange(0, 256)
    cmp_op = rng.choice([0x10, 0x11, 0x14])
    prefix = bytes([0x60, a, 0x60, b, cmp_op])
    fallthrough = bytes([0x60, 0xAA, 0x60, 0x00, 0x55, 0x00])
    dest = len(prefix) + 3 + len(fallthrough)
    return (prefix + bytes([0x60, dest, 0x57]) + fallthrough
            + bytes([0x5B, 0x60, 0xBB, 0x60, 0x00, 0x55, 0x00]))


def diff_programs():
    import random

    gens = (diff_program, diff_memory_program, diff_branch_program)
    return [gens[t % 3](random.Random(90210 + t)) for t in range(DIFF_TRIALS)]


def host_laser_storage(code: bytes) -> dict:
    """One concrete message call through the port's host LASER engine:
    the final storage of the callee."""
    from datetime import datetime

    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum.state.account import Account
    from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
    from mythril_tpu_torch.laser.ethereum.svm import LaserEVM
    from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
    from mythril_tpu_torch.laser.ethereum.transaction.concolic import execute_message_call
    from mythril_tpu_torch.laser.smt import symbol_factory

    world_state = WorldState()
    account = Account(DIFF_ADDRESS, concrete_storage=True)
    account.code = Disassembly(code.hex())
    world_state.put_account(account)
    account.set_balance(10**18)
    time_handler.start_execution(10000)
    laser = LaserEVM()
    laser.open_states = [world_state]
    laser.time = datetime.now()
    word = lambda v: symbol_factory.BitVecVal(v, 256)  # noqa: E731
    execute_message_call(laser, callee_address=word(DIFF_ADDRESS),
                         caller_address=word(DIFF_CALLER), origin_address=word(DIFF_CALLER),
                         code=code.hex(), gas_limit=8_000_000, data=b"", gas_price=10,
                         value=0, track_gas=True)
    if len(laser.open_states) != 1:
        raise SystemExit(f"engine differential: the host run of {code.hex()} did not finish")
    account = laser.open_states[0][word(DIFF_ADDRESS)]
    return {k.value: v.value for k, v in account.storage.printable_storage.items() if v.value}


def phase_engine_differential(card):
    """tests/laser/test_engine_differential.py's random straight-line,
    memory/SHA3 and branch programs as lanes of one batch through run.py
    on the card, and one by one through the port's host LASER engine:
    the final storage must agree."""
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.laser.batch.state import Status, storage_dict

    programs = diff_programs()
    t0 = time.perf_counter()
    table = make_code_table(programs)
    batch = make_batch(len(programs), code_ids=list(range(len(programs))),
                       caller=DIFF_CALLER, address=DIFF_ADDRESS)
    out, _ = run(batch, table, max_steps=512)
    sync()
    card_s = time.perf_counter() - t0
    if any(int(s) == Status.RUNNING for s in out.status.tolist()):
        raise SystemExit("engine differential: a lane is still running on the card")
    t0 = time.perf_counter()
    differ = []
    for lane, code in enumerate(programs):
        device = {k: v for k, v in storage_dict(out, lane).items() if v}
        if host_laser_storage(code) != device:
            differ.append(code.hex())
    host_s = time.perf_counter() - t0
    log(f"[engine differential] {len(programs)} random programs: the card's run.py "
        f"{card_s:.3f} s, the host engine {host_s:.3f} s, {len(differ)} disagree on {card}")
    if differ:
        raise SystemExit(f"engine differential: final storage differs for {differ[:4]}")


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
    lowered, _ = ff.lower_flips([conds for _, _, conds, _ in cands], lower_fn=lower)
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


def substep_times(label):
    """The substep kernel of the package on sys.path, in both modes,
    concrete and symbolic, on the vendored wave after each of
    SPEC_CHECK_STEPS full steps, at LANES lanes and on the first
    SPEC_ANALYSIS_LANES: one JSON line of device ms (torch.profiler)."""
    from mythril_tpu_torch.laser import symbolic_wave as wave
    from mythril_tpu_torch.laser.batch import symbolic as sym
    from mythril_tpu_torch.native import build
    from mythril_tpu_torch.ops import substep

    build.build()
    buckets = vendored_buckets()
    symb, code = wave.make_wave(WAVE_STRIPES, WAVE_LANES_PER_STRIPE)
    out = {"label": label, "package": str(Path(substep.__file__).resolve().parents[1])}
    done = 0
    for steps in SPEC_CHECK_STEPS:
        symb, _, _ = sym.sym_run_inplace(symb, code, max_steps=steps - done)
        done = steps
        for mode, (phases, table) in buckets.items():
            for symbolic in (False, True):
                for lanes in (LANES, SPEC_ANALYSIS_LANES):
                    base, tid = first_lanes(symb.base, symb.stack_tid if symbolic else None,
                                            lanes)
                    kind = "symbolic" if symbolic else "concrete"
                    out[f"{mode} {kind} {steps} steps {lanes} lanes"] = time_substep(
                        base, tid, code, table, phases, with_bound=False)[0]
    sync()
    print(json.dumps(out), flush=True)


def ab_substep(card, parent):
    """The substep kernel of a parent checkout (`parent`, unpacked beside
    this one) against this checkout's, each in its own process on this
    card, in the order parent, change, change, parent."""
    rows = []
    for label, root in (("parent", parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", parent)):
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--substep-times", root, label],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise SystemExit(f"--substep-times {root} failed:\n{done.stdout}{done.stderr}")
        rows.append(json.loads(done.stdout.strip().splitlines()[-1]))
        log(f"[ab] {label} ({root}): " + ", ".join(
            f"{k} {ms_text(v)}" for k, v in rows[-1].items() if k.endswith("lanes")))
    log(json.dumps({"card": card, "ab_substep": rows}))


def main_times(label):
    """The main path (phase_main_path's program, LANES lanes, STEPS steps)
    of the package on sys.path: cold, then AB_MAIN_REPS warm runs, with
    the host's dispatch time per trivial launch: one JSON line."""
    import numpy as np

    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.native import build

    build.build()
    _, code = program()
    rng = np.random.default_rng(1)
    calldata = [rng.integers(0, 256, CALLDATA_BYTES, dtype=np.uint8).tobytes()
                for _ in range(LANES)]
    table = make_code_table([code])
    batch = make_batch(LANES, calldata=calldata)
    t0 = time.perf_counter()
    run(batch, table, max_steps=LOOP_STEPS)
    sync()
    cold_ms = (time.perf_counter() - t0) / LOOP_STEPS * 1e3
    warm = []
    for _ in range(AB_MAIN_REPS):
        t0 = time.perf_counter()
        _, steps = run(batch, table, max_steps=STEPS)
        sync()
        warm.append((time.perf_counter() - t0) / steps * 1e3)
    out = {"label": label, "package": str(Path(build.__file__).resolve().parents[1]),
           "dispatch_us": dispatch_us(), "cold_ms_per_step": cold_ms,
           "warm_ms_per_step": warm}
    print(json.dumps(out), flush=True)


def ab_main(card, parent):
    """The main path of a parent checkout (`parent`, unpacked beside this
    one) against this checkout's, each in its own process on this card,
    in the order parent, change, change, parent, twice."""
    rows = []
    for label, root in (("parent", parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", parent)) * 2:
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--main-times", root, label],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise SystemExit(f"--main-times {root} failed:\n{done.stdout}{done.stderr}")
        rows.append(json.loads(done.stdout.strip().splitlines()[-1]))
        log(f"[ab] {label} ({root}): dispatch {rows[-1]['dispatch_us']:.2f} us, cold "
            f"{rows[-1]['cold_ms_per_step']:.3f} ms/step, warm "
            f"{[round(x, 3) for x in rows[-1]['warm_ms_per_step']]} ms/step")
    log(json.dumps({"card": card, "ab_main": rows}))


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
    # --portfolio-times and --substep-times ROOT LABEL time the package of
    # this checkout or of one unpacked under _archive/
    times = args[:1] in (["--portfolio-times"], ["--substep-times"], ["--main-times"])
    package_root = checkout_dir(args[1]) if times else str(ROOT)
    sys.path.insert(0, package_root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    if args[:1] == ["--vendored-ladder"]:
        # phase_analyze's pinned ladder-on run, in a process of its own
        vendored_ladder_run(args[1])
        return 0

    if args[:1] == ["--portfolio-times"]:
        portfolio_times(args[2])
        return 0
    if args[:1] == ["--substep-times"]:
        substep_times(args[2])
        return 0
    if args[:1] == ["--main-times"]:
        main_times(args[2])
        return 0
    kind, card = phase_device()
    if args[:1] == ["--ab-portfolio"]:
        ab_portfolio(card, checkout_dir(args[1]))
        return 0
    if args[:1] == ["--ab-substep"]:
        ab_substep(card, checkout_dir(args[1]))
        return 0
    if args[:1] == ["--ab-main"]:
        ab_main(card, checkout_dir(args[1]))
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
    if args == ["--explore"]:
        phase_explore(card)
        return 0
    if args == ["--analyze"]:
        phase_analyze(card)
        phase_engine_differential(card)
        phase_vmtests()
        return 0
    if args == ["--solver"]:
        phase_solver(card, phase_sym_parity())
        return 0
    if args == ["--specialize"]:
        phase_specialize(card)
        return 0
    if args == ["--serve"]:
        print(json.dumps(phase_serve(card)["serve"]))
        return 0
    if args == ["--facade"]:
        t0 = time.perf_counter()
        facade = facade_checks(card)
        wrapper_prepass(card)
        log(f"[facade] {time.perf_counter() - t0:.1f} s in all")
        print(json.dumps({k: v for k, v in facade.items()}))
        return 0
    if args == ["--ab-overlap"]:
        ab_overlap(card)
        return 0
    walls = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    main_path = phase("main path", phase_main_path, card)
    phase("profile", phase_profile, card, main_path["wall"] / main_path["steps"] * 1e3)
    phase("bignum", phase_bignum, card)
    sym_wave = phase("symbolic wave", phase_wave, card)
    spec = phase("specialize", phase_specialize, card)
    kern.update(spec["kern"])
    flips = phase("symbolic parity", phase_sym_parity)
    solver = phase("solver", phase_solver, card, flips)
    flip = phase("flip frontier", phase_flip, card, sym_wave["frontier"])
    explore = phase("explorer", phase_explore, card)
    analyze = phase("analyze (b)", analyze_default, card)
    phase("analyze (a)", analyze_pinned_ladder, card)
    facade = phase("analyze cli", facade_checks, card)
    phase("analyze wrapper", wrapper_prepass, card)
    serve = phase("serve", phase_serve, card)
    kern.update(phase("portfolio kernels", phase_portfolio_kernels, card, flip["programs"],
                      flip["solving"]))
    phase("engine differential", phase_engine_differential, card)
    phase("vmtests", phase_vmtests)
    log(f"[phases] seconds from the main path on: {json.dumps(walls)}")

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
        "fused_substep": ("mythril_tpu_torch/csrc/substep.cu",
                          "mythril_tpu/laser/batch/specialize.py:309 (and :423)"),
        "block_substep": ("mythril_tpu_torch/csrc/substep.cu",
                          "mythril_tpu/laser/batch/blockjit.py:368 (and :598)"),
    }
    report = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": where[name][0],
        "replaces": where[name][1],
        "on_path": name in PATH_KERNELS + FLIP_KERNELS + SPEC_KERNELS,
        "launches": main_path["launches"][name],
        # the 5b wave of the substep kernel's mode (SpecializedKernel.sym_run)
        **({"launches_spec_wave": spec["launches"][name]} if name in SPEC_KERNELS else {}),
        "launches_symbolic_wave": sym_wave["launches"][name],
        "launches_flip": flip["launches"][name],
        "launches_explore": explore["launches"][name],
        "launches_explore_pipelined": explore["piped_launches"][name],
        "launches_analyze": analyze["launches"][name],
        "launches_walk": analyze["launches_walk"].get(name, 0),
        "launches_walk_gate": analyze["launches_walk_gate"].get(name, 0),
        "launches_solver": solver["launches"][name],
        "launches_serve": serve["launches"][name],
        "launches_facade": facade["launches"][name],
        "launches_facade_corpus": facade["launches_corpus"][name],
        **({"launches_many": main_path["launches"]["slot_write_many"],
            "launches_many_symbolic_wave": sym_wave["launches"]["slot_write_many"],
            "launches_many_explore": explore["launches"]["slot_write_many"],
            "launches_many_analyze": analyze["launches"]["slot_write_many"],
            "launches_many_serve": serve["launches"]["slot_write_many"],
            "launches_many_facade": facade["launches"]["slot_write_many"],
            "launches_many_facade_corpus": facade["launches_corpus"]["slot_write_many"],
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
    print(json.dumps({"serve": serve["serve"]}))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
