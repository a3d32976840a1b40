"""The port's block-level JIT (laser/batch/blockjit.py) against the JAX
package's, on the CPU (the plain block substep; the CUDA kernel is held
to it on the card by chip_smoke.py).

- host decisions: every field of `summarize_blocks`, `block_stats`,
  `block_depth_for` and the block-program rows equal the JAX package's
  on the 13 vendored contracts, the fault-suite fixtures and the 14
  detection modules' positive fixtures, with and without a static
  summary, and the JAX suite's goldens hold;
- one block substep (`torch_substep_cases`: a lane a hazard, the ALU
  family's edge values, taint and the coarse MUL wrap, a pruned phase)
  equals the JAX `block_substep` / `sym_block_substep`, every field; so
  do BLOCK_DEPTH of them on the seeded sweep (`sweep_state`), one subject
  op at a time;
- the block loops: `SpecializedKernel.run` / `sym_run` on a blockjit
  bucket equal the JAX ones at the JAX suite's equivalence setup, every
  field and (steps, substeps, blocks); a 13-stripe vendored wave equals
  the JAX one's pinned digests;
- the port against itself: blockjit equals generic, taint and wraps
  defer to the full step, a mid-block out-of-gas replays generically, a
  pruned op parks inside a lowered block;
- the explorer (fault suite + ALUWRITE, seed 7): blockjit on has the
  pinned JAX fingerprints and blockjit off's, the counters attribute
  blocks and fallbacks; the env override and the kernel-cache block keys.

Exact equality throughout. The JAX sides that compile the vendored wave
and run the explorer are pinned in tests/test_torch_blockjit_pinned.json;
re-pin with

    PYTHONPATH=. python tests/test_torch_blockjit.py --pin
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_specialize import (
    BRANCHER,
    CODES,
    EXPLORE_KW,
    KILLABLE,
    WRITER,
    executed,
    fingerprint,
    hold_wave_to_pin,
    jax_explore_fingerprints,
    jax_wave,
    port_explore_run,
    same_batch,
    same_symbatch,
    set_flags,
    substep_inputs,
    summaries,
)
from torch_jax_memory import release_jax_executables  # noqa: F401
from torch_substep_cases import SWEEP_SUBJECTS, sweep_state

from mythril_tpu.analysis.corpusgen import deadweight_contract
from mythril_tpu.disassembler.asm import assemble
from mythril_tpu.laser.batch import blockjit as jbj
from mythril_tpu.laser.batch import specialize as jsp
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu.laser.batch.symbolic import make_sym_batch as jax_make_sym_batch
from mythril_tpu_torch.analysis.static import analyze_bytecode as port_analyze
from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.laser.batch import blockjit as bj
from mythril_tpu_torch.laser.batch import explore as port_explore
from mythril_tpu_torch.laser.batch import specialize as sp
from mythril_tpu_torch.laser.batch.run import run as port_run
from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket
from mythril_tpu_torch.laser.batch.state import Status, make_batch, make_code_table
from mythril_tpu_torch.laser.batch.step import PhaseSet
from mythril_tpu_torch.laser.batch.symbolic import make_sym_batch, sym_run
from mythril_tpu_torch.support.support_args import args as port_args

torch.set_num_threads(1)

PINNED = Path(__file__).with_name("test_torch_blockjit_pinned.json")

#: the JAX blockjit suite's fixtures (tests/laser/test_blockjit.py)
GATED_BJ = "60003560f81c604214600d57005b605560aa0150600160005500"
ALUCHAIN = "6001600302600701605519168015145000"
ALUWRITE = bytes([0x60, 0x01, 0x60, 0x02, 0x01, 0x60, 0x09, 0x56, 0x00,
                  0x5B, 0x60, 0x00, 0x55, 0x00]).hex()
EQ_CODES = (ALUCHAIN, ALUWRITE, WRITER, BRANCHER, KILLABLE)
EXPLORE_CODES = [KILLABLE, WRITER, BRANCHER, GATED_BJ, ALUWRITE]


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    set_flags(monkeypatch.setattr, specialize=True, blockjit=True)


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


def block_phases(pkg, bjmod, codes, summaries_=None):
    summaries_ = summaries_ or [None] * len(codes)
    return pkg.union_phases([
        pkg.phases_for(pkg.signature_for(c, s), fuse=pkg.fuse_profitable(c, s),
                       block_depth=bjmod.block_depth_for(c, s))
        for c, s in zip(codes, summaries_)])


# ---------------------------------------------------------------------------
# host decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_summary", [False, True], ids=["sweep", "summary"])
@pytest.mark.parametrize("name", list(CODES))
def test_host_decisions_equal_the_jax_package(name, with_summary):
    code = CODES[name]
    js, ps = summaries(name) if with_summary else (None, None)
    got, want = bj.summarize_blocks(code, ps), jbj.summarize_blocks(code, js)
    assert list(got) == list(want)
    assert [tuple(b) for b in got.values()] == [tuple(b) for b in want.values()]
    assert bj.block_stats(code, ps) == jbj.block_stats(code, js)
    assert bj.block_depth_for(code, ps) == jbj.block_depth_for(code, js)
    cap = code_cap_bucket(max(len(code), 1))
    np.testing.assert_array_equal(bj.build_block_row(code, cap, ps),
                                  jbj.build_block_row(code, cap, js))


@pytest.mark.parametrize("with_summary", [False, True], ids=["sweep", "summary"])
def test_block_table_and_bucket_equal_the_jax_package(with_summary):
    names = list(CODES)
    codes = [CODES[n] for n in names]
    js = [summaries(n)[0] if with_summary else None for n in names]
    ps = [summaries(n)[1] if with_summary else None for n in names]
    cap = code_cap_bucket(max(len(c) for c in codes))
    np.testing.assert_array_equal(bj.build_block_table(codes, cap, ps),
                                  jbj.build_block_table(codes, cap, js))
    assert tuple(block_phases(sp, bj, codes, ps)) == tuple(block_phases(jsp, jbj, codes, js))


def test_vendored_union_lowers_blocks():
    """Of the 13 vendored contracts only exceptions.sol.o passes the
    density floor, so their union bucket runs block substeps."""
    vendored = [n for n in CODES if n.endswith(".sol.o")]
    depths = {n: bj.block_depth_for(CODES[n], summaries(n)[1]) for n in vendored}
    assert {n for n, d in depths.items() if d} == {"exceptions.sol.o"}
    assert block_phases(sp, bj, [CODES[n] for n in vendored]).block_depth == bj.BLOCK_DEPTH


def test_block_summary_goldens():
    """The JAX suite's goldens on the port: the deadweight fixture's
    counts and reasons, ALUCHAIN's one block with its stack effect and
    gas, the fallback categories, and the computed jump that only the
    dataflow resolves."""
    from mythril_tpu_torch.support.opcodes import OPCODES

    stats = bj.block_stats(bytes.fromhex(deadweight_contract(0)))
    assert (stats["blocks_total"], stats["blocks_lowered"], stats["blocks_unlowered"]) == (
        10, 3, 7)
    assert stats["fallback_reasons"] == {"tiny": 5, "env": 1, "storage": 1}
    assert stats["lowered_density"] < bj.BLOCK_DENSITY_MIN
    code = bytes.fromhex(ALUCHAIN)
    blocks = bj.summarize_blocks(code)
    assert list(blocks) == [0] and blocks[0].lowerable and blocks[0].reason == "ok"
    net = need = gmin = gmax = 0
    for ins in asm.disassemble(code):
        _b, pops, pushes, lo, hi = OPCODES[ins.opcode]
        need = max(need, pops - net)
        net += pushes - pops
        gmin, gmax = gmin + lo, gmax + hi
    assert (blocks[0].net_sp, blocks[0].min_sp, blocks[0].gas_min, blocks[0].gas_max) == (
        net, need, gmin, gmax)
    for want, code_hex in {"call": "60006000600060006000600061deadf100", "storage": WRITER,
                           "memory": "6001600052600051500000", "env": KILLABLE}.items():
        assert want in bj.block_stats(bytes.fromhex(code_hex))["fallback_reasons"]
    jump = assemble("PUSH1 0x55\nPUSH1 0x03\nDUP1\nADD\nPUSH1 0x06\nADD\nSWAP1\nPOP\n"
                        "JUMP\nJUMPDEST\nSTOP")
    assert bj.summarize_blocks(jump, port_analyze(jump))[0].lowerable
    assert bj.summarize_blocks(jump)[0].reason == "unresolved-jump"


def test_block_row_goldens():
    row = bj.build_block_row(bytes.fromhex(ALUCHAIN), 32)
    assert row[0] == bj.ROW_HEAD and row[1] == 0 and row[16] == 0
    assert {int(i) for i in np.flatnonzero(row == bj.ROW_BODY)} == {
        2, 4, 5, 7, 8, 10, 11, 12, 13, 14, 15}
    row = bj.build_block_row(bytes.fromhex(WRITER), 32)
    assert {int(i) for i in np.flatnonzero(row == bj.ROW_FUSE)} == {0, 2, 5, 7}
    assert not (row >= bj.ROW_BODY).any()
    assert bj.block_depth_for(bytes.fromhex(ALUCHAIN)) == bj.BLOCK_DEPTH
    assert bj.block_depth_for(bytes.fromhex(WRITER)) == bj.block_depth_for(b"") == 0
    for code_hex in (WRITER, BRANCHER, GATED_BJ, ALUCHAIN, ALUWRITE):
        code = bytes.fromhex(code_hex)
        np.testing.assert_array_equal(sp.build_fuse_row(code, 64, port_analyze(code)),
                                      sp.build_fuse_row(code, 64))
    code = assemble("PUSH1 0x01\nPUSH1 0x04\nJUMP\nJUMPDEST\nPUSH1 0x02\nPOP\nPOP\nSTOP")
    runs = sp.fuse_run_lengths(code, port_analyze(code))
    assert any(start == 5 for start, _n in runs)
    assert sum(n for _s, n in sp.fuse_run_lengths(code)) >= sum(n for _s, n in runs)


# ---------------------------------------------------------------------------
# one block substep
# ---------------------------------------------------------------------------

PRUNED = PhaseSet(block_depth=bj.BLOCK_DEPTH, arith=False, shifts=False)


@pytest.mark.parametrize("phases", [None, PRUNED], ids=["generic", "pruned"])
@pytest.mark.parametrize("symbolic", [False, True], ids=["concrete", "symbolic"])
def test_block_substep_equals_the_jax_function(symbolic, phases):
    names, jb, jc, jt, jtid, pb, pc, pt, ptid = substep_inputs()
    jphases = None if phases is None else jsp.PhaseSet(*phases)
    pc_before = pb.pc.clone()
    if symbolic:
        fn = jax.jit(lambda s, c, t: jbj.sym_block_substep(s, c, t, phases=jphases))
        jout, jn, jblocks = fn(jax_make_sym_batch(jb)._replace(stack_tid=jtid), jc, jt)
        port_tid = ptid.clone()
        pout, pn, pblocks = bj.block_substep(pb, pc, pt, stack_tid=port_tid, phases=phases)
        np.testing.assert_array_equal(np.asarray(jout.stack_tid), port_tid.numpy())
        jout = jout.base
    else:
        fn = jax.jit(lambda b, c, t: jbj.block_substep(b, c, t, phases=jphases)[:3])
        jout, jn, jblocks = fn(jb, jc, jt)
        pout, pn, pblocks = bj.block_substep(pb, pc, pt, phases=phases)
    same_batch(jout, pout, "block substep")
    assert (int(pn), int(pblocks)) == (int(jn), int(jblocks))
    ran = executed(names, pc_before, pout.pc)
    assert {"push, gas wraps mod 2**32", "swap16", "jumpdest, block head",
            "sstore marked by mistake", "iszero second operand tainted2", "eq2"} <= ran
    assert not ran & {"push, gas one short", "push at the stack cap", "add underflow1",
                      "lt gas short2"}
    taint_or_wrap = {"add tainted2", "add wraps2", "sub underflows2", "mul overflows2",
                     "mul coarse: an operand above 128 bits2", "not opaque operand1",
                     "iszero tainted operand2"}
    pruned_ops = {n for n in names if n.split()[0].rstrip("0123456789") in (
        "add", "sub", "mul", "byte", "shl", "shr", "sar", "signextend")}
    if symbolic:
        # taint and the coarse wrap test defer to the full step
        assert not ran & taint_or_wrap
    elif phases is None:
        assert taint_or_wrap | {"sar negative by a huge amount2"} <= ran
    if phases is not None:
        assert pruned_ops and not ran & pruned_ops


SWEEP_LANES = 32
#: the JAX block substep, traced once for the sweep's shapes
_JAX_BLOCK_SUBSTEP = jax.jit(jbj.block_substep, static_argnames=("track_coverage", "phases"))


@pytest.mark.parametrize("symbolic", [False, True], ids=["concrete", "symbolic"])
@pytest.mark.parametrize("subject", SWEEP_SUBJECTS)
def test_block_substeps_equal_the_jax_function_on_the_sweep(subject, symbolic):
    """BLOCK_DEPTH block substeps over SWEEP_LANES seeded lanes that start
    on `subject` (random and edge operands, programs of lowered ops,
    stacks from empty to the cap): every field, the tids and the counts
    of each substep equal the JAX function's."""
    seed = SWEEP_SUBJECTS.index(subject)
    state = sweep_state(SWEEP_LANES, seed, subjects=(subject,))
    names, jb, jc, jt, jtid, pb, pc, pt, ptid = substep_inputs(state)
    jtid, ptid = (jtid, ptid.clone()) if symbolic else (None, None)
    pc_start = pb.pc.clone()
    first = None
    for _ in range(bj.BLOCK_DEPTH):
        jb, jn, jblocks, jtid = _JAX_BLOCK_SUBSTEP(jb, jc, jt, stack_tid=jtid)
        pb, pn, pblocks = bj.block_substep(pb, pc, pt, stack_tid=ptid)
        assert (int(pn), int(pblocks)) == (int(jn), int(jblocks))
        first = executed(names, pc_start, pb.pc) if first is None else first
    same_batch(jb, pb, f"sweep {subject}")
    if symbolic:
        np.testing.assert_array_equal(np.asarray(jtid), ptid.numpy())
    assert first, f"no {subject} lane executed its first substep"


# ---------------------------------------------------------------------------
# the block loops
# ---------------------------------------------------------------------------


def eq_inputs():
    codes = [bytes.fromhex(c) for c in EQ_CODES]
    jcode = jax_make_code_table(codes)
    cap = jcode.ops.shape[1] - 33
    table = bj.build_block_table(codes, cap)
    kw = dict(code_ids=[0, 1, 2, 3, 4] * 2, calldata=[b"\x42" * 8] * 10)
    return (codes, jax_make_batch(10, **kw), jcode, jnp.asarray(table),
            make_batch(10, device="cpu", **kw), make_code_table(codes, device="cpu"),
            torch.from_numpy(table))


@pytest.fixture(scope="module")
def eq_runs():
    codes, jb, jc, jt, pb, pc, pt = eq_inputs()
    jph, pph = block_phases(jsp, jbj, codes), block_phases(sp, bj, codes)
    assert tuple(pph) == tuple(jph) and pph.block_depth == bj.BLOCK_DEPTH
    jk, pk = jsp.kernel_cache().get(jph), sp.kernel_cache().get(pph)
    return {"run": (jk.run(jb, jc, jt, max_steps=64), pk.run(pb, pc, pt, max_steps=64)),
            "sym": (jk.sym_run(jax_make_sym_batch(jb), jc, jt, max_steps=64),
                    pk.sym_run(make_sym_batch(pb), pc, pt, max_steps=64)),
            "port_inputs": (pb, pc, pt, pph)}


def test_block_run_equals_the_jax_kernel(eq_runs):
    (jout, *jcounts), (pout, *pcounts) = eq_runs["run"]
    same_batch(jout, pout, "run")
    assert [int(x) for x in pcounts] == [int(x) for x in jcounts]
    assert int(pcounts[1]) > 0 and int(pcounts[2]) > 0


def test_block_sym_run_equals_the_jax_kernel(eq_runs):
    (jout, *jcounts), (pout, *pcounts) = eq_runs["sym"]
    same_symbatch(jout, pout, "sym_run")
    assert [int(x) for x in pcounts] == [int(x) for x in jcounts]
    assert int(pcounts[2]) > 0 and int(pcounts[3]) > 0


def test_blockjit_equals_generic(eq_runs):
    pb, pc, _pt, _ph = eq_runs["port_inputs"]
    generic, _ = port_run(pb, pc, max_steps=64)
    for name, x, y in zip(generic._fields, generic, eq_runs["run"][1][0]):
        assert torch.equal(x, y), name
    g_sym, _steps, _active = sym_run(make_sym_batch(pb), pc, max_steps=64)
    s_sym = eq_runs["sym"][1][0]
    for name, x, y in zip(g_sym.base._fields, g_sym.base, s_sym.base):
        assert torch.equal(x, y), name
    for name, x, y in zip(g_sym._fields[1:], g_sym[1:], s_sym[1:]):
        assert torch.equal(x, y), name


def test_sym_taint_and_wrap_defer_to_full_step():
    """ALU over calldata-tainted operands and a concretely wrapping ADD
    inside lowered blocks: the block bucket's arena and evidence banks
    equal the fuse-only bucket's (the same pruning)."""
    taint = bytes([0x60, 0x00, 0x35, 0x60, 0x08, 0x56, 0x00, 0x00, 0x5B, 0x60, 0x03, 0x02,
                   0x60, 0x07, 0x01, 0x80, 0x18, 0x50, 0x00])
    wrap = bytes([0x7F] + [0xFF] * 32 + [0x60, 0x02, 0x01, 0x50, 0x00])
    codes = [taint, wrap]
    table = make_code_table(codes, device="cpu")
    cap = table.ops.shape[1] - 33
    base = sp.union_phases([sp.phases_for(sp.signature_for(c), fuse=sp.fuse_profitable(c))
                            for c in codes])
    blocky = base._replace(block_depth=max(bj.block_depth_for(c) for c in codes))
    assert blocky.block_depth > 0
    batch = make_batch(4, code_ids=[0, 0, 1, 1], device="cpu",
                       calldata=[b"\xff" * 36, b"\x01" + b"\x00" * 35, b"", b""])
    g_out, *_ = sp.SpecializedKernel(base).sym_run(
        make_sym_batch(batch), table, torch.from_numpy(sp.build_fuse_table(codes, cap)), 64)
    s_out, _st, _a, _subs, blocks = sp.SpecializedKernel(blocky).sym_run(
        make_sym_batch(batch), table, torch.from_numpy(bj.build_block_table(codes, cap)), 64)
    assert int(blocks) > 0 and int(g_out.ar_count) > 0 and int(g_out.ev_cnt.sum()) > 0
    for name, x, y in zip(g_out._fields[1:], g_out[1:], s_out[1:]):
        assert torch.equal(x, y), name
    for name, x, y in zip(g_out.base._fields, g_out.base, s_out.base):
        assert torch.equal(x, y), name


def _aluchain(**kw):
    code = bytes.fromhex(ALUCHAIN)
    table = make_code_table([code], device="cpu")
    blk = torch.from_numpy(bj.build_block_table([code], table.ops.shape[1] - 33))
    batch = make_batch(2, code_ids=[0, 0], calldata=[b""] * 2, device="cpu", **kw)
    return code, table, blk, batch


def test_midblock_oog_replayed_by_generic_step():
    code, table, blk, batch = _aluchain(gas_budget=20)
    phases = sp.phases_for(sp.signature_for(code), fuse=sp.fuse_profitable(code),
                           block_depth=bj.block_depth_for(code))
    g_out, _ = port_run(batch, table, max_steps=64)
    s_out, *_ = sp.SpecializedKernel(phases).run(batch, table, blk, max_steps=64)
    assert (g_out.status == Status.ERR_OOG).all()
    for name, x, y in zip(g_out._fields, g_out, s_out):
        assert torch.equal(x, y), name


def test_pruned_opcode_parks_for_degrade_inside_lowered_block():
    code, table, blk, batch = _aluchain()
    wrong = sp.phases_for(sp.signature_for(code), fuse=False,
                          block_depth=bj.block_depth_for(code))._replace(arith=False)
    out, *_ = sp.SpecializedKernel(wrong).run(batch, table, blk, max_steps=32)
    assert (out.status == Status.UNSUPPORTED).all() and (out.pc == 4).all()


def test_vendored_block_wave_equals_the_pinned_jax_wave(pinned):
    phases, fused = hold_wave_to_pin(pinned["wave"], block=True)
    assert phases.block_depth == bj.BLOCK_DEPTH and int(fused) > 0


# ---------------------------------------------------------------------------
# the explorer, flags and the cache
# ---------------------------------------------------------------------------


def test_blockjit_explorer_fingerprints(pinned, monkeypatch):
    """Blockjit on has the JAX blockjit explorer's fingerprints (pinned)
    and blockjit off's; the counters go to blockjit_* on and to
    spec_fused_steps off, never both."""
    _, on = port_explore_run(EXPLORE_CODES)
    got = [fingerprint(c) for c in on["contracts"]]
    assert got == pinned["explorer"]["fingerprints"]
    for key, value in pinned["explorer"]["stats"].items():
        assert on["stats"][key] == value, key
    monkeypatch.setattr(port_args, "blockjit", False)
    _, off = port_explore_run(EXPLORE_CODES)
    assert [fingerprint(c) for c in off["contracts"]] == got
    assert on["stats"]["blockjit_steps"] > 0 and on["stats"]["blockjit_blocks"] > 0
    assert on["stats"]["blockjit_fallbacks"] > 0 and on["stats"]["spec_fused_steps"] == 0
    assert off["stats"]["blockjit_steps"] == off["stats"]["blockjit_blocks"] == 0
    assert off["stats"]["spec_fused_steps"] > 0
    assert "selfdestruct" in on["contracts"][0]["triggers"]


def test_no_blockjit_env_var_keeps_fuse_only_buckets(monkeypatch):
    monkeypatch.setenv("MYTHRIL_NO_BLOCKJIT", "1")
    assert not bj.blockjit_enabled()
    ex = port_explore.DeviceCorpusExplorer([ALUWRITE], lanes_per_contract=4, waves=1,
                                           steps_per_wave=16, specialize=True, device="cpu")
    assert ex.kernel_phases is not None and ex.kernel_phases.block_depth == 0
    monkeypatch.delenv("MYTHRIL_NO_BLOCKJIT")
    assert bj.blockjit_enabled()
    ex = port_explore.DeviceCorpusExplorer([ALUWRITE], lanes_per_contract=4, waves=1,
                                           steps_per_wave=16, specialize=True, device="cpu")
    assert ex.kernel_phases.block_depth == bj.BLOCK_DEPTH
    monkeypatch.setattr(port_args, "blockjit", False)
    assert not bj.blockjit_enabled()


def test_merge_policy_covers_blockjit_counters():
    for field in ("blockjit_steps", "blockjit_blocks", "blockjit_fallbacks"):
        assert port_explore.MERGE_POLICY[field] == "sum"


def test_kernel_cache_block_keys_are_distinct_buckets():
    cache = sp.KernelCache(capacity=4)
    base = PhaseSet(sha3=False)
    blocky = base._replace(block_depth=bj.BLOCK_DEPTH)
    k0, k1 = cache.get(base), cache.get(blocky)
    assert k0 is not k1 and cache.get(blocky) is k1
    stats = cache.stats()
    assert stats["misses"] == 2 and stats["hits"] == 1


def test_kernel_cache_block_key_pin_and_evict():
    cache = sp.KernelCache(capacity=2)
    pinned_kernel = cache.acquire(PhaseSet(block_depth=bj.BLOCK_DEPTH))
    cache.get(PhaseSet(exp=False, block_depth=bj.BLOCK_DEPTH))
    cache.get(PhaseSet(div=False, block_depth=bj.BLOCK_DEPTH))
    stats = cache.stats()
    assert stats["evictions"] == 1 and stats["pinned"] == 1
    assert cache.get(PhaseSet(block_depth=bj.BLOCK_DEPTH)) is pinned_kernel
    cache.release(pinned_kernel)


# ---------------------------------------------------------------------------
# the pin
# ---------------------------------------------------------------------------


def pin() -> None:
    jax.config.update("jax_platforms", "cpu")

    def setattr_(obj, name, value):
        setattr(obj, name, value)

    set_flags(setattr_, specialize=True, blockjit=True)
    out = {"wave": jax_wave(block=True),
           "explorer": jax_explore_fingerprints(setattr_, EXPLORE_CODES, blockjit=True)}
    out["explorer"]["explore_kw"] = {k: v for k, v in EXPLORE_KW.items()}
    PINNED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}: steps {out['wave']['steps']}, substep lane-steps "
          f"{out['wave']['substep_steps']}, blocks {out['wave']['blocks']}")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    if sys.argv[1:] == ["--pin"]:
        pin()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_blockjit.py --pin")
