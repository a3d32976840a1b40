"""The port's kernel specialization (laser/batch/specialize.py) against
the JAX package's, on the CPU (the plain substeps; the CUDA kernel is
held to them on the card by chip_smoke.py).

- host decisions: `signature_for`, `phases_for` with `fuse_profitable`,
  the fuse rows, `fuse_run_lengths` and `union_phases` equal the JAX
  package's on the 13 vendored contracts, the fault-suite fixtures and
  the 14 detection modules' positive fixtures, with and without a
  static summary;
- one fused substep (`torch_substep_cases`: a lane a hazard) equals the
  JAX `fused_substep` / `sym_fused_substep`, every field;
- the specialized loops: `SpecializedKernel.run` / `sym_run` equal the
  JAX ones at the JAX suite's equivalence setup (its five codes, 10
  lanes, 64 steps), every field and (steps, fused, blocks); a 13-stripe
  vendored wave equals the JAX one's pinned digests;
- the port against itself: specialized equals generic, and a pruned
  opcode parks its lane UNSUPPORTED at the instruction;
- the explorer (fault suite, seed 7): the specialized port explorer has
  the pinned fingerprints of the JAX specialized explorer and the port's
  generic one's;
- flags, the kernel cache (not the JAX service engine's), and the
  fallbacks: a host-side setup failure is recorded `specialize-failed`,
  a faulted specialized wave is retried on the generic kernel.

Exact equality throughout. This file runs with blockjit off in both
packages (fuse-only buckets; tests/test_torch_blockjit.py has the block
substeps). The JAX sides that compile the vendored wave and run the
explorer are pinned in tests/test_torch_specialize_pinned.json; re-pin
with

    PYTHONPATH=. python tests/test_torch_specialize.py --pin
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_substep_cases as cases
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu.analysis.static import analyze_bytecode as jax_analyze
from mythril_tpu.laser.batch import specialize as jsp
from mythril_tpu.laser.batch.state import StateBatch as JaxBatch
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu.laser.batch.symbolic import make_sym_batch as jax_make_sym_batch
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch import interop
from mythril_tpu_torch.analysis.static import analyze_bytecode as port_analyze
from mythril_tpu_torch.laser import symbolic_wave as wave
from mythril_tpu_torch.laser.batch import explore as port_explore
from mythril_tpu_torch.laser.batch import specialize as sp
from mythril_tpu_torch.laser.batch.run import run as port_run
from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket
from mythril_tpu_torch.laser.batch.state import Status, make_batch, make_code_table
from mythril_tpu_torch.laser.batch.step import PhaseSet
from mythril_tpu_torch.laser.batch.symbolic import make_sym_batch, sym_run
from mythril_tpu_torch.support import resilience
from mythril_tpu_torch.support.support_args import args as port_args

torch.set_num_threads(1)

PINNED = Path(__file__).with_name("test_torch_specialize_pinned.json")
REPO = Path(__file__).resolve().parents[1]

WRITER = "6001600055600060015500"
BRANCHER = "600035600757005b600160005500"
KILLABLE = "33ff"
GATED = "60003560f81c604214600d57005b600160005500"
PUSHY = "600160026003600450809101600055"
FIXTURES = {"WRITER": WRITER, "BRANCHER": BRANCHER, "KILLABLE": KILLABLE,
            "GATED": GATED, "PUSHY": PUSHY}
#: the JAX suite's equivalence codes (tests/laser/test_specialize.py)
EQ_CODES = (WRITER, BRANCHER, KILLABLE, GATED, PUSHY)
#: the 13-stripe vendored wave held to the pin (4 lanes a contract)
WAVE = {"stripes": 13, "lanes_per_stripe": 4, "max_steps": 96}
FAULT_SUITE = [KILLABLE, WRITER, BRANCHER, GATED]
EXPLORE_KW = dict(lanes_per_contract=8, waves=3, steps_per_wave=64, transaction_count=1,
                  seed=7, pipeline=False)


def module_fixture_codes():
    """{module: positive-fixture bytecode}: the fixture suite's own list."""
    path = REPO / "tests" / "analysis" / "test_module_positive_fixtures.py"
    spec = importlib.util.spec_from_file_location("_module_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: code for name, (code, _swc) in mod.FIXTURES.items()}


def decision_codes():
    """{name: code bytes} of every contract the host decisions are held on."""
    out = {p.name: bytes.fromhex(p.read_text().strip())
           for p in sorted(wave.CONTRACTS.glob("*.sol.o"))}
    out.update({name: bytes.fromhex(code) for name, code in FIXTURES.items()})
    out.update({f"module:{name}": bytes.fromhex(code[2:] if code.startswith("0x") else code)
                for name, code in module_fixture_codes().items()})
    return out


CODES = decision_codes()


@functools.lru_cache(maxsize=None)
def summaries(name):
    """(JAX, port) static summaries of one decision code."""
    return jax_analyze(CODES[name]), port_analyze(CODES[name])


def fingerprint(contract):
    """Coverage, trigger pcs by kind, evidence (class, pc): what issue
    synthesis reads (the JAX suites' `_fingerprint`), as JSON-able lists."""
    return [
        [list(b) for b in contract["covered_branches"]],
        {kind: sorted(t["pc"] for t in bucket)
         for kind, bucket in sorted(contract["triggers"].items())},
        sorted([e["class"], e["pc"]] for e in contract["evidence"]),
    ]


def set_flags(setattr_, specialize=True, blockjit=False):
    """Both packages: the flags of the JAX suite (static pruning off, the
    device-first funnel, the JAX host ladder off) with `specialize` and
    `blockjit` as given; the port's ladder off (a zero cap)."""
    from mythril_tpu.laser.batch import explore as jax_explore

    for flag, value in (("static_prune", False), ("device_first", True),
                        ("specialize", specialize), ("blockjit", blockjit)):
        setattr_(jax_args, flag, value)
    setattr_(jax_explore.DeviceCorpusExplorer, "_sprint_cap_s", lambda self: -1.0)
    for flag, value in (("static_prune", False), ("sprint_cap_s", 0.0),
                        ("specialize", specialize), ("blockjit", blockjit)):
        setattr_(port_args, flag, value)
    return jax_explore


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    set_flags(monkeypatch.setattr)


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


def same_batch(jax_out, port_out, what):
    want = jax.device_get(jax_out)
    got = interop.batch_to_numpy(port_out)
    for name, x, y in zip(JaxBatch._fields, want, got):
        np.testing.assert_array_equal(np.asarray(x), y, f"{what}: {name}")


def same_symbatch(jax_out, port_out, what):
    want = jax.device_get(jax_out)
    got = interop.symbatch_to_numpy(port_out)
    same_batch(want.base, port_out.base, what)
    for name, x, y in zip(want._fields[1:], want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(x), y, f"{what}: {name}")


# ---------------------------------------------------------------------------
# host decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_summary", [False, True], ids=["sweep", "summary"])
@pytest.mark.parametrize("name", list(CODES))
def test_host_decisions_equal_the_jax_package(name, with_summary):
    code = CODES[name]
    js, ps = summaries(name) if with_summary else (None, None)
    sig = sp.signature_for(code, ps)
    assert sig == jsp.signature_for(code, js)
    fuse = sp.fuse_profitable(code, ps)
    assert fuse == jsp.fuse_profitable(code, js)
    assert tuple(sp.phases_for(sig, fuse=fuse)) == tuple(jsp.phases_for(sig, fuse=fuse))
    assert sp.fuse_run_lengths(code, ps) == jsp.fuse_run_lengths(code, js)
    cap = code_cap_bucket(max(len(code), 1))
    np.testing.assert_array_equal(sp.build_fuse_row(code, cap, ps),
                                  jsp.build_fuse_row(code, cap, js))


@pytest.mark.parametrize("with_summary", [False, True], ids=["sweep", "summary"])
def test_union_and_fuse_table_equal_the_jax_package(with_summary):
    names = list(CODES)
    codes = [CODES[n] for n in names]
    js = [summaries(n)[0] if with_summary else None for n in names]
    ps = [summaries(n)[1] if with_summary else None for n in names]
    port = sp.union_phases([sp.phases_for(sp.signature_for(c, s)) for c, s in zip(codes, ps)])
    want = jsp.union_phases([jsp.phases_for(jsp.signature_for(c, s))
                             for c, s in zip(codes, js)])
    assert tuple(port) == tuple(want)
    assert tuple(sp.union_phases([])) == tuple(jsp.union_phases([]))
    cap = code_cap_bucket(max(len(c) for c in codes))
    np.testing.assert_array_equal(sp.build_fuse_table(codes, cap, ps),
                                  jsp.build_fuse_table(codes, cap, js))


def test_decision_goldens():
    """The JAX suite's goldens, on the port: WRITER prunes all but
    sstore; the fuse row marks exactly the fusible pcs; PUSHY's first run
    is 7 ops and its second the PUSH1 before SSTORE; the profitability
    gate."""
    ph = sp.phases_for(sp.signature_for(bytes.fromhex(WRITER)))
    assert ph.sstore and not ph.sload and ph.fuse_depth == sp.FUSE_DEPTH
    assert {int(i) for i in np.flatnonzero(sp.build_fuse_row(bytes.fromhex(WRITER), 32))} == {
        0, 2, 5, 7}
    runs = sp.fuse_run_lengths(bytes.fromhex(PUSHY))
    assert runs[0] == (0, 7) and runs[1] == (12, 1)
    assert sp.fuse_profitable(bytes.fromhex(PUSHY)) and sp.fuse_profitable(bytes.fromhex(WRITER))
    assert not sp.fuse_profitable(bytes.fromhex(KILLABLE)) and not sp.fuse_profitable(b"")
    assert sp.phases_for(sp.signature_for(b"\x00"), fuse=False).fuse_depth == 0


# ---------------------------------------------------------------------------
# one fused substep
# ---------------------------------------------------------------------------


def substep_inputs(state=None):
    """The hazard lanes (or another `cases` state) for both packages:
    (names, JAX batch, JAX code table, JAX table, JAX tids, port batch,
    port code table, port table, port tids)."""
    names, fields, ops, length, table, tids = state or cases.substep_state()
    jd = np.zeros((ops.shape[0], ops.shape[1] - 33), bool)
    jbatch = JaxBatch(*(jnp.asarray(x) for x in fields))
    jcode = type(jax_make_code_table([b"\x00"]))(jnp.asarray(ops), jnp.asarray(jd),
                                                 jnp.asarray(length))
    pbatch = interop.batch_from_numpy(fields, device="cpu")
    pcode = interop.code_table_from_numpy((ops, jd, length), device="cpu")
    return (names, jbatch, jcode, jnp.asarray(table), jnp.asarray(tids), pbatch, pcode,
            torch.from_numpy(table), torch.from_numpy(tids))


def executed(names, pc_before, pc_after):
    """The cases whose lane a substep advanced."""
    return {n for n, a, b in zip(names, pc_before.tolist(), pc_after.tolist()) if a != b}


@pytest.mark.parametrize("symbolic", [False, True], ids=["concrete", "symbolic"])
def test_fused_substep_equals_the_jax_function(symbolic):
    names, jb, jc, jt, jtid, pb, pc, pt, ptid = substep_inputs()
    pc_before = pb.pc.clone()
    if symbolic:
        jout, jn = jax.jit(jsp.sym_fused_substep)(
            jax_make_sym_batch(jb)._replace(stack_tid=jtid), jc, jt)
        port_tid = ptid.clone()
        pout, pn = sp.fused_substep(pb, pc, pt, stack_tid=port_tid)
        np.testing.assert_array_equal(np.asarray(jout.stack_tid), port_tid.numpy())
        jout = jout.base
    else:
        jout, jn, *_ = jax.jit(jsp.fused_substep)(jb, jc, jt)
        pout, pn = sp.fused_substep(pb, pc, pt)
    same_batch(jout, pout, "fused substep")
    assert int(pn) == int(jn)
    ran = executed(names, pc_before, pout.pc)
    # the hazards decide as the JAX substep does: the gas sum wraps, a
    # pc past the table reads its last column, bit 31 of a coverage
    # word; a fuse-mode substep takes only ROW_FUSE (1) rows
    assert {"push, gas wraps mod 2**32", "push, gas exactly the budget",
            "push at pc 45: the table clips to its last column",
            "push at pc 31: coverage bit 31", "dup3", "swap2", "pop"} <= ran
    assert not ran & {"push, gas one short", "push at the stack cap", "push, unmarked",
                      "push, halted", "push2 past the code length", "dup16 underflow",
                      "jumpdest, block head", "swap16", "add2"}
    assert int(pout.pc_seen[names.index("push at pc 31: coverage bit 31"), 0]) < 0


# ---------------------------------------------------------------------------
# the specialized loops
# ---------------------------------------------------------------------------


def eq_inputs(table_fn):
    """The JAX suite's equivalence setup in both packages: (JAX batch,
    code table, table, port batch, code table, table)."""
    codes = [bytes.fromhex(c) for c in EQ_CODES]
    jcode = jax_make_code_table(codes)
    cap = jcode.ops.shape[1] - 33
    table = table_fn(codes, cap)
    kw = dict(code_ids=[0, 1, 2, 3, 4] * 2, calldata=[b"\x42" * 8] * 10)
    return (jax_make_batch(10, **kw), jcode, jnp.asarray(table),
            make_batch(10, device="cpu", **kw), make_code_table(codes, device="cpu"),
            torch.from_numpy(table))


def eq_phases(pkg):
    codes = [bytes.fromhex(c) for c in EQ_CODES]
    return pkg.union_phases([pkg.phases_for(pkg.signature_for(c)) for c in codes])


@pytest.fixture(scope="module")
def eq_runs():
    """Both packages' specialized run and sym_run at the equivalence
    setup (one JAX bucket, two compiles)."""
    jb, jc, jt, pb, pc, pt = eq_inputs(jsp.build_fuse_table)
    jk, pk = jsp.kernel_cache().get(eq_phases(jsp)), sp.kernel_cache().get(eq_phases(sp))
    return {"run": (jk.run(jb, jc, jt, max_steps=64), pk.run(pb, pc, pt, max_steps=64)),
            "sym": (jk.sym_run(jax_make_sym_batch(jb), jc, jt, max_steps=64),
                    pk.sym_run(make_sym_batch(pb), pc, pt, max_steps=64)),
            "port_inputs": (pb, pc, pt)}


def test_phase_decisions_of_the_equivalence_setup():
    assert tuple(eq_phases(sp)) == tuple(eq_phases(jsp))
    assert eq_phases(sp).fuse_depth == sp.FUSE_DEPTH and eq_phases(sp).block_depth == 0


def test_specialized_run_equals_the_jax_kernel(eq_runs):
    (jout, *jcounts), (pout, *pcounts) = eq_runs["run"]
    same_batch(jout, pout, "run")
    assert [int(x) for x in pcounts] == [int(x) for x in jcounts]
    assert int(pcounts[1]) > 0  # the fused substeps advanced work


def test_specialized_sym_run_equals_the_jax_kernel(eq_runs):
    (jout, *jcounts), (pout, *pcounts) = eq_runs["sym"]
    same_symbatch(jout, pout, "sym_run")
    assert [int(x) for x in pcounts] == [int(x) for x in jcounts]
    assert int(pcounts[2]) > 0


def test_specialized_equals_generic(eq_runs):
    pb, pc, _ = eq_runs["port_inputs"]
    generic, _ = port_run(pb, pc, max_steps=64)
    spec = eq_runs["run"][1][0]
    for name, x, y in zip(generic._fields, generic, spec):
        assert torch.equal(x, y), name
    g_sym, _steps, _active = sym_run(make_sym_batch(pb), pc, max_steps=64)
    s_sym = eq_runs["sym"][1][0]
    for name, x, y in zip(g_sym._fields[1:], g_sym[1:], s_sym[1:]):
        assert torch.equal(x, y), name
    for name, x, y in zip(g_sym.base._fields, g_sym.base, s_sym.base):
        assert torch.equal(x, y), name


def test_pruned_opcode_degrades_to_unsupported_not_silent():
    """A lane that reaches an opcode whose phase is pruned parks AT the
    instruction with UNSUPPORTED, never advanced past it."""
    code = bytes.fromhex(WRITER)
    table = make_code_table([code], device="cpu")
    batch = make_batch(2, calldata=[b""] * 2, device="cpu")
    wrong = sp.phases_for(sp.signature_for(code))._replace(sstore=False)
    out, _ = port_run(batch, table, max_steps=32, phases=wrong)
    assert (out.status == Status.UNSUPPORTED).all()
    assert (out.pc == 4).all()
    fuse = torch.from_numpy(sp.build_fuse_table([code], table.ops.shape[1] - 33))
    out, *_ = sp.SpecializedKernel(wrong).run(batch, table, fuse, max_steps=32)
    assert (out.status == Status.UNSUPPORTED).all() and (out.pc == 4).all()


def vendored_wave(device=None):
    codes = wave.load_contracts()
    code_ids, calldata, cap = wave.wave_inputs(codes, WAVE["stripes"],
                                               WAVE["lanes_per_stripe"])
    return codes, code_ids, calldata, cap


def wave_phases(pkg, codes, block=False):
    bj = None
    if block:
        bj = importlib.import_module(pkg.__name__.rsplit(".", 1)[0] + ".blockjit")
    return pkg.union_phases([
        pkg.phases_for(pkg.signature_for(c), fuse=pkg.fuse_profitable(c),
                       block_depth=bj.block_depth_for(c) if block else 0)
        for c in codes])


def port_wave(block=False):
    """The port's specialized 13-stripe wave: (phases, out, steps,
    active, substep lane-steps, blocks)."""
    from mythril_tpu_torch.laser.batch import blockjit as bj

    codes, code_ids, calldata, cap = vendored_wave()
    phases = wave_phases(sp, codes, block)
    table = (bj.build_block_table if block else sp.build_fuse_table)(codes, cap)
    base = make_batch(len(code_ids), code_ids=code_ids, calldata=calldata, device="cpu",
                      **wave.BATCH_KWARGS)
    out = sp.SpecializedKernel(phases).sym_run(
        make_sym_batch(base), make_code_table(codes, code_cap=cap, device="cpu"),
        torch.from_numpy(table), max_steps=WAVE["max_steps"])
    return (phases,) + tuple(out)


def jax_wave(block=False):
    """The JAX package's specialized 13-stripe wave (the pin's content)."""
    from mythril_tpu.laser.batch import blockjit as jbj

    codes, code_ids, calldata, cap = vendored_wave()
    phases = wave_phases(jsp, codes, block)
    table = (jbj.build_block_table if block else jsp.build_fuse_table)(codes, cap)
    base = jax_make_batch(len(code_ids), code_ids=code_ids, calldata=calldata,
                          **wave.BATCH_KWARGS)
    out, steps, active, fused, blocks = jsp.SpecializedKernel(phases).sym_run(
        jax_make_sym_batch(base), jax_make_code_table(codes, code_cap=cap),
        jnp.asarray(table), max_steps=WAVE["max_steps"])
    return {"settings": WAVE, "phases": list(phases), "steps": int(steps),
            "active": int(active), "substep_steps": int(fused), "blocks": int(blocks),
            "digests": wave.field_digests(jax.device_get(out))}


def hold_wave_to_pin(pin, block=False):
    phases, out, steps, active, fused, blocks = port_wave(block)
    assert pin["settings"] == WAVE
    assert list(phases) == pin["phases"]
    assert (steps, int(active), int(fused), int(blocks)) == (
        pin["steps"], pin["active"], pin["substep_steps"], pin["blocks"])
    got = wave.field_digests(interop.symbatch_to_numpy(out))
    assert [k for k in got if got[k] != pin["digests"][k]] == []
    return phases, fused


def test_vendored_wave_equals_the_pinned_jax_wave(pinned):
    phases, fused = hold_wave_to_pin(pinned["wave"])
    assert phases.block_depth == 0 and phases.fuse_depth == sp.FUSE_DEPTH
    assert int(fused) > 0


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------


def port_explore_run(codes, **kw):
    ex = port_explore.DeviceCorpusExplorer(codes, device="cpu", **dict(EXPLORE_KW, **kw))
    return ex, ex.run()


def jax_explore_fingerprints(setattr_, codes, blockjit=False):
    """The JAX explorer, specialized (the pin's content)."""
    jax_explore = set_flags(setattr_, specialize=True, blockjit=blockjit)
    res = jax_explore.DeviceCorpusExplorer(codes, **EXPLORE_KW).run()
    return {"fingerprints": [fingerprint(c) for c in res["contracts"]],
            "stats": {k: res["stats"][k] for k in (
                "specialized", "spec_pruned_phases", "blockjit_fallbacks")}}


def test_specialized_explorer_fingerprints(pinned, monkeypatch):
    """The fault suite at seed 7: the port's specialized explorer has the
    JAX specialized explorer's fingerprints (pinned) and the port's
    generic explorer's."""
    ex, spec = port_explore_run(FAULT_SUITE)
    got = [fingerprint(c) for c in spec["contracts"]]
    want = pinned["explorer"]
    assert got == want["fingerprints"]
    for key, value in want["stats"].items():
        assert spec["stats"][key] == value, key
    assert spec["stats"]["spec_fused_steps"] > 0 and spec["stats"]["blockjit_steps"] == 0
    assert "selfdestruct" in spec["contracts"][0]["triggers"]
    assert ex._kernel.refs == 0  # the run released its pin
    monkeypatch.setattr(port_args, "specialize", False)
    gex, generic = port_explore_run(FAULT_SUITE)
    assert gex._kernel is None and generic["stats"]["specialized"] == 0
    assert [fingerprint(c) for c in generic["contracts"]] == got
    assert generic["stats"]["spec_fused_steps"] == 0


def test_no_specialize_flag_restores_generic_path(monkeypatch):
    monkeypatch.setattr(port_args, "specialize", False)
    ex, out = port_explore_run([WRITER], waves=1)
    assert ex._kernel is None and ex.kernel_phases is None
    assert out["stats"]["specialized"] == 0
    monkeypatch.setattr(port_args, "specialize", True)
    ex = port_explore.DeviceCorpusExplorer([WRITER], device="cpu")
    assert ex._kernel is not None and ex.kernel_phases.sstore
    assert sp.specialize_enabled()


def test_setup_failure_is_recorded_not_silent():
    """A host-side failure of the specialization setup explores on the
    generic kernel, as in the JAX package, and is recorded
    `specialize-failed`."""
    log = resilience.DegradationLog()
    mark = log.marker()
    resilience.arm_fault("explore.specialize", exc=ValueError("no signature"))
    try:
        ex = port_explore.DeviceCorpusExplorer([WRITER], device="cpu")
    finally:
        resilience.disarm_faults()
    assert ex._kernel is None and ex.specialize_failed == 1
    assert ex.stats.specialized == 0
    assert log.counts_since(mark) == {"specialize-failed": 1}
    assert log.events[-1]["site"] == "explorer"


def test_faulted_specialized_wave_retries_on_the_generic_kernel():
    """A device fault in a specialized dispatch is retried through the
    ladder on the generic kernel (spec_fallbacks), and the exploration
    ends with the same fingerprints."""
    resilience.arm_fault("kernel.compile", exc=RuntimeError("CUDA error: injected"))
    try:
        ex, out = port_explore_run([GATED], waves=2)
    finally:
        resilience.disarm_faults()
    assert out["stats"]["spec_fallbacks"] == 1
    _, clean = port_explore_run([GATED], waves=2)
    assert [fingerprint(c) for c in out["contracts"]] == [
        fingerprint(c) for c in clean["contracts"]]


def test_cli_flags_and_defaults(monkeypatch):
    """The defaults are the JAX package's (on); --no-specialize and
    --no-blockjit turn them off."""
    from mythril_tpu.support.support_args import Args as JaxArgs
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import Args as PortArgs

    jax_defaults = JaxArgs.__new__(JaxArgs)
    JaxArgs.__init__(jax_defaults)
    port_defaults = PortArgs.__new__(PortArgs)
    PortArgs.__init__(port_defaults)
    for flag in ("specialize", "blockjit"):
        assert getattr(port_defaults, flag) is getattr(jax_defaults, flag) is True
    parser = cli.build_parser()
    parsed = parser.parse_args(["analyze", "--bin-runtime", "-c", "00"])
    assert not parsed.no_specialize and not parsed.no_blockjit
    parsed = parser.parse_args(["analyze", "--bin-runtime", "-c", "00", "--no-specialize",
                                "--no-blockjit"])
    assert parsed.no_specialize and parsed.no_blockjit


# ---------------------------------------------------------------------------
# the kernel cache
# ---------------------------------------------------------------------------


def test_kernel_cache_buckets_share_kernels():
    cache = sp.KernelCache(capacity=4)
    a = sp.phases_for(sp.signature_for(bytes.fromhex(WRITER)))
    b = sp.phases_for(sp.signature_for(bytes.fromhex(WRITER)))
    assert cache.get(a) is cache.get(b)
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1


def test_kernel_cache_evicts_lru_and_keeps_pins():
    cache = sp.KernelCache(capacity=2)
    buckets = [PhaseSet(sha3=False), PhaseSet(exp=False), PhaseSet(div=False)]
    pinned_kernel = cache.acquire(buckets[0])
    cache.get(buckets[1])
    cache.get(buckets[2])
    stats = cache.stats()
    assert stats["evictions"] == 1 and stats["pinned"] == 1
    assert cache.get(buckets[0]) is pinned_kernel
    cache.release(pinned_kernel)
    cache.get(PhaseSet(modops=False))
    assert cache.stats()["size"] <= 2


def test_eviction_during_warmup_defers_drop_to_release():
    cache = sp.KernelCache(capacity=1)
    k1 = cache.get(PhaseSet(sha3=False))
    cache.pin_warmup(k1)
    k2 = cache.get(PhaseSet(exp=False))
    stats = cache.stats()
    assert stats["evictions"] == 1 and stats["inflight_evictions"] == 1
    assert k1._run is not None
    assert cache._entries.get(k1.phases) is not k1
    cache.release_warmup(k1)
    assert k1._run is None
    with pytest.raises(RuntimeError, match="dropped"):
        k1.sym_run(None, None, None, 1)
    assert k2._run is not None
    assert cache.stats()["inflight_evictions"] == 1


def test_warmup_pin_survives_when_not_evicted():
    cache = sp.KernelCache(capacity=4)
    k1 = cache.get(PhaseSet(div=False))
    cache.pin_warmup(k1)
    cache.release_warmup(k1)
    assert k1.warm_refs == 0 and k1._run is not None
    assert cache.get(k1.phases) is k1


def test_first_calls_are_timed_per_shape(eq_runs):
    """`compiles` counts the distinct (entry, shape) first dispatches."""
    kernel = sp.kernel_cache().get(eq_phases(sp))
    assert kernel.compiles >= 2 and kernel.compile_s > 0
    assert kernel.is_warm(kernel.run_key(eq_runs["port_inputs"][0],
                                         eq_runs["port_inputs"][1], False))
    stats = sp.kernel_cache_stats()
    assert stats["compiles"] >= 2 and "plane_hits" not in stats


# ---------------------------------------------------------------------------
# the pin
# ---------------------------------------------------------------------------


def pin() -> None:
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).parent))

    def setattr_(obj, name, value):
        setattr(obj, name, value)

    set_flags(setattr_)
    out = {"wave": jax_wave(), "explorer": jax_explore_fingerprints(setattr_, FAULT_SUITE)}
    PINNED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}: steps {out['wave']['steps']}, substep lane-steps "
          f"{out['wave']['substep_steps']}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        pin()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_specialize.py --pin")
