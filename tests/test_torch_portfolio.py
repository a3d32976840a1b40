"""The port's portfolio solver against the JAX package's.

- `compile_program`: queries built in the same order with the same
  builder over both packages' term layers compile to equal arrays.
- `portfolio_eval`'s plain version is bit-equal to the JAX `score` on
  numpy-seeded candidates, over random programs that use every op of
  `OPS` and over one program per hazard, at L = 16 and L = 32. All JAX
  scores share one shape per L (K = 16 candidates, N = 64 nodes, 16
  constants and roots, V = 4 variables), so the JAX interpreter compiles
  twice.
- `device_enumerate` (K = 1024, V = 2) equals the JAX one, verdict and
  witness, on spaces of 10 bits or fewer, UNSAT included;
  `rank_impact_vars` and `cube_queries` equal the JAX ones.
- The SLS helpers copy the JAX search's rules (move kinds, polarity
  seeding, Luby restarts, the solved-first argmax); the plain SLS is
  deterministic for a seed.
- On a fixed corpus of narrow queries (32-bit, under 64 nodes, some
  solved at some seeds only) the port's `device_solve_batch` (first
  pass only: cube_depth 0), over the seeds CORPUS_SEEDS, solves at
  least as many as the JAX package did when pinned with the same
  settings, less CORPUS_ALLOWANCE (the two draw different random
  streams); the pin holds both packages' verdicts per query and seed
  (tests/testdata/torch_portfolio_corpus.json). Every port SAT passes
  the JAX `eval_term` on the JAX-built query, and every port UNSAT comes
  from enumeration. Regenerate the pin with

    PYTHONPATH=. python tests/test_torch_portfolio.py --pin

Everything runs on the CPU (`device="cpu"`: the kernels' plain
versions); the kernels themselves are held to these plain versions on
the card by chip_smoke.py.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu.laser.smt import terms as JT
from mythril_tpu.laser.smt.evalterm import eval_term as jax_eval
from mythril_tpu.laser.smt.solver import portfolio as jp
from mythril_tpu_torch.laser.flip_frontier import canonical_digest
from mythril_tpu_torch.laser.smt import terms as PT
from mythril_tpu_torch.laser.smt.solver import portfolio as pp
from mythril_tpu_torch.ops import portfolio_eval as pe
from mythril_tpu_torch.ops import portfolio_sls as ps

torch.set_num_threads(1)

CORPUS_PIN = Path(__file__).with_name("testdata") / "torch_portfolio_corpus.json"
CORPUS_SEEDS = range(8)  # one port dispatch a seed; query q of it is keyed seed + q
# SATs the port may fall short of the pinned JAX count over the corpus and
# seeds: about one standard deviation of the marginal queries' count (32
# trials at rates of 10-90%); the port's own count at the pin is recorded
CORPUS_ALLOWANCE = 2
# a verdict per query and seed: S sat by SLS, E sat by enumeration, N unsat
# by enumeration, U unknown
VERDICT_CODES = {("sat", "sls"): "S", ("sat", "enum"): "E", ("unsat", "enum"): "N",
                 ("unknown", None): "U"}
K_EVAL, N_EVAL, C_EVAL, R_EVAL, V_EVAL = 16, 64, 16, 16, 4
W = 32


# ---------------------------------------------------------------------------
# query builders: one function, either package's term layer
# ---------------------------------------------------------------------------


def compile_queries(T, tag):
    """Queries over four 32-bit variables that use the device language's
    ops (each compiles to at most 64 nodes)."""
    x, y, z, u = (T.bv_var(f"{tag}_{n}", W) for n in "xyzu")
    c = lambda v: T.bv_const(v, W)  # noqa: E731
    return [
        [T.eq(T.add(x, y), c(0x1234)), T.ult(z, c(100)), T.bnot(T.eq(u, c(7)))],
        [T.eq(T.bvand(T.mul(x, c(3)), c(0xFF00)), c(0x4200)),
         T.eq(T.udiv(y, c(3)), T.urem(z, c(1000))), T.ule(u, T.sub(x, y))],
        [T.slt(x, c(0)), T.sle(T.sext(T.extract(7, 0, y), 24), z),
         T.eq(T.ashr(u, c(3)), T.lshr(x, c(29))),
         T.eq(T.shl(z, T.extract(31, 0, T.concat(T.bv_const(0, 8), y))), u)],
        [T.bor(T.eq(T.ite(T.ult(x, y), x, y), c(5)), T.bxor(T.ult(z, u), T.ult(u, z))),
         T.implies(T.eq(x, y), T.eq(T.zext(T.extract(15, 0, z), 16), u)),
         T.bnot(T.band(T.eq(T.bvxor(x, z), u), T.eq(T.bvor(y, u), T.bvnot(z))))],
    ]


def enum_queries(T, tag):
    """Two-variable queries over at most 10 bits (one chunk of 1024
    candidates): SAT and UNSAT."""
    a, b = T.bv_var(f"{tag}_a", 5), T.bv_var(f"{tag}_b", 5)
    p, q = T.bv_var(f"{tag}_p", 4), T.bv_var(f"{tag}_q", 4)
    c5 = lambda v: T.bv_const(v, 5)  # noqa: E731
    c4 = lambda v: T.bv_const(v, 4)  # noqa: E731
    return [
        [T.eq(T.add(a, b), c5(0x17)), T.eq(T.bvxor(a, b), c5(0x17)), T.ult(b, a)],
        [T.eq(T.mul(a, c5(2)), T.add(T.mul(b, c5(2)), c5(1)))],        # odd = even: UNSAT
        [T.ult(p, q), T.ult(q, c4(3)), T.ult(c4(0), p)],               # 0 < p < q < 3
        [T.ult(p, q), T.ult(q, p)],                                    # UNSAT
        [T.eq(T.urem(p, q), c4(3)), T.eq(T.udiv(p, q), c4(2))],
    ]


def corpus(T, tag):
    """The narrow SLS corpus: 32-bit variables, under 64 nodes each. Most
    queries any working search solves; the three before the last, and
    the fifth, are marginal (the first pass solves them at some seeds
    only), so that a weaker search shows in the solve rate over
    CORPUS_SEEDS; the last is one neither package solves."""
    x, y = T.bv_var(f"{tag}_x", W), T.bv_var(f"{tag}_y", W)
    s, t = T.bv_var(f"{tag}_s", 16), T.bv_var(f"{tag}_t", 16)
    n, m = T.bv_var(f"{tag}_n", 4), T.bv_var(f"{tag}_m", 4)
    c = lambda v: T.bv_const(v, W)  # noqa: E731
    return [
        [T.eq(T.add(x, y), c(0x1234)), T.ult(x, c(100))],
        [T.eq(T.bvand(x, c(0xFF00)), c(0x4200)), T.bnot(T.eq(y, c(0)))],
        [T.eq(T.bvxor(x, c(0x1)), c(0xA9059CBB))],
        [T.ult(x, c(1000)), T.ult(c(500), x), T.eq(T.urem(x, c(7)), c(3))],
        [T.eq(T.lshr(x, c(24)), c(0x12)), T.eq(T.bvand(x, c(0xFF)), c(0x34))],
        [T.eq(T.mul(x, c(3)), c(0x300)), T.ult(x, c(0x1000))],
        [T.slt(x, c(0)), T.eq(T.extract(7, 0, x), T.bv_const(0x80, 8))],
        [T.eq(T.ite(T.ult(x, c(10)), T.add(x, c(5)), T.sub(x, c(5))), c(7))],
        [T.eq(T.concat(s, t), c(0xBEEFBEEF))],
        [T.eq(T.add(n, m), T.bv_const(9, 4)), T.ult(n, m)],
        [T.eq(T.mul(n, T.bv_const(2, 4)), T.bv_const(3, 4))],
        [T.eq(T.lshr(x, c(8)), c(0x123456))],
        [T.eq(T.shl(x, c(12)), c(0x345000)), T.ult(x, c(0x1000))],
        [T.eq(T.bvand(T.lshr(x, c(3)), c(0xFFFF)), c(0x2468)), T.ult(x, c(0x100000))],
        [T.eq(T.mul(x, c(0x9E3779B1)), c(0x12345678))],
    ]


def both(builder, tag):
    return builder(JT, tag), builder(PT, tag)


def pad_prog(prog, N=N_EVAL, C=C_EVAL, R=R_EVAL):
    """A compiled program's arrays padded to the shared JAX shape."""
    assert prog.n_real_nodes <= N and prog.const_pool.shape[0] <= C and prog.roots.shape[0] <= R
    out = []
    for arr, shape, fill in ((prog.opcodes, (N,), 0), (prog.args, (N, 3), 0),
                             (prog.imms, (N, 2), 0), (prog.widths, (N,), 1),
                             (prog.const_pool, (C, prog.limbs), 0), (prog.roots, (R,), 0),
                             (prog.roots_mask, (R,), False)):
        full = np.full(shape, fill, dtype=arr.dtype)
        full[tuple(slice(0, s) for s in arr.shape)] = arr[tuple(slice(0, s) for s in shape)]
        out.append(full)
    return out


def jax_score(arrays, X):
    L = X.shape[-1]
    fn = jp._get_search_fn(X.shape[1], L, 1)
    solved, score = fn.score(*(jnp.asarray(a) for a in arrays), jnp.asarray(X.astype(np.uint32)))
    return np.asarray(solved), np.asarray(score)


def port_score(arrays, X, n_nodes=None):
    ts = [torch.as_tensor(np.asarray(a).astype(np.int64)) for a in arrays]
    solved, score = pe.portfolio_eval(*ts, torch.as_tensor(X.astype(np.int64)), n_nodes=n_nodes)
    return solved.numpy(), score.numpy()


# ---------------------------------------------------------------------------
# compile_program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(4))
def test_compile_program_arrays_equal_jax(i):
    jq, pq = both(compile_queries, f"tpc{i}")
    jprog, pprog = jp.compile_program(jq[i]), pp.compile_program(pq[i])
    for name in ("opcodes", "args", "imms", "widths", "const_pool", "roots", "roots_mask"):
        got, want = getattr(pprog, name), getattr(jprog, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (pprog.var_slots, pprog.limbs, pprog.n_real_nodes, pprog.n_consts, pprog.complete) == (
        jprog.var_slots, jprog.limbs, jprog.n_real_nodes, jprog.n_consts, jprog.complete)
    assert pp.bucket_key(pprog) == jp.bucket_key(jprog)


def test_compile_losses_and_relaxed_segmentation_equal_jax():
    for T, P in ((JT, jp), (PT, pp)):
        wide = T.bv_var("tpc_wide", 4096)
        x = T.bv_var("tpc_x", W)
        arr = T.array_var("tpc_arr", W, W)
        assert P.compile_program_ex([])[1] == "QUERY_TRIVIAL"
        assert P.compile_program_ex([T.eq(wide, T.bv_const(1, 4096))])[1] == "BUCKET_OVERFLOW"
        sel = T.eq(T.select(arr, x), T.bv_const(3, W))
        assert P.compile_program_ex([sel])[1] == "LOWERING_UNSUPPORTED"
        prog, dropped, loss = P.compile_program_relaxed([sel, T.ult(x, T.bv_const(9, W))])
        assert (dropped, loss, prog.complete, len(prog.source)) == (1, None, False, 1)


# ---------------------------------------------------------------------------
# portfolio_eval's plain version against the JAX score
# ---------------------------------------------------------------------------


def random_program(rng, L, n=N_EVAL, V=V_EVAL, C=C_EVAL, R=R_EVAL):
    """Arrays of a random program over every op (args point backwards;
    comparison and bool ops are width 1), with a pool of 16-bit limbs
    whose upper limbs are often zero (so shifts and divisions see small
    and wide values)."""
    ops = np.zeros(n, np.int32)
    args = np.zeros((n, 3), np.int32)
    imms = np.zeros((n, 2), np.int32)
    widths = np.ones(n, np.int32)
    choices = [1, 8, 16, 32, 33, 64, 160, 256, 16 * L]
    for i in range(n):
        op = int(rng.integers(0, len(jp.OPS))) if i > 1 else i
        ops[i] = op
        widths[i] = 1 if op >= jp.OP_INDEX["eq"] else min(int(rng.choice(choices)), 16 * L)
        args[i] = rng.integers(0, max(i, 1), 3)
        imms[i] = [rng.integers(0, V if op == jp.OP_INDEX["var"] else C), rng.integers(0, C)]
        if op in (jp.OP_INDEX["concat"], jp.OP_INDEX["extract"]):
            imms[i, 0] = rng.integers(0, 16 * L + 3)
    pool = rng.integers(0, 1 << 16, (C, L)).astype(np.uint32)
    pool[::3, 1:] = 0
    pool[1] = 0
    roots = rng.integers(0, n, R).astype(np.int32)
    rmask = rng.random(R) < 0.7
    return [ops, args, imms, widths, pool, roots, rmask]


def random_candidates(rng, L, V=V_EVAL, K=K_EVAL):
    X = rng.integers(0, 1 << 16, (V, K, L))
    X[:, ::4, 2:] = 0   # small values
    X[:, 1::5, :] = 0   # zero words: division by zero, shift by 0
    X[:, 2::7, 1:] = 0
    return X


@pytest.mark.parametrize("L", (16, 32))
@pytest.mark.parametrize("seed", range(12))
def test_plain_eval_equals_jax_score_on_random_programs(L, seed):
    rng = np.random.default_rng(1000 * L + seed)
    for _ in range(2):
        arrays = random_program(rng, L)
        X = random_candidates(rng, L)
        js, jsc = jax_score(arrays, X)
        ps_, psc = port_score(arrays, X)
        np.testing.assert_array_equal(ps_, js)
        np.testing.assert_array_equal(psc, jsc)


def test_random_programs_use_every_op():
    seen = set()
    for L in (16, 32):
        for seed in range(12):
            rng = np.random.default_rng(1000 * L + seed)
            for _ in range(2):
                seen |= set(random_program(rng, L)[0].tolist())
                random_candidates(rng, L)
    assert seen == set(range(len(jp.OPS)))


def hazard_queries(T, tag):
    """(name, constraints, assignment, host truth) per hazard; all over
    at most four 256-bit variables."""
    x, y, z = (T.bv_var(f"{tag}_{n}", 256) for n in "xyz")
    c = lambda v: T.bv_const(v, 256)  # noqa: E731
    big = 0xFEDCBA9876543210 << 100
    return [
        # x / 0 and x % 0 are 0
        ("udiv_by_zero", [T.eq(T.udiv(x, y), c(0)), T.eq(T.urem(x, y), c(0))],
         {f"{tag}_x": big, f"{tag}_y": 0}, True),
        ("udiv_wide", [T.eq(T.udiv(x, y), z), T.eq(T.urem(x, y), T.sub(x, T.mul(y, z)))],
         {f"{tag}_x": big + 12345, f"{tag}_y": 0xFFFF1, f"{tag}_z": (big + 12345) // 0xFFFF1},
         True),
        # a shift amount with a limb above the first set saturates: 0
        ("shift_saturates", [T.eq(T.shl(x, y), c(0)), T.eq(T.lshr(x, y), c(0))],
         {f"{tag}_x": big, f"{tag}_y": (1 << 16) + 3}, True),
        ("shift_16L_bits", [T.eq(T.shl(x, y), c(0)), T.eq(T.lshr(x, y), c(0))],
         {f"{tag}_x": big, f"{tag}_y": 256}, True),
        ("ashr_sign_fill", [T.eq(T.ashr(x, y), z)],
         {f"{tag}_x": (1 << 255) | 0x1234, f"{tag}_y": 200,
          f"{tag}_z": ((((1 << 255) | 0x1234) - (1 << 256)) >> 200) % (1 << 256)}, True),
        # a width-1 node keeps its soft score in limb 1: eq of two bool
        # nodes that are both false but with different Hamming credit is
        # false on the device (the host says true)
        ("bool_eq_soft_quirk", [T.eq(T.eq(x, c(1)), T.eq(x, c(0xFF)))],
         {f"{tag}_x": 0}, True),
        # partial Hamming credit: (256 - 5) * 1024 // 256 = 1004
        ("soft_hamming", [T.eq(x, c(0b11111))], {f"{tag}_x": 0}, False),
        ("bnot_implies_soft", [T.bnot(T.eq(x, c(0b111))), T.implies(T.ult(x, y), T.eq(y, z))],
         {f"{tag}_x": 1, f"{tag}_y": 5, f"{tag}_z": 5}, True),
        ("signed_and_sext", [T.slt(x, y), T.eq(T.sext(T.extract(7, 0, z), 248), x)],
         {f"{tag}_x": (1 << 256) - 3, f"{tag}_y": 2, f"{tag}_z": 0xFD}, True),
    ]


HAZARD_NAMES = [h[0] for h in hazard_queries(PT, "tph_names")]


def assignment_X(prog, asn, K=K_EVAL, V=V_EVAL):
    X = np.zeros((V, K, prog.limbs), dtype=np.int64)
    for slot, (name, _w) in enumerate(prog.var_slots):
        for j in range(prog.limbs):
            X[slot, :, j] = (asn.get(name, 0) >> (16 * j)) & 0xFFFF
    return X


@pytest.mark.parametrize("name", HAZARD_NAMES)
def test_hazard_equals_jax_and_host(name):
    (_, jq, jasn, truth), = [h for h in hazard_queries(JT, "tph") if h[0] == name]
    (_, pq, pasn, _), = [h for h in hazard_queries(PT, "tph") if h[0] == name]
    jprog, pprog = jp.compile_program(jq), pp.compile_program(pq)
    assert all(jax_eval(c, jasn) for c in jq) == truth
    X = assignment_X(pprog, pasn)
    js, jsc = jax_score(pad_prog(jprog), X)
    ps_, psc = port_score(pad_prog(pprog), X)
    np.testing.assert_array_equal(ps_, js)
    np.testing.assert_array_equal(psc, jsc)
    if name == "bool_eq_soft_quirk":
        assert not ps_[0] and truth   # the device's quirk, copied
    elif name == "soft_hamming":
        assert not ps_[0] and psc[0] == (256 - 5) * 1024 // 256
    else:
        assert bool(ps_[0]) == truth
    assert pp.debug_eval(pprog, pasn, device="cpu") == (bool(ps_[0]), int(psc[0]))


def test_swar_popcount():
    vals = np.random.default_rng(0).integers(0, 1 << 32, 4000, dtype=np.int64)
    vals[:3] = [0, 0xFFFFFFFF, 0x80000001]
    got = pe.popcount(torch.as_tensor(vals)).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in vals]


def test_eval_on_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    # a CUDA operand launches the kernel or raises; here the launch is
    # stubbed and must be reached with the kernel's argument layout
    calls = []
    monkeypatch.setattr(pe.build, "on_cuda", lambda tensors, what: True)
    monkeypatch.setattr(pe.build, "launch", lambda fn, dev, *a: calls.append(a))
    monkeypatch.setattr(pe, "_kernel_fn", lambda: "portfolio_eval")
    monkeypatch.setattr(pe, "eval_plain", lambda *a, **k: pytest.fail("plain path taken"))
    before = pe.LAUNCHES
    arrays = [torch.as_tensor(np.asarray(a).astype(np.int64))
              for a in random_program(np.random.default_rng(0), 16)]
    X = torch.zeros((V_EVAL, 8, 16), dtype=torch.int64)
    X.get_device = lambda: 0
    pe.portfolio_eval(*arrays, X, n_nodes=10)
    assert pe.LAUNCHES == before + 1 and calls[0][:4] == (16, 10, R_EVAL, 8)


def test_sls_on_cuda_tensor_launches_any_candidate_count(monkeypatch, sls_progs):
    # more candidates than a block's threads: the launch is reached
    # (stubbed) with the C entry's 34 arguments, the stream aside, and a
    # cluster shape that covers every candidate
    calls = []
    monkeypatch.setattr(ps.build, "on_cuda", lambda tensors, what: True)
    monkeypatch.setattr(ps.build, "launch", lambda fn, dev, *a: calls.append(a))
    monkeypatch.setattr(ps, "_kernel_fn", lambda: "portfolio_sls")
    monkeypatch.setattr(ps, "sls_plain", lambda *a, **k: pytest.fail("plain path taken"))
    arrays = pp.stack_programs([p for _, p in sls_progs[:2]], "cpu")
    arrays[4].get_device = lambda: 0
    before = ps.LAUNCHES
    ps.portfolio_sls(*arrays, seed=7, steps=4, K=512, knobs=pp.PORTFOLIO_DEFAULTS)
    assert ps.LAUNCHES == before + 1 and len(calls[0]) == 34 and calls[0][:3] == (16, 2, 512)
    cluster, slots, per_thread = calls[0][25:28]
    assert cluster * slots * per_thread >= 512
    with pytest.raises(ValueError):
        ps.portfolio_sls(*arrays, seed=7, steps=4, K=0, knobs=pp.PORTFOLIO_DEFAULTS)


# ---------------------------------------------------------------------------
# enumeration, impact ranking, cubes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def enum_progs():
    jq, pq = both(enum_queries, "tpe")
    return [(jp.compile_program(a), pp.compile_program(b)) for a, b in zip(jq, pq)]


@pytest.mark.parametrize("i", range(5))
def test_device_enumerate_equals_jax(enum_progs, i):
    jprog, pprog = enum_progs[i]
    assert jp.enum_space_bits(jprog) <= 10 and len(pprog.var_slots) == 2
    want = jp.device_enumerate(jprog)
    got = pp.device_enumerate(pprog, device="cpu")
    assert got == want
    if got[0] == "sat":
        assert pp.validate_witness(pprog, got[1])
    assert got[0] == ("unsat" if i in (1, 3) else "sat")


def test_enumeration_refuses_incomplete_and_wide_programs(enum_progs):
    _, pprog = enum_progs[0]
    wide = pp.compile_program(corpus(PT, "tpe_wide")[0])
    assert pp.device_enumerate(wide, device="cpu") == ("unknown", None)
    pprog_incomplete = pp.compile_program(enum_queries(PT, "tpe")[0])
    pprog_incomplete.complete = False
    assert pp.device_enumerate(pprog_incomplete, device="cpu") == ("unknown", None)


@pytest.mark.parametrize("i", range(4))
def test_rank_impact_vars_and_cubes_equal_jax(i):
    jq, pq = both(compile_queries, f"tpr{i}")
    jprog, pprog = jp.compile_program(jq[i]), pp.compile_program(pq[i])
    assert len(pprog.var_slots) == V_EVAL
    ranked = pp.rank_impact_vars(pprog, device="cpu")
    assert [int(v) for v in ranked] == [int(v) for v in jp.rank_impact_vars(jprog)]
    assert pp._occurrence_rank(pprog) == jp._occurrence_rank(jprog)
    jc = jp.cube_queries(jprog.source, jprog, depth=3, ranked=ranked)
    pc = pp.cube_queries(pprog.source, pprog, depth=3, ranked=ranked)
    assert len(pc) == len(jc) == 8
    assert [canonical_digest(c) for c in pc] == [canonical_digest(c) for c in jc]


# ---------------------------------------------------------------------------
# the search's rules and determinism
# ---------------------------------------------------------------------------


def test_move_kinds_greedy_lanes_draw_flip_inc_dec():
    kind_full = torch.arange(12) % 6
    greedy = torch.arange(12) < 6
    kinds = ps.move_kinds(kind_full, greedy)
    assert kinds[:6].tolist() == [0, 3, 4, 0, 3, 4]
    assert kinds[6:].tolist() == [0, 1, 2, 3, 4, 5]


def test_moved_rows_limb_and_whole_variable_moves():
    rows = torch.tensor([[0xFFFF, 0x00FF, 0x1234]] * 6, dtype=torch.int64)
    kind = torch.arange(6)
    limb = torch.tensor([1, 1, 1, 1, 1, 1])
    bits = torch.full((6,), 0xABC3)
    injected = torch.tensor([[7, 8, 9]] * 6)
    vmask = torch.tensor([0xFFFF, 0xFFFF, 0x0FFF])
    out = ps.moved_rows(rows, kind, limb, bits, injected, vmask).tolist()
    assert out[0] == [0xFFFF, 0x00FF ^ (1 << 3), 0x0234]       # flip bit bits & 15
    assert out[1] == [0xFFFF, 0xABC3, 0x0234]                  # random limb
    assert out[2] == [0xFFFF, 0x0000, 0x0234]                  # kind 2 zeroes a limb
    assert out[3] == [0x0000, 0x0100, 0x0234]                  # + 1, carried
    assert out[4] == [0xFFFE, 0x00FF, 0x0234]                  # - 1
    assert out[5] == [7, 8, 9]                                 # pool constant


def test_seeded_pool_cycles_real_rows_per_variable():
    pool = torch.arange(5)[:, None].expand(5, 2) * 10
    band = ps.seeded_pool(pool, n_seeded=4, n_consts=3, V=2)
    assert band[..., 0].tolist() == [[0, 10, 20, 0], [10, 20, 0, 10]]


def test_luby_advance_makes_the_luby_sequence():
    u, v = torch.ones(1, dtype=torch.int64), torch.ones(1, dtype=torch.int64)
    seq = []
    for _ in range(15):
        seq.append(int(v))
        u, v = ps.luby_advance(u, v, torch.ones(1, dtype=torch.bool))
    assert seq == [1, 1, 2, 1, 1, 2, 4, 1, 1, 2, 1, 1, 2, 4, 8]
    u2, v2 = ps.luby_advance(u, v, torch.zeros(1, dtype=torch.bool))
    assert (int(u2), int(v2)) == (int(u), int(v))


def test_restarted_lane_scores_minus_two_to_the_thirty():
    X = torch.full((2, 3, 16), 0x5555, dtype=torch.int64)
    cur = torch.tensor([10, 20, 30])
    stall = torch.tensor([5, 6, 7])
    restart = torch.tensor([False, True, False])
    vmask = torch.tensor([pe.width_mask(8, 16), pe.width_mask(256, 16)])
    X2, cur2, stall2 = ps.restart_lanes(X, cur, stall, restart, torch.tensor([1, 2, 3]), vmask)
    assert cur2.tolist() == [10, -(1 << 30), 30] and stall2.tolist() == [5, 0, 7]
    assert torch.equal(X2[:, 0], X[:, 0]) and torch.equal(X2[:, 2], X[:, 2])
    assert int(X2[0, 1, 1]) == 0 and int(X2[0, 1, 0]) <= 0xFF       # masked to 8 bits
    mix0 = ((2 * 0x9E3779B9) ^ 0x85EBCA6B) & 0xFFFF
    assert int(X2[1, 1, 0]) == 0x5555 ^ mix0


def test_winner_is_solved_first_then_first_of_the_best():
    assert ps.winner(torch.tensor([5, 9, 9, 1]), torch.tensor([False] * 4)) == 1
    assert ps.winner(torch.tensor([5, 9, 9, 1]), torch.tensor([False, False, False, True])) == 3
    assert ps.winner(torch.tensor([7, 7]), torch.tensor([True, True])) == 0


def test_thresholds_sweep_noise_across_lanes():
    thr = ps.thresholds(64, 0.02, 0.40)
    assert int(thr[0]) == int(0.02 * 2**32) and int(thr[-1]) == int(0.40 * 2**32)
    assert bool((thr[1:] >= thr[:-1]).all())
    assert int(ps.thresholds(2, 0.0, 1.0)[-1]) == 0xFFFFFFFF


def test_hash_stays_in_32_bits():
    h = ps.stream_of(0xFFFFFFFF, 0xFFFFFFFF, torch.arange(64, dtype=torch.int64))
    d = ps.draw(h, 7)
    assert int(d.min()) >= 0 and int(d.max()) <= 0xFFFFFFFF and len(set(d.tolist())) == 64
    # x * c mod 2**32 without int64 overflow
    x = torch.tensor([0xFFFFFFFF, 0x12345678], dtype=torch.int64)
    assert ps._mul32(x, 0x846CA68B).tolist() == [(int(v) * 0x846CA68B) % 2**32 for v in x]


@pytest.fixture(scope="module")
def sls_progs():
    _, pq = both(corpus, "tps")
    progs = []
    for q in pq[:6]:
        low, _ = pp_lower([c for c in q])
        progs.append((len(progs), pp.compile_program(low)))
    return progs


def pp_lower(constraints):
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower

    return lower(constraints)


def test_plain_sls_is_deterministic_for_a_seed(sls_progs):
    a = pp._sls_batch(sls_progs, candidates=32, steps=40, seed=3, device="cpu")
    b = pp._sls_batch(sls_progs, candidates=32, steps=40, seed=3, device="cpu")
    assert a == b and a
    for i, asn in a.items():
        assert pp.validate_witness(sls_progs[i][1], asn)


def test_multi_device_paths_raise(sls_progs):
    with pytest.raises(NotImplementedError):
        pp._sls_batch(sls_progs, n_devices=2, device="cpu")
    with pytest.raises(NotImplementedError):
        pp.device_solve_batch([[PT.TRUE]], devices=["cuda:0", "cuda:1"], device="cpu")
    with pytest.raises(NotImplementedError):
        pp.device_enumerate(sls_progs[0][1], n_devices=4, device="cpu")


def test_portfolio_overrides_keep_their_api():
    assert pp._FACTORY_DEFAULTS == jp._FACTORY_DEFAULTS
    with pp.portfolio_overrides(noise_hi=0.5, cube_depth=1):
        assert pp.PORTFOLIO_DEFAULTS["noise_hi"] == 0.5
    assert pp.PORTFOLIO_DEFAULTS == pp._FACTORY_DEFAULTS
    with pytest.raises(ValueError):
        with pp.portfolio_overrides(bogus=1):
            pass
    pp.install_tuned_defaults({"restart_base": 12}, version=3)
    assert pp.tuned_version() == 3 and pp.PORTFOLIO_DEFAULTS["restart_base"] == 12
    pp.reset_tuned_defaults()
    assert pp.tuned_version() == 0 and pp.PORTFOLIO_DEFAULTS == pp._FACTORY_DEFAULTS


# ---------------------------------------------------------------------------
# the narrow corpus, held to the pinned JAX verdicts
# ---------------------------------------------------------------------------


def _lowered(builder, T, lower_fn, tag):
    return [lower_fn(q)[0] for q in builder(T, tag)]


def _port_corpus(pq):
    """The port's verdicts over the corpus, one dispatch per seed of
    CORPUS_SEEDS: ([per seed, per query verdict], [per seed stats])."""
    verdicts, stats = [], []
    for seed in CORPUS_SEEDS:
        stats.append({})
        verdicts.append(pp.device_solve_batch(pq, cube_depth=0, seed=seed, device="cpu",
                                              stats=stats[-1]))
    return verdicts, stats


def _codes(per_seed):
    """One code string per query (a code per seed) of per-seed verdicts."""
    return ["".join(VERDICT_CODES[(row[i].status, row[i].via)] for row in per_seed)
            for i in range(len(per_seed[0]))]


@pytest.fixture(scope="module")
def corpus_run():
    from mythril_tpu.laser.smt.solver.preprocess import lower as jax_lower

    jq = _lowered(corpus, JT, jax_lower, "tpk")
    pq = _lowered(corpus, PT, pp_lower, "tpk")
    verdicts, stats = _port_corpus(pq)
    return jq, verdicts, stats


def test_corpus_solves_at_least_the_pinned_jax_verdicts(corpus_run):
    jq, verdicts, stats = corpus_run
    pinned = json.loads(CORPUS_PIN.read_text())
    assert pinned["seeds"] == list(CORPUS_SEEDS) and len(pinned["jax"]) == len(jq)
    got = _codes(verdicts)
    port_sat = sum(c in "SE" for row in got for c in row)
    jax_sat = sum(c in "SE" for row in pinned["jax"] for c in row)
    assert port_sat >= jax_sat - CORPUS_ALLOWANCE, (got, pinned["jax"])
    assert all(st["witness_invalid"] == 0 for st in stats)
    for mine, want in zip(got, pinned["jax"]):
        if set(want) <= set("EN"):   # enumeration is deterministic: equal verdicts
            assert mine == want


def test_corpus_sats_pass_jax_eval_and_unsats_come_from_enumeration(corpus_run):
    jq, verdicts, _ = corpus_run
    flat = [v for row in verdicts for v in row]
    assert any(v.status == "sat" for v in flat) and any(v.status == "unsat" for v in flat)
    for row in verdicts:
        for q, v in zip(jq, row):
            if v.status == "sat":
                assert all(jax_eval(c, v.assignment) for c in q), v
            elif v.status == "unsat":
                assert v.via == "enum"


def test_cube_fan_splits_survivors_and_validates():
    # a query the first pass cannot solve in 2 steps goes to the cube
    # fan: 8 cubes in one more dispatch, any witness validated
    def query(T):
        x = T.bv_var("tpf_x", W)
        return [T.eq(T.bvand(x, T.bv_const(0xFFF0, W)), T.bv_const(0x1230, W)),
                T.ult(x, T.bv_const(0x1238, W))]

    stats = {}
    (v,) = pp.device_solve_batch([query(PT)], steps=2, cube_depth=3, device="cpu",
                                 stats=stats)
    assert stats["witness_invalid"] == 0
    assert v.status in ("sat", "unknown") and v.via in ("sls", "cube", None)
    if v.status == "sat":
        assert all(jax_eval(c, v.assignment) for c in query(JT))


def _pin():
    from mythril_tpu.laser.smt.solver.preprocess import lower as jax_lower

    # one query a dispatch, the first pass alone, query q at seed s keyed
    # s + q as in the port's dispatch: the JAX package's vmapped
    # multi-query search evaluates every branch of its per-node switch
    # and takes minutes per query on a CPU
    jq = _lowered(corpus, JT, jax_lower, "tpk")
    pq = _lowered(corpus, PT, pp_lower, "tpk")
    jax_rows = [[jp.device_solve_batch([q], cube_depth=0, seed=seed + i)[0]
                 for i, q in enumerate(jq)] for seed in CORPUS_SEEDS]
    port_rows, _ = _port_corpus(pq)
    jax, port = _codes(jax_rows), _codes(port_rows)
    CORPUS_PIN.write_text(json.dumps({
        "dispatch": "first pass only (cube_depth 0); JAX one query a dispatch at seed s + q, "
                    "the port the whole corpus a dispatch at seed s",
        "codes": "S sat by SLS, E sat by enumeration, N unsat by enumeration, U unknown",
        "settings": {k: jp.PORTFOLIO_DEFAULTS[k] for k in sorted(jp.PORTFOLIO_DEFAULTS)},
        "seeds": list(CORPUS_SEEDS),
        "jax": jax,
        "port_at_pin": port,
        "sat_per_seed": {"jax": [sum(r[j] in "SE" for r in jax) for j in range(len(CORPUS_SEEDS))],
                         "port_at_pin": [sum(r[j] in "SE" for r in port)
                                         for j in range(len(CORPUS_SEEDS))]},
    }, indent=1) + "\n")
    print(f"wrote {len(jq)} queries x {len(CORPUS_SEEDS)} seeds of verdicts to {CORPUS_PIN}")


if __name__ == "__main__" and "--pin" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _pin()
