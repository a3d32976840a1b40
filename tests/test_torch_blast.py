"""The port's bit-blaster against the JAX package's, clause for clause.

`mythril_tpu_torch.laser.smt.solver.bitblast` has two encoders: the
plain `PyBlaster` and `NativeBlaster`, whose circuits are the port's own
copy of blast.cpp, built by g++ into `mythril_tpu_torch/_build/` at
first use. The same queries, built in the same order in both packages'
term layers, go through the port's `NativeBlaster`, the port's
`PyBlaster` and the JAX package's `NativeBlaster` (its prebuilt
library): the root literals, the variable count, the whole flat clause
stream, the variable bit maps and the bool vars must be equal, list for
list. The shapes are those of tests/laser/smt/test_native_blast.py:
every bv and bool operator, a multi-constraint session, random DAGs by
seed, and width-256 EVM shapes.

Every query's variables get a name no earlier query of the process used,
so each package creates its terms fresh and in the same order: the term
layer orders the children of a commutative op by creation id.
"""

import itertools
import random

import pytest
import torch

from mythril_tpu.laser.smt import terms as jax_terms
from mythril_tpu.laser.smt.solver import bitblast as jax_bitblast
from mythril_tpu_torch.laser.smt import terms as port_terms
from mythril_tpu_torch.laser.smt.solver import bitblast as port_bitblast
from mythril_tpu_torch.native import build

torch.set_num_threads(1)

W = 8
_FRESH = itertools.count()


def stream(blaster):
    if isinstance(blaster, (port_bitblast.NativeBlaster, jax_bitblast.NativeBlaster)):
        ptr, cnt = blaster.flat.window(0)
        assert cnt == len(blaster.flat)
        return [ptr[i] for i in range(cnt)]
    return list(blaster.flat)


def blast_all(make, build_inputs):
    """Blast build_inputs(T)'s [(kind, term)] through each encoder `make`
    gives, on the term layer T of the encoder's package: {name: (roots,
    nvars, flat stream, var_bits, bool_vars)}."""
    out = {}
    for name, (T, blaster) in make().items():
        roots = [blaster.blast_bool(t) if kind == "bool" else blaster.blast_bv(t)
                 for kind, t in build_inputs(T)]
        out[name] = (roots, blaster.nvars, stream(blaster), blaster.var_bits,
                     blaster.bool_vars)
    return out


def encoders():
    return {"port-native": (port_terms, port_bitblast.NativeBlaster()),
            "port-python": (port_terms, port_bitblast.PyBlaster()),
            "jax-native": (jax_terms, jax_bitblast.NativeBlaster())}


def assert_identical(build_inputs):
    got = blast_all(encoders, build_inputs)
    ref = got.pop("jax-native")
    assert ref[2], "empty clause stream"
    for name, result in got.items():
        for part, a, b in zip(("roots", "nvars", "flat", "var_bits", "bool_vars"), result, ref):
            assert a == b, (name, part)


def fresh_vars(w=W):
    tag = next(_FRESH)
    return lambda T: tuple(T.bv_var(f"tb{tag}_{v}", w) for v in "xyz")


BV_BUILDERS = [
    lambda T, x, y, z: T.add(x, y),
    lambda T, x, y, z: T.sub(x, y),
    lambda T, x, y, z: T.mul(x, y),
    lambda T, x, y, z: T.udiv(x, y),
    lambda T, x, y, z: T.urem(x, y),
    lambda T, x, y, z: T.bvand(x, y),
    lambda T, x, y, z: T.bvor(x, y),
    lambda T, x, y, z: T.bvxor(x, y),
    lambda T, x, y, z: T.shl(x, y),
    lambda T, x, y, z: T.lshr(x, y),
    lambda T, x, y, z: T.ashr(x, y),
    lambda T, x, y, z: T.bvnot(x),
    lambda T, x, y, z: T.ite(T.ult(x, y), T.add(x, z), T.sub(y, z)),
    lambda T, x, y, z: T.concat(T.extract(W - 1, W // 2, x), T.extract(W // 2 - 1, 0, y)),
    lambda T, x, y, z: T.add(T.zext(T.extract(3, 0, x), W - 4), y),
    lambda T, x, y, z: T.add(T.sext(T.extract(3, 0, x), W - 4), y),
    lambda T, x, y, z: T.mul(T.add(x, y), T.add(x, y)),  # shared subterm
    lambda T, x, y, z: T.udiv(T.add(x, T.bv_const(0, W)), y),
    lambda T, x, y, z: T.add(x, T.bv_const(0x2B, W)),
    lambda T, x, y, z: T.mul(x, T.bv_const(10, W)),
    lambda T, x, y, z: T.shl(x, T.bv_const(3, W)),
]

BOOL_BUILDERS = [
    lambda T, x, y, z: T.eq(x, y),
    lambda T, x, y, z: T.ult(x, y),
    lambda T, x, y, z: T.ule(x, y),
    lambda T, x, y, z: T.slt(x, y),
    lambda T, x, y, z: T.sle(x, y),
    lambda T, x, y, z: T.band(T.ult(x, y), T.eq(y, z)),
    lambda T, x, y, z: T.bor(T.eq(x, z), T.bnot(T.ult(z, y))),
    lambda T, x, y, z: T.bxor(T.ult(x, y), T.ult(y, x)),
    lambda T, x, y, z: T.ite(T.eq(x, y), T.ult(x, z), T.ule(z, y)),
    lambda T, x, y, z: T.eq(T.mul(x, y), T.add(z, z)),
    lambda T, x, y, z: T.band(
        T.eq(T.urem(x, T.bv_const(7, W)), T.bv_const(3, W)),
        T.ult(T.udiv(x, T.bv_const(7, W)), y),
    ),
]


def test_the_library_is_built_from_the_ports_sources():
    assert build.host_is_built() or build.build_host() >= 0.0
    assert build.host_is_built()
    assert build.lib_path(build.HOST_STEM).parent == build.BUILD
    lib = build.load_host()
    assert "mythril_tpu_torch/_build" in lib._name and "libmythril_native" not in lib._name
    from mythril_tpu_torch.laser.smt.solver import solver

    solver.reset_blast_session()
    assert isinstance(solver._blast_session()[0], port_bitblast.NativeBlaster)
    solver.reset_blast_session()


@pytest.mark.parametrize("i", range(len(BV_BUILDERS)))
def test_bv_ops_stream_identical(i):
    xyz = fresh_vars()
    assert_identical(lambda T: [("bv", BV_BUILDERS[i](T, *xyz(T)))])


@pytest.mark.parametrize("i", range(len(BOOL_BUILDERS)))
def test_bool_ops_stream_identical(i):
    xyz = fresh_vars()
    assert_identical(lambda T: [("bool", BOOL_BUILDERS[i](T, *xyz(T)))])


def test_multi_constraint_session_stream_identical():
    """Several constraints into one persistent store (the solver
    session's pattern); the last repeats the first, so it must come from
    the caches with no new clause on any side."""
    xyz = fresh_vars()

    def inputs(T):
        x, y, z = xyz(T)
        first = T.ult(T.add(x, y), T.bv_const(100, W))
        return [("bool", first), ("bool", T.eq(T.mul(x, y), z)),
                ("bool", T.bnot(T.eq(x, T.bv_const(0, W)))),
                ("bool", T.ule(T.udiv(z, x), y)),
                ("bool", T.ult(T.add(x, y), T.bv_const(100, W)))]

    assert_identical(inputs)


def _random_term(T, rng, depth, w, pool):
    if depth == 0 or rng.random() < 0.25:
        if rng.random() < 0.5:
            return pool[rng.randrange(len(pool))]
        return T.bv_const(rng.getrandbits(w), w)
    op = rng.choice(["add", "sub", "mul", "and", "or", "xor", "shl", "lshr", "ashr",
                     "udiv", "urem", "not", "ite"])
    a = _random_term(T, rng, depth - 1, w, pool)
    b = _random_term(T, rng, depth - 1, w, pool)
    if op == "not":
        return T.bvnot(a)
    if op == "ite":
        return T.ite(T.ult(a, b), a, b)
    return {"add": T.add, "sub": T.sub, "mul": T.mul, "and": T.bvand, "or": T.bvor,
            "xor": T.bvxor, "shl": T.shl, "lshr": T.lshr, "ashr": T.ashr,
            "udiv": T.udiv, "urem": T.urem}[op](a, b)


@pytest.mark.parametrize("seed", range(8))
def test_random_dags_stream_identical(seed):
    tag = next(_FRESH)

    def inputs(T):
        rng = random.Random(1000 + seed)
        w = rng.choice([4, 8, 16])
        pool = [T.bv_var(f"tb{tag}_r{i}", w) for i in range(3)]
        out = []
        for _ in range(4):
            lhs = _random_term(T, rng, 3, w, pool)
            rhs = _random_term(T, rng, 3, w, pool)
            out.append(("bool", rng.choice([T.eq, T.ult, T.ule])(lhs, rhs)))
        return out

    assert_identical(inputs)


def test_width_256_evm_shapes_stream_identical():
    tag = next(_FRESH)

    def inputs(T):
        x, y = T.bv_var(f"tb{tag}_bx", 256), T.bv_var(f"tb{tag}_by", 256)
        c = T.bv_const((1 << 255) + 12345, 256)
        return [("bool", T.ult(T.add(x, y), x)),  # the overflow shape
                ("bool", T.eq(T.mul(x, T.bv_const(2, 256)), c)),
                ("bool", T.ule(T.lshr(x, T.bv_const(4, 256)), y)),
                ("bool", T.eq(T.extract(255, 224, x), T.bv_const(0xA9059CBB, 32)))]

    assert_identical(inputs)
