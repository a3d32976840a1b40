"""The port's SMT term layer against the JAX package's.

One builder function makes seeded random term DAGs out of a `terms`
module; it runs once over the JAX package's `laser/smt/terms` and once
over the port's copy, with the same numpy-seeded choices and fresh
variable names. The simplified results must have one structure: their
canonical digests (`flip_frontier.canonical_digest`, which sorts the
children of commutative ops, whose order the two interners' creation
ids decide) are equal. `eval_term` of both must agree under seeded
random assignments. A third check builds through the typed wrappers
(`symbol_factory`, `If`, `Concat`, `Extract`, `UDiv`, ...) the way the
arena decode does.
"""

import random

import numpy as np
import pytest

from mythril_tpu.laser import smt as jax_smt
from mythril_tpu.laser.smt import terms as jax_terms
from mythril_tpu.laser.smt.evalterm import eval_term as jax_eval
from mythril_tpu_torch.laser import smt as port_smt
from mythril_tpu_torch.laser.flip_frontier import canonical_digest
from mythril_tpu_torch.laser.smt import terms as port_terms
from mythril_tpu_torch.laser.smt.evalterm import eval_term as port_eval

BV_BINOPS = ["add", "sub", "mul", "udiv", "sdiv", "urem", "srem", "bvand", "bvor",
             "bvxor", "shl", "lshr", "ashr"]
CMPS = ["eq", "ult", "ule", "slt", "sle"]
SEEDS = range(40)
WIDTHS = (8, 32, 256)


def build_dag(T, seed: int, width: int, tag: str, n_nodes: int = 28):
    """A random DAG of `n_nodes` bit-vector and bool nodes over four
    variables of `width` bits, built with the smart constructors of
    module `T`: the same seed makes the same choices over either
    package. Returns (bool roots, variable names)."""
    rng = np.random.default_rng(seed)
    names = [f"{tag}_s{seed}_w{width}_v{i}" for i in range(4)]
    bvs = [T.bv_var(n, width) for n in names]
    consts = [0, 1, 2, (1 << width) - 1, 1 << (width - 1), 0x5A5A5A5A & ((1 << width) - 1)]
    bvs += [T.bv_const(c, width) for c in consts]
    bools = [T.bool_var(f"{tag}_s{seed}_b"), T.TRUE, T.FALSE]

    def pick(pool):
        return pool[int(rng.integers(len(pool)))]

    for _ in range(n_nodes):
        kind = int(rng.integers(10))
        if kind < 5:
            op = BV_BINOPS[int(rng.integers(len(BV_BINOPS)))]
            bvs.append(getattr(T, op)(pick(bvs), pick(bvs)))
        elif kind == 5:
            bvs.append(T.bvnot(pick(bvs)))
        elif kind == 6:
            # split and rejoin: extract/concat simplifications
            a = pick(bvs)
            cut = int(rng.integers(1, width))
            lo, hi = T.extract(cut - 1, 0, a), T.extract(width - 1, cut, a)
            ext = T.zext(lo, width - cut) if rng.integers(2) else T.sext(lo, width - cut)
            bvs.append(T.concat(hi, lo) if rng.integers(2) else ext)
        elif kind == 7:
            bvs.append(T.ite(pick(bools), pick(bvs), pick(bvs)))
        elif kind == 8:
            op = CMPS[int(rng.integers(len(CMPS)))]
            bools.append(getattr(T, op)(pick(bvs), pick(bvs)))
        else:
            k = int(rng.integers(5))
            a, b = pick(bools), pick(bools)
            bools.append([T.band(a, b), T.bor(a, b, pick(bools)), T.bnot(a), T.bxor(a, b),
                          T.implies(a, b)][k])
    roots = bools[-6:] + [T.eq(bvs[-1], bvs[-2]), T.ult(bvs[-3], bvs[-1])]
    return roots, names + [f"{tag}_s{seed}_b"]


def assignments(names, width, seed, n=8):
    rng = random.Random(seed)
    edges = [0, 1, (1 << width) - 1, 1 << (width - 1)]
    out = []
    for i in range(n):
        asn = {name: (edges[i] if i < len(edges) else rng.getrandbits(width))
               for name in names[:-1]}
        asn[names[-1]] = rng.getrandbits(1)
        out.append(asn)
    return out


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_dag_simplifies_and_evaluates_alike(seed, width):
    jax_roots, names = build_dag(jax_terms, seed, width, "tt")
    port_roots, port_names = build_dag(port_terms, seed, width, "tt")
    assert names == port_names
    assert [canonical_digest([r]) for r in jax_roots] == [canonical_digest([r])
                                                          for r in port_roots]
    assert [r.op for r in jax_roots] == [r.op for r in port_roots]
    for asn in assignments(names, width, seed):
        assert ([port_eval(r, asn) for r in port_roots]
                == [jax_eval(r, asn) for r in jax_roots]), asn


def test_canonical_digest_ignores_creation_order():
    # the same commutative terms, built in the opposite order in the
    # port: creation ids differ, structure and digest do not
    a, b = port_terms.bv_var("tt_order_a", 64), port_terms.bv_var("tt_order_b", 64)
    first = port_terms.add(a, b)
    c, d = port_terms.bv_var("tt_order_d", 64), port_terms.bv_var("tt_order_c", 64)
    ja, jb = jax_terms.bv_var("tt_order_a", 64), jax_terms.bv_var("tt_order_b", 64)
    jd, jc = jax_terms.bv_var("tt_order_c", 64), jax_terms.bv_var("tt_order_d", 64)
    assert canonical_digest([first]) == canonical_digest([jax_terms.add(jb, ja)])
    assert (canonical_digest([port_terms.band(port_terms.ult(c, d), port_terms.ult(d, c))])
            == canonical_digest([jax_terms.band(jax_terms.ult(jc, jd), jax_terms.ult(jd, jc))]))
    assert canonical_digest([first]) != canonical_digest([port_terms.sub(a, b)])


def _decode_like(smt, tag):
    """What the arena decode builds: a calldata word from 8-bit vars, a
    selector test through DIV, a signed compare, SIGNEXTEND and EXP
    shapes."""
    sf = smt.symbol_factory
    zero, one = sf.BitVecVal(0, 256), sf.BitVecVal(1, 256)
    word = smt.Concat([sf.BitVecSym(f"{tag}cd{i}", 8) for i in range(32)])
    sel = smt.If(sf.BitVecVal(1 << 224, 256) == zero, zero,
                 smt.UDiv(word, sf.BitVecVal(1 << 224, 256)))
    bit = 1 << 15
    sext = smt.If((word & bit) == zero, word & (bit - 1), word | (2**256 - bit))
    out = [
        smt.If(sel == sf.BitVecVal(0xA9059CBB, 256), one, zero) != zero,
        smt.If(word < sf.BitVecVal(3, 256), one, zero) == zero,
        smt.ULT(smt.URem(word, sf.BitVecVal(7, 256)), one),
        smt.UGT(smt.LShR(word, sf.BitVecVal(8, 256)), sext),
        smt.Extract(7, 0, smt.SRem(word, sf.BitVecVal(5, 256))) == sf.BitVecVal(1, 8),
        (word << sf.BitVecVal(3, 256)) != (word >> sf.BitVecVal(2, 256)),
    ]
    return out


def test_wrappers_build_the_same_terms():
    jax_out = _decode_like(jax_smt, "tw")
    port_out = _decode_like(port_smt, "tw")
    assert [canonical_digest([c]) for c in jax_out] == [canonical_digest([c]) for c in port_out]
    rng = random.Random(3)
    for _ in range(6):
        asn = {f"twcd{i}": rng.getrandbits(8) for i in range(32)}
        assert ([port_eval(c.raw, asn) for c in port_out]
                == [jax_eval(c.raw, asn) for c in jax_out])
