"""EVM-width helper functions over BitVec/Bool.

Reference parity: mythril/laser/smt/bitvec_helper.py:21-199 — the ~20
helpers the instruction semantics and detection modules use.
"""

from __future__ import annotations

from typing import List, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.bitvec import BitVec, _anns, _coerce
from mythril_tpu_torch.laser.smt.bool import Bool


def _both(a: BitVec, b) -> tuple:
    return a.raw, _coerce(b, a.size())


def If(cond: Union[Bool, bool], a: Union[BitVec, int], b: Union[BitVec, int]):
    if isinstance(cond, bool):
        cond = Bool(terms.bool_const(cond))
    anns = cond.annotations.copy()
    if isinstance(a, BitVec):
        width = a.size()
    elif isinstance(b, BitVec):
        width = b.size()
    else:
        width = 256
    ra = a.raw if isinstance(a, BitVec) else terms.bv_const(a, width)
    rb = b.raw if isinstance(b, BitVec) else terms.bv_const(b, width)
    for x in (a, b):
        if isinstance(x, BitVec):
            anns |= x.annotations
    return BitVec(terms.ite(cond.raw, ra, rb), anns)


def UGT(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.ult(rb, ra), _anns(a, b))


def UGE(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.ule(rb, ra), _anns(a, b))


def ULT(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.ult(ra, rb), _anns(a, b))


def ULE(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.ule(ra, rb), _anns(a, b))


def SLT(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.slt(ra, rb), _anns(a, b))


def SGT(a: BitVec, b) -> Bool:
    ra, rb = _both(a, b)
    return Bool(terms.slt(rb, ra), _anns(a, b))


def Concat(*args) -> BitVec:
    if len(args) == 1 and isinstance(args[0], list):
        args = tuple(args[0])
    raw = args[0].raw
    anns = args[0].annotations.copy()
    for a in args[1:]:
        raw = terms.concat(raw, a.raw)
        anns |= a.annotations
    return BitVec(raw, anns)


def Extract(high: int, low: int, bv: BitVec) -> BitVec:
    return BitVec(terms.extract(high, low, bv.raw), bv.annotations)


def ZeroExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(terms.zext(bv.raw, extra), bv.annotations)


def SignExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(terms.sext(bv.raw, extra), bv.annotations)


def UDiv(a: BitVec, b) -> BitVec:
    ra, rb = _both(a, b)
    return BitVec(terms.udiv(ra, rb), _anns(a, b))


def URem(a: BitVec, b) -> BitVec:
    ra, rb = _both(a, b)
    return BitVec(terms.urem(ra, rb), _anns(a, b))


def SRem(a: BitVec, b) -> BitVec:
    ra, rb = _both(a, b)
    return BitVec(terms.srem(ra, rb), _anns(a, b))


def LShR(a: BitVec, b) -> BitVec:
    ra, rb = _both(a, b)
    return BitVec(terms.lshr(ra, rb), _anns(a, b))


def Sum(*args: BitVec) -> BitVec:
    raw = args[0].raw
    anns = args[0].annotations.copy()
    for a in args[1:]:
        raw = terms.add(raw, a.raw)
        anns |= a.annotations
    return BitVec(raw, anns)


def BVAddNoOverflow(a: BitVec, b, signed: bool = False) -> Bool:
    """No overflow in a + b (reference: bitvec_helper wraps z3's)."""
    ra, rb = _both(a, b)
    w = a.size()
    if signed:
        # pos + pos must stay pos
        s = terms.add(ra, rb)
        both_pos = terms.band(
            terms.sle(terms.bv_const(0, w), ra), terms.sle(terms.bv_const(0, w), rb)
        )
        return Bool(
            terms.bnot(terms.band(both_pos, terms.slt(s, terms.bv_const(0, w)))),
            _anns(a, b),
        )
    # unsigned: a + b >= a  (wraps iff sum < a)
    return Bool(terms.ule(ra, terms.add(ra, rb)), _anns(a, b))


def BVSubNoUnderflow(a: BitVec, b, signed: bool = False) -> Bool:
    ra, rb = _both(a, b)
    w = a.size()
    if signed:
        # signed underflow: neg - pos wrapping to a non-negative result
        s = terms.sub(ra, rb)
        neg_minus_pos = terms.band(
            terms.slt(ra, terms.bv_const(0, w)),
            terms.slt(terms.bv_const(0, w), rb),
        )
        return Bool(
            terms.bnot(
                terms.band(neg_minus_pos, terms.sle(terms.bv_const(0, w), s))
            ),
            _anns(a, b),
        )
    return Bool(terms.ule(rb, ra), _anns(a, b))


def BVMulNoOverflow(a: BitVec, b, signed: bool = False) -> Bool:
    """No overflow in a * b: the double-width product fits in w bits."""
    ra, rb = _both(a, b)
    w = a.size()
    if signed:
        wa, wb = terms.sext(ra, w), terms.sext(rb, w)
        prod = terms.mul(wa, wb)
        lo = terms.sext(terms.extract(w - 1, 0, prod), w)
        return Bool(terms.eq(prod, lo), _anns(a, b))
    wa, wb = terms.zext(ra, w), terms.zext(rb, w)
    prod = terms.mul(wa, wb)
    hi = terms.extract(2 * w - 1, w, prod)
    return Bool(terms.eq(hi, terms.bv_const(0, w)), _anns(a, b))
