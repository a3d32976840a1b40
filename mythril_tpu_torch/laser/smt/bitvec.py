"""BitVec: fixed-width bit-vector expression with operator overloads.

Reference parity: mythril/laser/smt/bitvec.py:25 — `.value` /
`.symbolic` concreteness fast path, python operator overloads, and
annotation union on every binary op (the taint-propagation mechanism
detection modules rely on, e.g. dependence_on_predictable_vars).
"""

from __future__ import annotations

from typing import Optional, Set, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.bool import Bool
from mythril_tpu_torch.laser.smt.expression import Expression, OrderedSet


def _coerce(other, width: int) -> terms.Term:
    if isinstance(other, BitVec):
        return other.raw
    if isinstance(other, int):
        return terms.bv_const(other, width)
    raise TypeError(f"cannot coerce {type(other)} to BitVec")


def _anns(a, b) -> "OrderedSet":
    out = a.annotations.copy()
    if isinstance(b, Expression):
        out |= b.annotations
    return out


class BitVec(Expression):
    """A bit vector symbolic expression."""

    @property
    def symbolic(self) -> bool:
        return self.raw.value is None

    @property
    def value(self) -> Optional[int]:
        return self.raw.value

    def size(self) -> int:
        return self.raw.width

    # -- arithmetic -------------------------------------------------------
    def __add__(self, other) -> "BitVec":
        return BitVec(terms.add(self.raw, _coerce(other, self.size())), _anns(self, other))

    __radd__ = __add__

    def __sub__(self, other) -> "BitVec":
        return BitVec(terms.sub(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __rsub__(self, other) -> "BitVec":
        return BitVec(terms.sub(_coerce(other, self.size()), self.raw), _anns(self, other))

    def __mul__(self, other) -> "BitVec":
        return BitVec(terms.mul(self.raw, _coerce(other, self.size())), _anns(self, other))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "BitVec":
        # z3 BitVec / is signed division (reference instructions use UDiv
        # helper for unsigned); keep that convention
        return BitVec(terms.sdiv(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __mod__(self, other) -> "BitVec":
        return BitVec(terms.srem(self.raw, _coerce(other, self.size())), _anns(self, other))

    # -- bitwise ----------------------------------------------------------
    def __and__(self, other) -> "BitVec":
        return BitVec(terms.bvand(self.raw, _coerce(other, self.size())), _anns(self, other))

    __rand__ = __and__

    def __or__(self, other) -> "BitVec":
        return BitVec(terms.bvor(self.raw, _coerce(other, self.size())), _anns(self, other))

    __ror__ = __or__

    def __xor__(self, other) -> "BitVec":
        return BitVec(terms.bvxor(self.raw, _coerce(other, self.size())), _anns(self, other))

    __rxor__ = __xor__

    def __invert__(self) -> "BitVec":
        return BitVec(terms.bvnot(self.raw), self.annotations)

    def __lshift__(self, other) -> "BitVec":
        return BitVec(terms.shl(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __rshift__(self, other) -> "BitVec":
        # z3 >> is arithmetic shift; LShR is the helper (as in reference)
        return BitVec(terms.ashr(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __neg__(self) -> "BitVec":
        return BitVec(
            terms.sub(terms.bv_const(0, self.size()), self.raw), self.annotations
        )

    # -- comparisons (signed, matching z3 defaults) -----------------------
    def __lt__(self, other) -> Bool:
        return Bool(terms.slt(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __gt__(self, other) -> Bool:
        return Bool(terms.slt(_coerce(other, self.size()), self.raw), _anns(self, other))

    def __le__(self, other) -> Bool:
        return Bool(terms.sle(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __ge__(self, other) -> Bool:
        return Bool(terms.sle(_coerce(other, self.size()), self.raw), _anns(self, other))

    def __eq__(self, other) -> Bool:  # type: ignore[override]
        return Bool(terms.eq(self.raw, _coerce(other, self.size())), _anns(self, other))

    def __ne__(self, other) -> Bool:  # type: ignore[override]
        return Bool(
            terms.bnot(terms.eq(self.raw, _coerce(other, self.size()))),
            _anns(self, other),
        )

    def __hash__(self):
        return self.raw._hash
