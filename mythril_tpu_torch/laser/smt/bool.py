"""Bool expressions and connectives.

Reference parity: mythril/laser/smt/bool.py:14 (`Bool`, `And:87`,
`Or`, `Not`, `Xor`, `is_true`/`is_false`).
"""

from __future__ import annotations

from typing import Optional, Set, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.expression import Expression


class Bool(Expression):
    """A boolean symbolic expression."""

    @property
    def is_false(self) -> bool:
        return self.raw is terms.FALSE

    @property
    def is_true(self) -> bool:
        return self.raw is terms.TRUE

    @property
    def value(self) -> Optional[bool]:
        if self.raw is terms.TRUE:
            return True
        if self.raw is terms.FALSE:
            return False
        return None

    @property
    def symbolic(self) -> bool:
        return self.value is None

    def __eq__(self, other) -> "Bool":  # type: ignore[override]
        if isinstance(other, bool):
            other = Bool(terms.bool_const(other))
        return Bool(
            terms.bnot(terms.bxor(self.raw, other.raw)),
            self.annotations | other.annotations,
        )

    def __ne__(self, other) -> "Bool":  # type: ignore[override]
        if isinstance(other, bool):
            other = Bool(terms.bool_const(other))
        return Bool(
            terms.bxor(self.raw, other.raw), self.annotations | other.annotations
        )

    def __hash__(self):
        return self.raw._hash

    def substitute(self, original, new):
        raise NotImplementedError

    def __bool__(self):
        # reference semantics (mythril/laser/smt/bool.py:73-79): a
        # symbolic Bool is falsy. Engine algorithms rely on this — e.g.
        # `x in list_of_bitvecs` works through __eq__ because interned
        # terms make structural equality concrete-True while distinct
        # terms stay symbolic (treated as not-equal).
        v = self.value
        return v if v is not None else False


def And(*args: Union[Bool, bool]) -> Bool:
    anns: Set = set()
    raw = []
    for a in args:
        if isinstance(a, bool):
            raw.append(terms.bool_const(a))
        else:
            raw.append(a.raw)
            anns |= a.annotations
    return Bool(terms.band(*raw), anns)


def Or(*args: Union[Bool, bool]) -> Bool:
    anns: Set = set()
    raw = []
    for a in args:
        if isinstance(a, bool):
            raw.append(terms.bool_const(a))
        else:
            raw.append(a.raw)
            anns |= a.annotations
    return Bool(terms.bor(*raw), anns)


def Not(a: Bool) -> Bool:
    return Bool(terms.bnot(a.raw), a.annotations)


def Xor(a: Bool, b: Bool) -> Bool:
    return Bool(terms.bxor(a.raw, b.raw), a.annotations | b.annotations)


def Implies(a: Bool, b: Bool) -> Bool:
    return Bool(terms.implies(a.raw, b.raw), a.annotations | b.annotations)


def is_false(a: Bool) -> bool:
    return a.is_false


def is_true(a: Bool) -> bool:
    return a.is_true
