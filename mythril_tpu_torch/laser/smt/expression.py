"""Expression base: a term plus annotations.

Reference parity: mythril/laser/smt/expression.py:10 (`Expression`
generic over z3.ExprRef, carrying `annotations` used for taint
tracking by detection modules). Here the payload is our own `Term`.
"""

from __future__ import annotations

from typing import Iterable, Optional

from mythril_tpu_torch.laser.smt import terms


class OrderedSet:
    """Identity set with deterministic (insertion) iteration order.

    Annotations hash by object identity, so a plain `set` iterates in
    memory-address order — which varies run to run with allocator
    layout. Detection modules iterate annotation sets to pick issue
    witnesses, so that disorder leaks into which taint wins a dedupe
    race and drifts report bytes. A dict's keys give set semantics
    with insertion order."""

    __slots__ = ("_d",)

    def __init__(self, items: Iterable = ()):
        self._d = dict.fromkeys(items)

    def add(self, item) -> None:
        self._d[item] = None

    def update(self, items) -> None:
        for x in items:
            self._d[x] = None

    def copy(self) -> "OrderedSet":
        return OrderedSet(self._d)

    def union(self, *others) -> "OrderedSet":
        out = OrderedSet(self._d)
        for o in others:
            out.update(o)
        return out

    def __iter__(self):
        return iter(self._d)

    def __contains__(self, item) -> bool:
        return item in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __or__(self, other) -> "OrderedSet":
        out = OrderedSet(self._d)
        out.update(other)
        return out

    def __ror__(self, other) -> "OrderedSet":
        out = OrderedSet(other)
        out.update(self._d)
        return out

    def __ior__(self, other) -> "OrderedSet":
        self.update(other)
        return self

    def __eq__(self, other) -> bool:
        if isinstance(other, OrderedSet):
            return set(self._d) == set(other._d)
        if isinstance(other, (set, frozenset)):
            return set(self._d) == other
        return NotImplemented

    def __repr__(self):
        return f"OrderedSet({list(self._d)!r})"


class Expression:
    """A symbolic expression: immutable term + mutable annotation set."""

    def __init__(self, raw: terms.Term, annotations: Optional[Iterable] = None):
        self.raw = raw
        self._annotations = (
            OrderedSet(annotations) if annotations is not None else OrderedSet()
        )

    @property
    def annotations(self) -> OrderedSet:
        return self._annotations

    def annotate(self, annotation) -> None:
        self._annotations.add(annotation)

    def get_annotations(self, annotation_type):
        return [a for a in self._annotations if isinstance(a, annotation_type)]

    def simplify(self) -> None:
        """Terms constant-fold at construction; kept for API parity
        (reference Expression.simplify calls z3.simplify in place)."""

    def __repr__(self):
        return repr(self.raw)

    def size(self) -> int:
        return self.raw.width


def simplify(expression: Expression) -> Expression:
    """Return a simplified copy (reference: smt.simplify)."""
    expression.simplify()
    return expression
