"""Uninterpreted functions (keccak modeling).

The port's copy of the JAX package's laser/smt/function.py.

Reference parity: mythril/laser/smt/function.py:7 (`Function` wrapping
z3.Function). Applications become `uf` terms; the solver enforces
functional consistency by Ackermann expansion.
"""

from __future__ import annotations

from typing import List, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.expression import OrderedSet
from mythril_tpu_torch.laser.smt.bitvec import BitVec


class Function:
    """An uninterpreted function: domain widths -> range width."""

    def __init__(self, name: str, domain: Union[int, List[int]], value_range: int):
        self.name = name
        self.domain = [domain] if isinstance(domain, int) else list(domain)
        self.range = value_range

    def __call__(self, *items: BitVec) -> BitVec:
        anns = OrderedSet()
        for i in items:
            anns |= i.annotations
        return BitVec(
            terms.apply_uf(self.name, self.range, tuple(i.raw for i in items)), anns
        )

    def __eq__(self, other):
        return (
            isinstance(other, Function)
            and self.name == other.name
            and self.domain == other.domain
            and self.range == other.range
        )

    def __hash__(self):
        return hash(("uf-decl", self.name, tuple(self.domain), self.range))
