"""Symbolic arrays (storage / calldata / balances).

The port's copy of the JAX package's laser/smt/array.py.

Reference parity: mythril/laser/smt/array.py:16-63 (`BaseArray`,
`Array` — named symbolic array, `K` — constant array).
"""

from __future__ import annotations

from typing import Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.bitvec import BitVec


class BaseArray:
    """Array of BitVec base class; [] reads select, []= writes store."""

    raw: terms.Term

    def __getitem__(self, item: BitVec) -> BitVec:
        return BitVec(terms.select(self.raw, item.raw), item.annotations)

    def __setitem__(self, key: BitVec, value: BitVec) -> None:
        self.raw = terms.store(self.raw, key.raw, value.raw)

    @property
    def domain_width(self) -> int:
        return self.raw.sort.width

    @property
    def range_width(self) -> int:
        return self.raw.sort.range_width


class Array(BaseArray):
    """A named symbolic smt array."""

    def __init__(self, name: str, domain: int, value_range: int):
        self.name = name
        self.raw = terms.array_var(name, domain, value_range)

    @classmethod
    def from_raw(cls, raw: terms.Term) -> "Array":
        obj = cls.__new__(cls)
        obj.name = raw.args[0] if raw.op == "avar" else "<derived>"
        obj.raw = raw
        return obj


class K(BaseArray):
    """A constant array: every index maps to `value`."""

    def __init__(self, domain: int, value_range: int, value: Union[int, BitVec]):
        if isinstance(value, int):
            value = BitVec(terms.bv_const(value, value_range))
        self.raw = terms.const_array(value.raw, domain)
