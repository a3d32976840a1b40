"""Byte-addressed EVM memory.

Reference parity: mythril/laser/ethereum/state/memory.py:28-209 —
word reads/writes as 32-byte Concat/Extract, symbolic indices allowed
(kept in a side table keyed on the interned index term), and slice
operations with symbolic length capped at APPROX_ITR iterations.
"""

from __future__ import annotations

from typing import Dict, List, Union

from mythril_tpu_torch.laser.smt import (
    BitVec,
    Bool,
    Concat,
    Extract,
    If,
    simplify,
    symbol_factory,
)
from mythril_tpu_torch.laser.smt import terms

APPROX_ITR = 100


def convert_bv(val: Union[int, BitVec]) -> BitVec:
    if isinstance(val, BitVec):
        return val
    return symbol_factory.BitVecVal(val, 256)


class Memory:
    """EVM memory: a growable concrete-indexed byte list plus a sparse
    map for symbolic-index accesses."""

    def __init__(self):
        self._msize = 0
        self._memory: Dict[int, Union[int, BitVec]] = {}
        self._symbolic: Dict[terms.Term, BitVec] = {}

    def __len__(self) -> int:
        return self._msize

    def extend(self, size: int) -> None:
        self._msize = max(self._msize, size)

    # ------------------------------------------------------------------
    def get_word_at(self, index: int) -> Union[int, BitVec]:
        """32-byte big-endian word at concrete `index`."""
        parts = [self[index + i] for i in range(32)]
        if all(isinstance(b, int) for b in parts):
            value = 0
            for b in parts:
                value = (value << 8) | b
            return value
        bvs = [
            b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
            for b in parts
        ]
        return simplify(Concat(*bvs))

    def write_word_at(self, index: int, value: Union[int, BitVec, bool, Bool]) -> None:
        """Write a 32-byte big-endian word at concrete `index`."""
        if isinstance(value, int):
            value &= (1 << 256) - 1
            for i in range(32):
                self[index + 31 - i] = (value >> (8 * i)) & 0xFF
            return
        if isinstance(value, bool):
            value = symbol_factory.BitVecVal(1 if value else 0, 256)
        if isinstance(value, Bool):
            value = If(
                value,
                symbol_factory.BitVecVal(1, 256),
                symbol_factory.BitVecVal(0, 256),
            )
        if value.value is not None:
            self.write_word_at(index, value.value)
            return
        for i in range(32):
            hi = 255 - 8 * i
            self[index + i] = simplify(Extract(hi, hi - 7, value))

    # ------------------------------------------------------------------
    def __getitem__(
        self, item: Union[int, BitVec, slice]
    ) -> Union[int, BitVec, List]:
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop if item.stop is not None else self._msize
            step = item.step or 1
            if isinstance(start, BitVec) or isinstance(stop, BitVec):
                return self._symbolic_slice(start, stop)
            return [self[i] for i in range(start, stop, step)]

        if isinstance(item, BitVec):
            item = simplify(item)
            if item.value is not None:
                item = item.value
            else:
                return self._symbolic.get(
                    item.raw, symbol_factory.BitVecVal(0, 8)
                )
        if item < 0:
            raise IndexError("negative memory index")
        return self._memory.get(item, 0)

    def __setitem__(
        self,
        key: Union[int, BitVec, slice],
        value: Union[int, BitVec, List],
    ) -> None:
        if isinstance(key, slice):
            start = key.start or 0
            stop = key.stop
            if stop is None:
                raise IndexError("open-ended memory slice write")
            if isinstance(start, BitVec) or isinstance(stop, BitVec):
                # bounded approximation for symbolic slice writes
                for i, b in enumerate(value[:APPROX_ITR]):
                    self[start + i] = b
                return
            for i, addr in enumerate(range(start, stop, key.step or 1)):
                self[addr] = value[i]
            return

        if isinstance(key, BitVec):
            key = simplify(key)
            if key.value is not None:
                key = key.value
            else:
                if isinstance(value, int):
                    value = symbol_factory.BitVecVal(value, 8)
                self._symbolic[key.raw] = value
                return
        if key < 0:
            raise IndexError("negative memory index")
        if isinstance(value, BitVec) and value.size() != 8:
            raise ValueError("only byte writes are allowed")
        if isinstance(value, int):
            value &= 0xFF
        self._memory[key] = value
        self._msize = max(self._msize, key + 1)

    # ------------------------------------------------------------------
    def _symbolic_slice(self, start, stop) -> List:
        start = convert_bv(start)
        stop = convert_bv(stop)
        out = []
        for i in range(APPROX_ITR):
            cond = simplify(Bool((start + i < stop).raw))
            from mythril_tpu_torch.laser.smt.bool import is_false

            if is_false(cond):
                break
            out.append(self[start + i])
        return out

    def __copy__(self) -> "Memory":
        new = Memory()
        new._msize = self._msize
        new._memory = dict(self._memory)
        new._symbolic = dict(self._symbolic)
        return new
