"""Transaction calldata models.

Reference parity: mythril/laser/ethereum/state/calldata.py:25-310 —
`BaseCalldata` (indexing, slices, `get_word_at`), `ConcreteCalldata`
(interned concrete byte array), `SymbolicCalldata` (symbolic Array with
symbolic size; out-of-bounds reads evaluate to 0), and the `Basic*`
variants backed by plain Python lists.  `concrete(model)` extracts the
witness bytes for transaction-sequence reports.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

from mythril_tpu_torch.laser.smt import (
    Array,
    BitVec,
    Concat,
    Expression,
    If,
    K,
    simplify,
    symbol_factory,
)
from mythril_tpu_torch.laser.smt.model import Model

# Hard bound on materialized slice length: calldata past this size is not
# meaningful EVM input, and wrap-around spans would iterate ~2^256 times.
MAX_SLICE_ELEMENTS = 1 << 20


class BaseCalldata:
    """Base symbolic calldata representation."""

    def __init__(self, tx_id: str):
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        result = self.size
        if isinstance(result, int):
            return symbol_factory.BitVecVal(result, 256)
        return result

    @property
    def size(self) -> Union[BitVec, int]:
        raise NotImplementedError()

    def get_word_at(self, offset: int) -> BitVec:
        """The 32-byte big-endian word starting at `offset`.

        Indexes byte-by-byte instead of slicing so a fully symbolic
        offset works: the word length is statically 32, only the
        per-byte indices stay symbolic.
        """
        parts = [self._load(offset + i) for i in range(32)]
        return simplify(Concat(*parts))

    def __getitem__(self, item: Union[int, slice, BitVec]) -> Any:
        if isinstance(item, int) or isinstance(item, Expression):
            return self._load(item)
        if isinstance(item, slice):
            start = 0 if item.start is None else item.start
            step = 1 if item.step is None else item.step
            stop = self.size if item.stop is None else item.stop
            current_index = (
                start
                if isinstance(start, BitVec)
                else symbol_factory.BitVecVal(start, 256)
            )
            stop_bv = (
                stop if isinstance(stop, BitVec) else symbol_factory.BitVecVal(stop, 256)
            )
            # symbolic base with a decidable span: iterate by count —
            # symbolic indices are fine, only the length must be concrete
            step_val = step.value if isinstance(step, BitVec) else step
            if step_val is None or step_val <= 0:
                raise Z3IndexingError("calldata slice step must be a concrete positive int")
            span = simplify(stop_bv - current_index)
            parts = []
            if span.value is not None:
                count = (span.value + step_val - 1) // step_val
                if count > MAX_SLICE_ELEMENTS:
                    # a wrap-around span (stop < start mod 2^256) would
                    # otherwise iterate ~2^256 times
                    raise Z3IndexingError(
                        f"calldata slice spans {count} elements "
                        f"(cap {MAX_SLICE_ELEMENTS})"
                    )
                for _ in range(count):
                    parts.append(self._load(current_index))
                    current_index = simplify(current_index + step)
                return parts
            while True:
                done = simplify(current_index != stop).value
                if done is None:
                    raise IndexError("symbolic calldata slice bound")
                if not done:
                    break
                parts.append(self._load(current_index))
                current_index = simplify(current_index + step)
            return parts
        raise ValueError

    def _load(self, item: Union[int, BitVec]) -> Any:
        raise NotImplementedError()

    def concrete(self, model: Optional[Model]) -> list:
        """Witness byte list under `model`."""
        raise NotImplementedError()


class Z3IndexingError(Exception):
    """Slice bounds cannot be decided concretely (kept under the
    reference's historical name)."""


class ConcreteCalldata(BaseCalldata):
    """Calldata with fully known bytes, stored in an SMT constant array
    so symbolic indices still work (reference: calldata.py
    ConcreteCalldata)."""

    def __init__(self, tx_id: str, calldata: list):
        self._calldata = calldata
        self._keyed = K(256, 8, 0)
        for i, value in enumerate(calldata):
            value = (
                value
                if isinstance(value, BitVec)
                else symbol_factory.BitVecVal(value, 8)
            )
            self._keyed[symbol_factory.BitVecVal(i, 256)] = value
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> BitVec:
        item = (
            symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        )
        return simplify(self._keyed[item])

    def concrete(self, model: Optional[Model]) -> list:
        out = []
        for b in self._calldata:
            if isinstance(b, BitVec):
                out.append(b.value if b.value is not None else 0)
            else:
                out.append(b)
        return out

    @property
    def size(self) -> int:
        return len(self._calldata)


class BasicConcreteCalldata(BaseCalldata):
    """Concrete calldata as a plain list (no SMT array) — symbolic
    indices fall back to an If-chain (reference: BasicConcreteCalldata)."""

    def __init__(self, tx_id: str, calldata: list):
        self._calldata = calldata
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        if isinstance(item, int):
            try:
                return self._calldata[item]
            except IndexError:
                return 0
        value = symbol_factory.BitVecVal(0x0, 8)
        for i in range(self.size):
            value = If(
                item == i,
                symbol_factory.BitVecVal(self._calldata[i], 8)
                if not isinstance(self._calldata[i], BitVec)
                else self._calldata[i],
                value,
            )
        return value

    def concrete(self, model: Optional[Model]) -> list:
        return list(self._calldata)

    @property
    def size(self) -> int:
        return len(self._calldata)


class SymbolicCalldata(BaseCalldata):
    """Fully attacker-controlled calldata: a symbolic Array indexed by a
    symbolic size; reads past `calldatasize` yield 0 (reference:
    calldata.py:219-232)."""

    def __init__(self, tx_id: str):
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize", 256)
        self._calldata = Array(str(tx_id) + "_calldata", 256, 8)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        item = (
            symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        )
        return simplify(
            If(
                item < self._size,
                simplify(self._calldata[item]),
                symbol_factory.BitVecVal(0, 8),
            )
        )

    def concrete(self, model: Optional[Model]) -> list:
        concrete_length = model.eval_int(self.size)
        result = []
        for i in range(concrete_length):
            value = model.eval_int(self._load(i))
            result.append(value)
        return result

    @property
    def size(self) -> BitVec:
        return self._size


class BasicSymbolicCalldata(BaseCalldata):
    """Symbolic calldata tracked as a list of (index, value) reads —
    every fresh index mints a new symbol (reference:
    BasicSymbolicCalldata)."""

    def __init__(self, tx_id: str):
        self._reads: List = []
        self._size = symbol_factory.BitVecSym(str(tx_id) + "_calldatasize", 256)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec], clean: bool = False) -> Any:
        x = symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        symbolic_base_value = If(
            x >= self._size,
            symbol_factory.BitVecVal(0, 8),
            symbol_factory.BitVecSym(f"{self.tx_id}_calldata_{str(item)}", 8),
        )
        return_value = symbolic_base_value
        for r_index, r_value in self._reads:
            return_value = If(r_index == x, r_value, return_value)
        if not clean:
            self._reads.append((x, symbolic_base_value))
        return simplify(return_value)

    def concrete(self, model: Optional[Model]) -> list:
        concrete_length = model.eval_int(self.size)
        return [model.eval_int(self._load(i, clean=True)) for i in range(concrete_length)]

    @property
    def size(self) -> BitVec:
        return self._size
