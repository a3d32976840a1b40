"""Keccak-256 modeling for symbolic inputs.

Reference parity: mythril/laser/ethereum/keccak_function_manager.py:24-152.
Keccak over a w-bit input is modeled as a pair of uninterpreted
functions (keccak256_w and its inverse): the inverse constraint makes
each function injective, outputs are confined to mutually disjoint
intervals (one interval per input width) and forced ≡ 0 mod 64 so
hash-derived storage slots spread out the way Solidity array layouts
assume (the VerX encoding). Concrete inputs hash for real, and every
symbolic application carries Or-cases linking it to all concrete
hashes seen so far, so symbolic == concrete inputs imply equal hashes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.smt import (
    And,
    BitVec,
    Bool,
    Function,
    Or,
    ULE,
    ULT,
    URem,
    symbol_factory,
)
from mythril_tpu_torch.support.keccak import keccak256

TOTAL_PARTS = 10**40
PART = (2**256 - 1) // TOTAL_PARTS
INTERVAL_DIFFERENCE = 10**30
hash_matcher = "fffffff"  # prefix placeholder hashes carry in reports


class KeccakFunctionManager:
    """Uninterpreted-function model of keccak256, one function pair per
    input bit-width, with disjoint output intervals."""

    def __init__(self):
        self.store_function: Dict[int, Tuple[Function, Function]] = {}
        self.interval_hook_for_size: Dict[int, int] = {}
        self._index_counter = TOTAL_PARTS - 34534
        self.hash_result_store: Dict[int, List[BitVec]] = {}
        self.quick_inverse: Dict[BitVec, BitVec] = {}  # VMTests fast path
        self.concrete_hashes: Dict[BitVec, BitVec] = {}

    def reset(self) -> None:
        """Fresh analysis run (the reference re-instantiates the module
        singleton between contracts via `reset_lru_cache`-style global
        hygiene; an explicit reset is cleaner)."""
        self.__init__()

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        """Real keccak256 of a concrete bit-vector value."""
        return symbol_factory.BitVecVal(
            int.from_bytes(
                keccak256(data.value.to_bytes(data.size() // 8, byteorder="big")),
                "big",
            ),
            256,
        )

    def get_function(self, length: int) -> Tuple[Function, Function]:
        """The (keccak, inverse) pair for a given input width."""
        try:
            func, inverse = self.store_function[length]
        except KeyError:
            func = Function(f"keccak256_{length}", length, 256)
            inverse = Function(f"keccak256_{length}-1", 256, length)
            self.store_function[length] = (func, inverse)
            self.hash_result_store[length] = []
        return func, inverse

    @staticmethod
    def get_empty_keccak_hash() -> BitVec:
        """keccak256(b'')."""
        return symbol_factory.BitVecVal(
            int.from_bytes(keccak256(b""), "big"), 256
        )

    def create_keccak(self, data: BitVec) -> Tuple[BitVec, Bool]:
        """Model keccak256(data): returns (hash expression, side
        condition the path must assume)."""
        length = data.size()
        func, inverse = self.get_function(length)

        if data.symbolic is False:
            concrete_hash = self.find_concrete_keccak(data)
            self.concrete_hashes[data] = concrete_hash
            condition = And(
                func(data) == concrete_hash, inverse(func(data)) == data
            )
            return concrete_hash, condition

        condition = self._create_condition(func_input=data)
        self.hash_result_store[length].append(func(data))
        return func(data), condition

    def get_concrete_hash_data(self, model) -> Dict[int, List[Optional[int]]]:
        """Concrete witness values of all symbolic hashes under `model`
        (used by get_transaction_sequence to patch placeholder hashes)."""
        concrete_hashes: Dict[int, List[Optional[int]]] = {}
        for size in self.hash_result_store:
            concrete_hashes[size] = []
            for val in self.hash_result_store[size]:
                try:
                    concrete_hashes[size].append(model.eval_int(val))
                except Exception:
                    continue
        return concrete_hashes

    def _create_condition(self, func_input: BitVec) -> Bool:
        """Interval + injectivity + concrete-linkage constraints for one
        symbolic application."""
        length = func_input.size()
        func, inv = self.get_function(length)
        try:
            index = self.interval_hook_for_size[length]
        except KeyError:
            self.interval_hook_for_size[length] = self._index_counter
            index = self._index_counter
            self._index_counter -= INTERVAL_DIFFERENCE

        lower_bound = index * PART
        upper_bound = lower_bound + PART

        cond = And(
            inv(func(func_input)) == func_input,
            ULE(symbol_factory.BitVecVal(lower_bound, 256), func(func_input)),
            ULT(func(func_input), symbol_factory.BitVecVal(upper_bound, 256)),
            URem(func(func_input), symbol_factory.BitVecVal(64, 256)) == 0,
        )
        concrete_cond = symbol_factory.Bool(False)
        for key, keccak in self.concrete_hashes.items():
            concrete_cond = Or(
                concrete_cond, And(func(func_input) == keccak, key == func_input)
            )
        return And(inv(func(func_input)) == func_input, Or(cond, concrete_cond))


keccak_function_manager = KeccakFunctionManager()
