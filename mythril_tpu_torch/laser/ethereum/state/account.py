"""Account and Storage models.

Reference parity: mythril/laser/ethereum/state/account.py — `Storage`
(:18-83): an SMT array (symbolic Array, or constant-0 K for fresh
concrete deployments) plus a printable mirror for reports and lazy
on-chain loads through a DynLoader; `Account` (:86-184): address,
nonce, code `Disassembly`, storage, with balance backed by the world
state's shared symbolic balance array.
"""

from __future__ import annotations

from copy import copy
from typing import Any, Dict, Optional, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.smt import Array, BitVec, K, simplify, symbol_factory


class Storage:
    """Contract storage: a total map BV(256) -> BV(256)."""

    def __init__(self, concrete: bool = False, address: BitVec = None, dynamic_loader=None):
        if concrete:
            self._standard_storage = K(256, 256, 0)
        else:
            self._standard_storage = Array(f"Storage{address}", 256, 256)
        self.concrete = concrete
        self.address = address
        self.dynld = dynamic_loader
        self.storage_keys_loaded = set()
        self.printable_storage: Dict[BitVec, BitVec] = {}

    def __getitem__(self, item: BitVec) -> BitVec:
        # lazy on-chain hydration for concrete keys of on-chain accounts
        # (reference: account.py:37-61)
        if (
            self.address is not None
            and self.address.value not in (None, 0)
            and item.value is not None
            and item.value not in self.storage_keys_loaded
            and self.dynld is not None
            and getattr(self.dynld, "active", False)
        ):
            try:
                value = int(
                    self.dynld.read_storage(
                        contract_address="0x{:040x}".format(self.address.value),
                        index=item.value,
                    ),
                    16,
                )
                self._standard_storage[item] = symbol_factory.BitVecVal(value, 256)
                self.storage_keys_loaded.add(item.value)
                self.printable_storage[item] = self._standard_storage[item]
            except ValueError:
                pass
        return simplify(self._standard_storage[item])

    def __setitem__(self, key: BitVec, value: Any) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        self.printable_storage[key] = value
        self._standard_storage[key] = value
        if key.value is not None:
            self.storage_keys_loaded.add(key.value)

    def __copy__(self) -> "Storage":
        new = Storage(concrete=self.concrete, address=self.address, dynamic_loader=self.dynld)
        new._standard_storage = copy(self._standard_storage)
        new.printable_storage = dict(self.printable_storage)
        new.storage_keys_loaded = set(self.storage_keys_loaded)
        return new

    def __str__(self) -> str:
        return str(self.printable_storage)


class Account:
    """One Ethereum account."""

    def __init__(
        self,
        address: Union[BitVec, str, int],
        code: Optional[Disassembly] = None,
        contract_name: Optional[str] = None,
        balances: Optional[Array] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        nonce: int = 0,
    ):
        self.nonce = nonce
        if isinstance(address, str):
            address = int(address, 16)
        if isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)
        self.address = address
        self.code = code or Disassembly("")
        self.storage = Storage(
            concrete_storage, address=address, dynamic_loader=dynamic_loader
        )
        self.contract_name = contract_name
        self.deleted = False
        self._balances = balances
        self.balance = lambda: self._balances[self.address]

    def serialised_code(self) -> str:
        return self.code.bytecode

    def add_balance(self, balance: Union[int, BitVec]) -> None:
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        self._balances[self.address] = self._balances[self.address] + balance

    def set_balance(self, balance: Union[int, BitVec]) -> None:
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        assert self._balances is not None
        self._balances[self.address] = balance

    @property
    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code,
            "balance": self.balance(),
            "storage": self.storage,
        }

    def __copy__(self, memodict={}) -> "Account":
        new = Account(
            address=self.address,
            code=self.code,
            contract_name=self.contract_name,
            balances=self._balances,
            nonce=self.nonce,
        )
        new.storage = self.storage.__copy__()
        new.deleted = self.deleted
        return new

    def __str__(self) -> str:
        return str(self.as_dict)
