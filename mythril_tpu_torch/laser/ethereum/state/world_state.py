"""World state: the accounts trie plus cross-transaction bookkeeping.

Reference parity: mythril/laser/ethereum/state/world_state.py:17-228 —
accounts dict, one shared symbolic `balances` Array with a snapshot of
`starting_balances` (the EtherThief property compares against it), path
`Constraints` hoisted to world level between transactions, the
transaction sequence, and auto-creation of unknown accounts on lookup.
"""

from __future__ import annotations

from copy import copy
from typing import Any, Dict, List, Optional, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.smt import Array, BitVec, symbol_factory
from mythril_tpu_torch.support.keccak import keccak256


def _rlp_encode_bytes(data: bytes) -> bytes:
    if len(data) == 1 and data[0] < 0x80:
        return data
    if len(data) <= 55:
        return bytes([0x80 + len(data)]) + data
    ln = len(data).to_bytes((len(data).bit_length() + 7) // 8, "big")
    return bytes([0xB7 + len(ln)]) + ln + data


def _rlp_encode_list(items: List[bytes]) -> bytes:
    payload = b"".join(_rlp_encode_bytes(i) for i in items)
    if len(payload) <= 55:
        return bytes([0xC0 + len(payload)]) + payload
    ln = len(payload).to_bytes((len(payload).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + payload


def generate_contract_address(creator: int, nonce: int) -> int:
    """CREATE address: keccak256(rlp([creator, nonce]))[12:]."""
    sender_bytes = creator.to_bytes(20, "big")
    nonce_bytes = b"" if nonce == 0 else nonce.to_bytes(
        (nonce.bit_length() + 7) // 8, "big"
    )
    return int.from_bytes(
        keccak256(_rlp_encode_list([sender_bytes, nonce_bytes]))[12:], "big"
    )


class WorldState:
    """The set of accounts and global symbolic facts between txs."""

    def __init__(
        self,
        transaction_sequence: Optional[List] = None,
        annotations: Optional[List[StateAnnotation]] = None,
    ):
        self._accounts: Dict[int, Account] = {}
        self.balances = Array("balance", 256, 256)
        self.starting_balances = copy(self.balances)
        self.constraints = Constraints()
        self.node = None
        self.transaction_sequence = transaction_sequence or []
        self._annotations = annotations or []

    @property
    def accounts(self) -> Dict[int, Account]:
        return self._accounts

    def __getitem__(self, item: Union[BitVec, int]) -> Account:
        """Get an account; unknown addresses auto-create an empty
        symbolic-storage account (reference: world_state.py:45)."""
        if isinstance(item, int):
            item = symbol_factory.BitVecVal(item, 256)
        try:
            return self._accounts[item.value]
        except KeyError:
            new_account = Account(
                address=item, code=None, balances=self.balances
            )
            self.put_account(new_account)
            return new_account

    def accounts_exist_or_load(self, addr: str, dynamic_loader) -> Account:
        """Hit the accounts cache, else hydrate code/balance over RPC
        (reference: world_state.py:187)."""
        addr_bitvec = symbol_factory.BitVecVal(int(addr, 16), 256)
        if addr_bitvec.value in self._accounts:
            return self._accounts[addr_bitvec.value]
        if dynamic_loader is None:
            raise ValueError("dynamic loader is not set")
        try:
            balance = dynamic_loader.read_balance(addr)
        except Exception:
            balance = None
        try:
            code = dynamic_loader.dynld(addr)
        except Exception:
            code = None
        account = self.create_account(
            balance=int(balance, 16) if isinstance(balance, str) else (balance or 0),
            address=addr_bitvec.value,
            dynamic_loader=dynamic_loader,
            code=code,
        )
        return account

    def create_account(
        self,
        balance: Union[int, BitVec] = 0,
        address: Optional[int] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        creator: Optional[int] = None,
        code: Optional[Disassembly] = None,
        nonce: int = 0,
    ) -> Account:
        """Create (and register) a new account; for CREATE the address
        derives from creator+nonce (reference: world_state.py:127)."""
        if address is None:
            if creator is not None:
                address = generate_contract_address(
                    creator, self._accounts[creator].nonce if creator in self._accounts else 0
                )
            else:
                address = self._generate_new_address()
        new_account = Account(
            address=address,
            code=code,
            balances=self.balances,
            concrete_storage=concrete_storage,
            dynamic_loader=dynamic_loader,
            nonce=nonce,
        )
        # truthy check: a concrete 0 / None leaves the balance symbolic
        # (pinning unknown balances to 0 would prune solvent-sender paths)
        if balance:
            new_account.set_balance(balance)
        self.put_account(new_account)
        return new_account

    def create_initialized_contract_account(self, contract_code, storage) -> None:
        new_account = Account(
            address=self._generate_new_address(), code=contract_code, balances=self.balances
        )
        new_account.storage = storage
        self.put_account(new_account)

    def _generate_new_address(self) -> int:
        """Deterministic fresh address outside the used set (the
        reference draws random hex; determinism keeps runs replayable)."""
        seed = len(self._accounts)
        while True:
            candidate = int.from_bytes(
                keccak256(b"mythril_tpu_account_%d" % seed)[12:], "big"
            )
            if candidate not in self._accounts:
                return candidate
            seed += 1

    def put_account(self, account: Account) -> None:
        self._accounts[account.address.value] = account
        account._balances = self.balances

    def remove_account(self, address: int) -> None:
        self._accounts.pop(address, None)

    # -- annotations -----------------------------------------------------
    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type):
        return filter(lambda x: isinstance(x, annotation_type), self._annotations)

    def __copy__(self) -> "WorldState":
        new_annotations = [copy(a) for a in self._annotations]
        new = WorldState(
            transaction_sequence=self.transaction_sequence[:],
            annotations=new_annotations,
        )
        new.balances = copy(self.balances)
        new.starting_balances = copy(self.starting_balances)
        for address, account in self._accounts.items():
            new_account = copy(account)
            new_account._balances = new.balances
            new.put_account(new_account)
        new.constraints = copy(self.constraints)
        new.node = self.node
        return new
