"""Symbolic transaction drivers: every input attacker-controlled.

Covers mythril/laser/ethereum/transaction/symbolic.py — the named
actor registry (creator / attacker / bystander), one fully-symbolic
message call per open world state with the sender constrained into
the actor pool, and symbolic contract creation.
"""

from __future__ import annotations

import logging
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.transaction.launch import (
    drain_open_states,
    enqueue_transaction,
)
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    get_next_transaction_id,
)
from mythril_tpu_torch.laser.smt import BitVec, symbol_factory

log = logging.getLogger(__name__)

BLOCK_GAS_LIMIT = 8_000_000

_CREATOR_DEFAULT = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE
_ATTACKER_DEFAULT = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
_BYSTANDER_DEFAULT = 0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA


class Actors:
    """Well-known transaction senders; issue reports and detector
    queries are phrased against these addresses."""

    _PROTECTED = ("CREATOR", "ATTACKER")

    def __init__(
        self,
        creator=_CREATOR_DEFAULT,
        attacker=_ATTACKER_DEFAULT,
        someguy=_BYSTANDER_DEFAULT,
    ):
        as_term = lambda v: symbol_factory.BitVecVal(v, 256)  # noqa: E731
        self.addresses = {
            "CREATOR": as_term(creator),
            "ATTACKER": as_term(attacker),
            "SOMEGUY": as_term(someguy),
        }

    def __setitem__(self, actor: str, address: Optional[str]):
        if address is None:
            if actor in self._PROTECTED:
                raise ValueError("Can't delete creator or attacker address")
            del self.addresses[actor]
            return
        if not address.startswith("0x"):
            raise ValueError("Actor address not in valid format")
        self.addresses[actor] = symbol_factory.BitVecVal(
            int(address[2:], 16), 256
        )

    def __getitem__(self, actor: str):
        return self.addresses[actor]

    def __len__(self):
        return len(self.addresses)

    @property
    def creator(self):
        return self.addresses["CREATOR"]

    @property
    def attacker(self):
        return self.addresses["ATTACKER"]


ACTORS = Actors()


def _sym(prefix: str, ident: str) -> BitVec:
    return symbol_factory.BitVecSym(f"{prefix}{ident}", 256)


def execute_message_call(laser_evm, callee_address: BitVec) -> None:
    """One fully symbolic transaction against `callee_address` from
    each open world state, then run the engine."""
    for world_state in drain_open_states(laser_evm):
        if world_state[callee_address].deleted:
            log.debug("Can not execute dead contract, skipping.")
            continue

        ident = get_next_transaction_id()
        sender = _sym("sender_", ident)
        enqueue_transaction(
            laser_evm,
            MessageCallTransaction(
                world_state=world_state,
                identifier=ident,
                gas_price=_sym("gas_price", ident),
                gas_limit=BLOCK_GAS_LIMIT,
                origin=sender,
                caller=sender,
                callee_account=world_state[callee_address],
                call_data=SymbolicCalldata(ident),
                call_value=_sym("call_value", ident),
            ),
            caller_pool=ACTORS.addresses.values(),
        )
    laser_evm.exec()


def execute_contract_creation(
    laser_evm, contract_initialization_code, contract_name=None, world_state=None
) -> Account:
    """Deploy init code symbolically; returns the created account."""
    del laser_evm.open_states[:]

    ident = get_next_transaction_id()
    transaction = ContractCreationTransaction(
        world_state=world_state or WorldState(),
        identifier=ident,
        gas_price=_sym("gas_price", ident),
        gas_limit=BLOCK_GAS_LIMIT,
        origin=ACTORS["CREATOR"],
        code=Disassembly(contract_initialization_code),
        caller=ACTORS["CREATOR"],
        contract_name=contract_name,
        call_data=None,
        call_value=_sym("call_value", ident),
    )
    enqueue_transaction(laser_evm, transaction, caller_pool=ACTORS.addresses.values())
    laser_evm.exec(True)
    return transaction.callee_account
