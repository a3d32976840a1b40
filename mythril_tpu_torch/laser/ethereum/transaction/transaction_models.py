"""Transaction objects and the two frame-control signals.

Covers mythril/laser/ethereum/transaction/transaction_models.py: the
monotonically increasing transaction-id stream, TransactionStartSignal
/ TransactionEndSignal (how opcode handlers talk to the engine), the
message-call and contract-creation transaction shapes with symbolic
defaults, and the deployment rule that a creation frame's returned
bytes become the new account's runtime code.
"""

from __future__ import annotations

import itertools
import logging
from copy import copy
from typing import Optional, Union

from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.ethereum.state.environment import Environment
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.smt import BitVec, UGE, symbol_factory

log = logging.getLogger(__name__)

_tx_ids = itertools.count(1)


def get_next_transaction_id() -> str:
    return str(next(_tx_ids))


def reset_transaction_ids() -> None:
    """Restart the id stream — deterministic replays across analysis
    runs (tests rely on it)."""
    global _tx_ids
    _tx_ids = itertools.count(1)


class TransactionEndSignal(Exception):
    """A transaction frame finished (RETURN/STOP/REVERT/SELFDESTRUCT)."""

    def __init__(self, global_state: GlobalState, revert: bool = False) -> None:
        self.global_state = global_state
        self.revert = revert


class TransactionStartSignal(Exception):
    """An instruction opened a nested frame (CALL/CREATE family)."""

    def __init__(self, transaction, op_code: str, global_state: GlobalState):
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class BaseTransaction:
    """Data shared by both transaction kinds.

    Accepted fields (all keyword): callee_account, caller, call_data,
    identifier, gas_price, gas_limit, origin, code, call_value,
    init_call_data, static. Unset gas_price/origin/call_value default
    to canonical symbols named `<field><identifier>`.
    """

    #: fields that fall back to a fresh symbol when unset
    SYMBOLIC_DEFAULTS = {"gas_price": "gasprice", "origin": "origin",
                         "call_value": "callvalue"}

    def __init__(self, world_state: WorldState, **fields) -> None:
        assert isinstance(world_state, WorldState)
        self.world_state = world_state
        ident = fields.get("identifier")
        self.id = ident or get_next_transaction_id()

        for attr, tag in self.SYMBOLIC_DEFAULTS.items():
            given = fields.get(attr)
            if given is None:
                given = symbol_factory.BitVecSym(f"{tag}{ident}", 256)
            setattr(self, attr, given)

        for attr in ("gas_limit", "code", "caller", "callee_account"):
            setattr(self, attr, fields.get(attr))
        self.static = fields.get("static", False)
        self.return_data: Optional[str] = None

        data = fields.get("call_data")
        if data is None and fields.get("init_call_data", True):
            self.call_data: BaseCalldata = SymbolicCalldata(self.id)
        elif isinstance(data, BaseCalldata):
            self.call_data = data
        else:
            self.call_data = ConcreteCalldata(self.id, [])

    def _entry_state(self, environment: Environment, function: str) -> GlobalState:
        """Entry state for this transaction, with the call value moved
        under a solvency constraint."""
        state = GlobalState(self.world_state, environment, None)
        state.environment.active_function_name = function

        value = environment.callvalue
        if not isinstance(value, BitVec):
            value = symbol_factory.BitVecVal(value, 256)
        balances = state.world_state.balances
        state.world_state.constraints.append(
            UGE(balances[environment.sender], value)
        )
        balances[environment.active_account.address] += value
        balances[environment.sender] -= value
        return state

    # historical name, part of the public surface
    def initial_global_state_from_environment(self, environment, active_function):
        return self._entry_state(environment, active_function)

    def initial_global_state(self) -> GlobalState:
        raise NotImplementedError

    def __str__(self) -> str:
        target = "-1"
        if self.callee_account is not None:
            addr = self.callee_account.address
            target = (
                "{:#42x}".format(addr.value)
                if addr.value is not None
                else str(addr)
            )
        return f"{self.__class__.__name__} {self.id} from {self.caller} to {target}"


class MessageCallTransaction(BaseTransaction):
    """An external or internal message call."""

    def initial_global_state(self) -> GlobalState:
        env = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code or self.callee_account.code,
            static=self.static,
        )
        return self._entry_state(env, "fallback")

    def end(self, global_state: GlobalState, return_data=None, revert=False) -> None:
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)


class ContractCreationTransaction(BaseTransaction):
    """A deployment: runs init code; the returned bytes become the new
    account's runtime code."""

    def __init__(
        self,
        world_state: WorldState,
        caller: BitVec = None,
        contract_name=None,
        contract_address=None,
        **fields,
    ) -> None:
        # snapshot for issue reports; terms are interned+immutable so a
        # structural copy matches the reference's deepcopy
        self.prev_world_state = copy(world_state)

        account = world_state.create_account(
            0,
            concrete_storage=True,
            creator=caller.value,
            address=contract_address if isinstance(contract_address, int) else None,
        )
        if contract_name:
            account.contract_name = contract_name
        # calldata stays symbolic; CODESIZE/CODECOPY compensate for
        # constructor arguments riding on the code
        fields["init_call_data"] = True
        super().__init__(
            world_state, caller=caller, callee_account=account, **fields
        )

    def initial_global_state(self) -> GlobalState:
        env = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            self.code,
        )
        return self._entry_state(env, "constructor")

    def end(self, global_state: GlobalState, return_data=None, revert=False):
        deployable = return_data and all(
            isinstance(b, int) for b in return_data
        )
        if not deployable:
            self.return_data = None
            raise TransactionEndSignal(global_state, revert=revert)

        account = global_state.environment.active_account
        account.code.assign_bytecode(bytes(return_data).hex())
        self.return_data = str(hex(account.address.value))
        assert account.code.instruction_list != []
        raise TransactionEndSignal(global_state, revert=revert)
