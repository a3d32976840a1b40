"""Concolic transaction driver: every input concrete.

Covers mythril/laser/ethereum/transaction/concolic.py — the VMTests
conformance harness entry: one concrete message call per open state,
engine run with gas tracking, final states returned.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.launch import (
    drain_open_states,
    enqueue_transaction,
)
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    MessageCallTransaction,
    get_next_transaction_id,
)


def execute_message_call(
    laser_evm,
    callee_address,
    caller_address,
    origin_address,
    code,
    data,
    gas_limit,
    gas_price,
    value,
    track_gas: bool = False,
    block_number: Optional[int] = None,
) -> Optional[List[GlobalState]]:
    """Run one concrete message call from every open world state.

    A concrete `block_number` pins the environment's otherwise-symbolic
    block number, letting fixtures whose jump targets derive from
    NUMBER replay exactly (the reference skips those cases)."""
    overrides = None
    if block_number is not None:
        from mythril_tpu_torch.laser.smt import symbol_factory

        overrides = {
            "block_number": symbol_factory.BitVecVal(block_number, 256)
        }
    for world_state in drain_open_states(laser_evm):
        ident = get_next_transaction_id()
        enqueue_transaction(
            laser_evm,
            MessageCallTransaction(
                world_state=world_state,
                identifier=ident,
                gas_price=gas_price,
                gas_limit=gas_limit,
                origin=origin_address,
                code=Disassembly(code),
                caller=caller_address,
                callee_account=world_state[callee_address],
                call_data=ConcreteCalldata(ident, data),
                call_value=value,
            ),
            environment_overrides=overrides,
        )
    return laser_evm.exec(track_gas=track_gas)
