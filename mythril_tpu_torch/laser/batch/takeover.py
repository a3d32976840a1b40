"""Host takeover: resume a device lane in the object-model engine.

A lane that halts `Status.UNSUPPORTED` (CALL family, EXTCODE*,
over-cap keccak) or `ERR_MEM` (capacity) stopped *at* the offending
instruction with its machine state intact. This module lifts that
state — pc, stack, memory, storage journal, gas bounds — into a host
`GlobalState` mid-frame and lets the LASER engine carry the execution
to its end with the full reference semantics. The device covers the
cheap 99% of instructions; the host covers the expressive tail
(round-1 verdict item 6).
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Dict, Optional

import numpy as np

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.batch.state import StateBatch, Status
from mythril_tpu_torch.laser.ethereum.cfg import Node
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.svm import LaserEVM
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    MessageCallTransaction,
    get_next_transaction_id,
)
from mythril_tpu_torch.laser.ethereum.util import get_instruction_index
from mythril_tpu_torch.laser.smt import symbol_factory
from mythril_tpu_torch.ops import u256

log = logging.getLogger(__name__)

#: statuses the host engine can meaningfully pick up from
RESUMABLE = (Status.UNSUPPORTED, Status.ERR_MEM)


def _word(value: int):
    return symbol_factory.BitVecVal(value, 256)


def lift_lane(
    code_hex: str, batch: StateBatch, lane: int, extra_accounts=None
):
    """Rebuild one lane as a mid-frame host GlobalState.

    Returns (laser, global_state) with the state already on the
    engine's worklist; the caller runs `laser.exec(track_gas=True)`.

    `extra_accounts` — [(address, code_hex, balance, storage_dict)] —
    populates the world's foreign accounts, so a lane that degraded at
    a CALL into coded territory resumes against the real callee
    instead of an auto-created empty account.
    """
    address = u256.to_int(np.asarray(batch.address[lane]))
    caller = u256.to_int(np.asarray(batch.caller[lane]))
    origin = u256.to_int(np.asarray(batch.origin[lane]))
    value = u256.to_int(np.asarray(batch.callvalue[lane]))
    gasprice = u256.to_int(np.asarray(batch.gasprice[lane]))
    balance = u256.to_int(np.asarray(batch.balance[lane]))
    gas_budget = int(batch.gas_budget[lane])

    disassembly = Disassembly(code_hex)
    world_state = WorldState()
    account = Account(address, concrete_storage=True)
    account.code = disassembly
    world_state.put_account(account)
    account.set_balance(balance)

    for f_addr, f_code, f_balance, f_storage in extra_accounts or []:
        if f_addr == address:
            continue  # the exec account's live state wins
        foreign = Account(f_addr, concrete_storage=True)
        foreign.code = Disassembly(f_code)
        world_state.put_account(foreign)
        foreign.set_balance(f_balance)
        for slot, stored in (f_storage or {}).items():
            foreign.storage[_word(slot)] = _word(stored)

    # the full storage journal, zero writes included (a zeroing SSTORE
    # must override any earlier nonzero write on replay)
    keys = np.asarray(batch.storage_keys[lane])
    vals = np.asarray(batch.storage_vals[lane])
    for j in range(int(batch.storage_cnt[lane])):
        account.storage[_word(u256.to_int(keys[j]))] = _word(
            u256.to_int(vals[j])
        )

    n_data = int(batch.calldatasize[lane])
    if n_data > batch.calldata.shape[1]:
        # the lane ran on truncated calldata; a host continuation
        # would confidently compute the wrong result
        raise ValueError(
            f"lane calldata ({n_data}B) exceeds the batch capacity "
            f"({batch.calldata.shape[1]}B)"
        )
    data = bytes(
        np.asarray(batch.calldata[lane][:n_data]).astype(np.uint8).tolist()
    )
    tx_id = get_next_transaction_id()
    transaction = MessageCallTransaction(
        world_state=world_state,
        identifier=tx_id,
        gas_price=gasprice,
        gas_limit=gas_budget,
        origin=_word(origin),
        caller=_word(caller),
        callee_account=account,
        call_data=ConcreteCalldata(tx_id, data),
        call_value=value,
    )
    state = transaction.initial_global_state()
    state.transaction_stack.append((transaction, None))
    state.world_state.transaction_sequence.append(transaction)
    node = Node(account.contract_name)
    state.node = node
    node.states.append(state)

    # -- machine-state surgery -----------------------------------------
    ms = state.mstate
    byte_pc = int(batch.pc[lane])
    index = get_instruction_index(disassembly.instruction_list, byte_pc)
    if index is None:
        raise ValueError(f"lane pc {byte_pc} outside code")
    ms.pc = index

    sp = int(batch.sp[lane])
    lane_stack = np.asarray(batch.stack[lane])
    for i in range(sp):
        ms.stack.append(_word(u256.to_int(lane_stack[i])))

    n_mem = int(batch.msize_words[lane]) * 32
    if n_mem:
        ms.memory.extend(n_mem)
        mem = np.asarray(batch.mem[lane][:n_mem]).astype(np.uint8)
        for i, byte in enumerate(mem.tolist()):
            ms.memory[i] = byte

    ms.min_gas_used = int(batch.gas_min[lane])
    ms.max_gas_used = int(batch.gas_max[lane])

    laser = LaserEVM(requires_statespace=False)
    laser.time = datetime.now()
    laser.work_list.append(state)
    return laser, state


def resume_on_host(
    code_hex: str,
    batch: StateBatch,
    lane: int,
    timeout_s: int = 20,
    extra_accounts=None,
) -> Optional[Dict]:
    """Run a resumable lane to completion on the host engine.

    Returns {"open": bool, "storage": {slot: value}, "out": bytes,
    "gas_bounds": [(min, max), ...]} or None when the lift failed.
    """
    if int(batch.status[lane]) not in RESUMABLE:
        return None
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    # first-class outcome, not a silent log line: every takeover is a
    # lane the device model could not carry, and reports surface the
    # count beside the other degradation reasons
    DegradationLog().record(
        DegradationReason.HOST_TAKEOVER,
        site="takeover",
        detail=f"lane {lane} status {int(batch.status[lane])}",
    )
    try:
        time_handler.start_execution(timeout_s)
        laser, _ = lift_lane(code_hex, batch, lane, extra_accounts)
        final_states = laser.exec(track_gas=True) or []
    except Exception as why:
        log.debug("host takeover failed for lane %d: %s", lane, why)
        return None

    storage: Dict[int, int] = {}
    out = b""
    if laser.open_states:
        world_state = laser.open_states[0]
        address = u256.to_int(np.asarray(batch.address[lane]))
        account = world_state[_word(address)]
        for key, val in account.storage.printable_storage.items():
            k = key.value if hasattr(key, "value") else int(key)
            v = val.value if hasattr(val, "value") else int(val)
            if k is not None and v:
                storage[k] = v
        # the outermost transaction's return payload
        seq = world_state.transaction_sequence
        if seq and seq[-1].return_data:
            out = bytes(
                b if isinstance(b, int) else (b.value or 0)
                for b in seq[-1].return_data
            )
    return {
        "open": bool(laser.open_states),
        "storage": storage,
        "out": out,
        "gas_bounds": [
            (s.mstate.min_gas_used, s.mstate.max_gas_used)
            for s in final_states
        ],
    }
