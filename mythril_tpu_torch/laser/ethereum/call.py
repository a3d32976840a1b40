"""Callee resolution for the CALL-family opcodes.

Covers mythril/laser/ethereum/call.py: popping the 6/7 call operands,
resolving the target (concrete address, a `Storage[n]`-shaped symbolic
expression chased through the dynamic loader, or left symbolic),
building the callee's calldata out of caller memory, and routing
precompile addresses to the native implementations.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Union

from mythril_tpu_torch.laser.ethereum import natives
from mythril_tpu_torch.laser.ethereum.instruction_data import calculate_native_gas
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT, PRECOMPILE_FUNCTIONS
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.util import get_concrete_int
from mythril_tpu_torch.laser.smt import BitVec, Expression, If, simplify, symbol_factory

log = logging.getLogger(__name__)

#: byte budget assumed when calldata is carved with a symbolic size
SYMBOLIC_CALLDATA_SIZE = 320

GSTIPEND = 2300  # stipend forwarded alongside value-bearing calls

_STORAGE_SLOT_SHAPE = re.compile(r"Storage\[(\d+)\]")
_ADDRESS_SHAPE = re.compile(r"^0x[0-9a-f]{40}$")


def get_call_parameters(
    global_state: GlobalState, dynamic_loader, with_value: bool = False
):
    """Pop the call operands off the stack and resolve them into
    (callee_address, callee_account, call_data, value, gas,
    out_offset, out_size)."""
    ms = global_state.mstate
    gas, to = ms.pop(2)
    value = ms.pop() if with_value else 0
    in_offset, in_size, out_offset, out_size = ms.pop(4)

    callee_address = get_callee_address(global_state, dynamic_loader, to)
    call_data = get_call_data(global_state, in_offset, in_size)

    callee_account = None
    needs_account = isinstance(callee_address, BitVec) or (
        isinstance(callee_address, str)
        and (
            int(callee_address, 16) > PRECOMPILE_COUNT
            or int(callee_address, 16) == 0
        )
    )
    if needs_account:
        callee_account = get_callee_account(
            global_state, callee_address, dynamic_loader
        )

    gas = gas + If(value > 0, symbol_factory.BitVecVal(GSTIPEND, gas.size()), 0)
    return callee_address, callee_account, call_data, value, gas, out_offset, out_size


def get_callee_address(
    global_state: GlobalState, dynamic_loader, symbolic_to_address: Expression
):
    """Resolve a call target: concrete value -> padded hex string;
    `Storage[n]` shapes chase the slot on-chain; anything else stays
    symbolic."""
    try:
        return "0x{:040x}".format(get_concrete_int(symbolic_to_address))
    except TypeError:
        log.debug("Symbolic call target")

    if dynamic_loader is None:
        return symbolic_to_address
    slot = _STORAGE_SLOT_SHAPE.search(str(simplify(symbolic_to_address)))
    if slot is None:
        return symbolic_to_address

    this = global_state.environment.active_account.address.value
    try:
        stored = dynamic_loader.read_storage(
            "0x{:040X}".format(this), int(slot.group(1))
        )
    except Exception:
        return symbolic_to_address

    if not _ADDRESS_SHAPE.match(stored):
        stored = "0x" + stored[26:]
    return stored


def get_callee_account(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    dynamic_loader,
) -> Account:
    """The target's account object; a genuinely symbolic address gets
    a fresh account sharing the world's balance array."""
    if isinstance(callee_address, BitVec):
        if callee_address.symbolic:
            return Account(
                callee_address, balances=global_state.world_state.balances
            )
        callee_address = hex(callee_address.value)[2:]
    return global_state.world_state.accounts_exist_or_load(
        callee_address, dynamic_loader
    )


def get_call_data(
    global_state: GlobalState,
    memory_start: Union[int, BitVec],
    memory_size: Union[int, BitVec],
) -> BaseCalldata:
    """Carve the callee's calldata out of caller memory; symbolic
    bounds degrade to fully symbolic calldata."""
    tag = f"{global_state.current_transaction.id}_internalcall"

    if isinstance(memory_start, int):
        memory_start = symbol_factory.BitVecVal(memory_start, 256)
    if isinstance(memory_size, int):
        memory_size = symbol_factory.BitVecVal(memory_size, 256)
    if memory_size.symbolic:
        memory_size = SYMBOLIC_CALLDATA_SIZE

    try:
        window = global_state.mstate.memory[
            get_concrete_int(memory_start) : get_concrete_int(
                memory_start + memory_size
            )
        ]
        return ConcreteCalldata(tag, window)
    except TypeError:
        log.debug(
            "Carving calldata failed on symbolic offset %s size %s",
            memory_start,
            memory_size,
        )
        return SymbolicCalldata(tag)


def insert_ret_val(global_state: GlobalState) -> None:
    """Push a success retval pinned to 1."""
    here = global_state.get_current_instruction()["address"]
    retval = global_state.new_bitvec(f"retval_{here}", 256)
    global_state.mstate.stack.append(retval)
    global_state.world_state.constraints.append(retval == 1)


def native_call(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    call_data: BaseCalldata,
    memory_out_offset: Union[int, Expression],
    memory_out_size: Union[int, Expression],
) -> Optional[List[GlobalState]]:
    """Run a precompile call concretely. None when the target is not a
    precompile; symbolic inputs produce fresh symbolic output bytes."""
    if isinstance(callee_address, BitVec):
        return None
    which = int(callee_address, 16)
    if not 0 < which <= PRECOMPILE_COUNT:
        return None

    log.debug("Native contract called: %s", callee_address)
    try:
        out_at = get_concrete_int(memory_out_offset)
        out_len = get_concrete_int(memory_out_size)
    except TypeError:
        log.debug("native call with symbolic output window")
        return [global_state]

    ms = global_state.mstate
    impl_name = PRECOMPILE_FUNCTIONS[which - 1].__name__
    lo, hi = calculate_native_gas(
        ms.calculate_extension_size(out_at, out_len), impl_name
    )
    ms.min_gas_used += lo
    ms.max_gas_used += hi
    ms.mem_extend(out_at, out_len)

    try:
        produced = natives.native_contracts(which, call_data)
    except natives.NativeContractException:
        # symbolic precompile input: unknowable output bytes
        for i in range(out_len):
            ms.memory[out_at + i] = global_state.new_bitvec(
                f"{impl_name}({call_data})", 8
            )
        insert_ret_val(global_state)
        return [global_state]

    for i in range(min(len(produced), out_len)):  # excess output is chopped
        ms.memory[out_at + i] = produced[i]
    insert_ret_val(global_state)
    return [global_state]
