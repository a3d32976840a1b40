"""Cross-contract opcodes: the CALL family and CREATE/CREATE2.

Each opcode has two halves. The entry half resolves the callee and
raises TransactionStartSignal so the engine can push the new frame;
the `/post` half runs when that frame returns — the engine re-executes
the call instruction in resume mode against the caller's state, whose
stack still holds the original operands (reference:
mythril/laser/ethereum/instructions.py:1911-2343 and svm.py:415-468).

The shared shape of all four entry handlers lives in `_call_setup`;
what differs per opcode (who is the storage context, who is the
sender, which value flows) is expressed in the few lines that build
each MessageCallTransaction.
"""

from __future__ import annotations

import logging
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.call import (
    get_call_data,
    get_call_parameters,
    native_call,
)
from mythril_tpu_torch.laser.ethereum.evm_exceptions import WriteProtection
from mythril_tpu_torch.laser.ethereum.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.transaction import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionStartSignal,
    get_next_transaction_id,
)
from mythril_tpu_torch.laser.ethereum.vm.core import full
from mythril_tpu_torch.laser.ethereum.vm.data import charge_sha3_gas
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame
from mythril_tpu_torch.laser.smt import BitVec, Concat, Extract, simplify, symbol_factory
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)


def transfer_ether(global_state, sender, receiver, value) -> None:
    """Move wei between accounts under the solvency constraint
    UGE(balance[sender], value)."""
    from mythril_tpu_torch.laser.smt import UGE

    if not isinstance(value, BitVec):
        value = symbol_factory.BitVecVal(value, 256)
    world = global_state.world_state
    world.constraints.append(UGE(world.balances[sender], value))
    world.balances[receiver] += value
    world.balances[sender] -= value


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------
def _fresh_retval(frame: Frame) -> BitVec:
    return frame.fresh(f"retval_{frame.byte_addr}", 256)


def _smear_output_window(frame: Frame, out_offset, out_size) -> None:
    """Unknown call effect: fill the output window with fresh symbolic
    bytes (requires concrete bounds)."""
    if isinstance(out_offset, int):
        out_offset = symbol_factory.BitVecVal(out_offset, 256)
    if isinstance(out_size, int):
        out_size = symbol_factory.BitVecVal(out_size, 256)
    if out_offset.symbolic or out_size.symbolic:
        return
    for i in range(out_size.value):
        frame.memory[out_offset + i] = frame.fresh(
            f"call_output_var({simplify(out_offset + i)})_{frame.ms.pc}", 8
        )


def _out_window(frame: Frame, has_value: bool):
    """Peek the output-window operands without popping (kept live for
    the degraded paths)."""
    lo = -7 if has_value else -6
    return frame.stack[lo : lo + 2]  # [out_size, out_offset]


def _call_setup(frame: Frame, has_value: bool) -> Optional[tuple]:
    """Pop and resolve call operands. Returns None after handling the
    degraded paths (unresolvable params / plain ether send) itself."""
    out_size, out_offset = _out_window(frame, has_value)
    try:
        params = get_call_parameters(frame.state, frame.loader, has_value)
    except ValueError as why:
        log.debug("unresolvable call parameters, smearing output: %s", why)
        _smear_output_window(frame, out_offset, out_size)
        frame.push(_fresh_retval(frame))
        return None

    callee_account = params[1]
    if callee_account is not None and callee_account.code.bytecode == "":
        # codeless callee: a bare transfer, result symbolic
        log.debug("call into a codeless account — treating as transfer")
        transfer_ether(
            frame.state,
            frame.env.active_account.address,
            callee_account.address,
            params[3],
        )
        frame.push(_fresh_retval(frame))
        return None
    return params


def _enforce_static_value(frame: Frame, value) -> None:
    """Inside a STATICCALL frame, CALL may not move value."""
    if not frame.env.static:
        return
    if isinstance(value, int):
        if value > 0:
            raise WriteProtection("value transfer inside a static frame")
    elif value.symbolic:
        frame.require(value == symbol_factory.BitVecVal(0, 256))
    elif value.value > 0:
        raise WriteProtection("value transfer inside a static frame")


def _dispatch(frame: Frame, transaction) -> None:
    raise TransactionStartSignal(transaction, frame.op, frame.state)


# ---------------------------------------------------------------------------
# CALL family entries
# ---------------------------------------------------------------------------
@full("CALL")
def _call(frame: Frame):
    params = _call_setup(frame, has_value=True)
    if params is None:
        return
    callee_address, callee_account, data, value, gas, out_off, out_sz = params
    _enforce_static_value(frame, value)

    handled = native_call(frame.state, callee_address, data, out_off, out_sz)
    if handled:
        return handled

    env = frame.env
    _dispatch(
        frame,
        MessageCallTransaction(
            world_state=frame.world,
            gas_price=env.gasprice,
            gas_limit=gas,
            origin=env.origin,
            caller=env.active_account.address,
            callee_account=callee_account,
            call_data=data,
            call_value=value,
            static=env.static,
        ),
    )


@full("CALLCODE")
def _callcode(frame: Frame):
    params = _call_setup(frame, has_value=True)
    if params is None:
        return
    _, callee_account, data, value, gas, _, _ = params

    # callee's code, caller's storage context
    env = frame.env
    _dispatch(
        frame,
        MessageCallTransaction(
            world_state=frame.world,
            gas_price=env.gasprice,
            gas_limit=gas,
            origin=env.origin,
            code=callee_account.code,
            caller=env.address,
            callee_account=env.active_account,
            call_data=data,
            call_value=value,
            static=env.static,
        ),
    )


@full("DELEGATECALL")
def _delegatecall(frame: Frame):
    params = _call_setup(frame, has_value=False)
    if params is None:
        return
    _, callee_account, data, _, gas, _, _ = params

    # callee's code; sender and value inherited from the current frame
    env = frame.env
    _dispatch(
        frame,
        MessageCallTransaction(
            world_state=frame.world,
            gas_price=env.gasprice,
            gas_limit=gas,
            origin=env.origin,
            code=callee_account.code,
            caller=env.sender,
            callee_account=env.active_account,
            call_data=data,
            call_value=env.callvalue,
            static=env.static,
        ),
    )


@full("STATICCALL")
def _staticcall(frame: Frame):
    params = _call_setup(frame, has_value=False)
    if params is None:
        return
    callee_address, callee_account, data, value, gas, out_off, out_sz = params

    handled = native_call(frame.state, callee_address, data, out_off, out_sz)
    if handled:
        return handled

    env = frame.env
    _dispatch(
        frame,
        MessageCallTransaction(
            world_state=frame.world,
            gas_price=env.gasprice,
            gas_limit=gas,
            origin=env.origin,
            code=callee_account.code,
            caller=env.address,
            callee_account=callee_account,
            call_data=data,
            call_value=value,
            static=True,
        ),
    )


# ---------------------------------------------------------------------------
# CALL family resume handlers
# ---------------------------------------------------------------------------
def _resume_call(
    frame: Frame,
    six_operands: bool,
    pops_value: bool,
    constrain_zero_when_unknown=False,
):
    """Write returned data into the caller's output window and push a
    retval pinned to the frame's outcome.

    Note the split between `six_operands` (where the output window
    sits on the stack) and `pops_value` (how many operands the resolver
    consumes): DELEGATECALL has six operands but resolves with-value,
    a reference quirk kept for drop-in parity (reference
    post_handler: `with_value = function_name is not "staticcall"`).
    """
    # peek the window before the resolver pops anything, so the
    # degraded path still sees the right operands
    out_size, out_offset = _out_window(frame, has_value=not six_operands)
    try:
        params = get_call_parameters(frame.state, frame.loader, pops_value)
    except ValueError as why:
        log.debug("unresolvable parameters on call resume: %s", why)
        _smear_output_window(frame, out_offset, out_size)
        frame.push(_fresh_retval(frame))
        return
    _, _, _, _, _, out_offset, out_size = params

    returned = frame.state.last_return_data
    if returned is None:
        # the callee never produced data (e.g. symbolic target)
        retval = _fresh_retval(frame)
        frame.push(retval)
        if constrain_zero_when_unknown:
            _smear_output_window(frame, out_offset, out_size)
            frame.require(retval == 0)
        return

    try:
        out_offset = frame.concrete(out_offset)
        out_size = frame.concrete(out_size)
    except TypeError:
        frame.push(_fresh_retval(frame))
        return

    n = min(out_size, len(returned))
    frame.ms.mem_extend(out_offset, n)
    for i in range(n):
        frame.memory[out_offset + i] = returned[i]

    retval = _fresh_retval(frame)
    frame.push(retval)
    frame.require(retval == 1)


full("CALL", post=True)(
    lambda f: _resume_call(f, six_operands=False, pops_value=True)
)
full("CALLCODE", post=True)(
    lambda f: _resume_call(
        f, six_operands=False, pops_value=True, constrain_zero_when_unknown=True
    )
)
full("DELEGATECALL", post=True)(
    lambda f: _resume_call(
        f, six_operands=True, pops_value=True, constrain_zero_when_unknown=True
    )
)
full("STATICCALL", post=True)(
    lambda f: _resume_call(f, six_operands=True, pops_value=False)
)


# ---------------------------------------------------------------------------
# CREATE / CREATE2
# ---------------------------------------------------------------------------
def _spawn_contract(frame: Frame, value, mem_at, mem_len, salt=None):
    """Carve init code + constructor args out of memory and raise the
    creation signal. CREATE2 pins the new address via keccak."""
    payload = get_call_data(frame.state, mem_at, mem_at + mem_len)

    # concrete prefix = init bytecode; the symbolic tail = ctor args
    raw = []
    boundary = payload.size
    total = payload.size
    if isinstance(total, BitVec):
        total = 10**5 if total.symbolic else total.value
    for i in range(total):
        cell = payload[i]
        if cell.symbolic:
            boundary = i
            break
        raw.append(cell.value)

    if not raw:
        log.debug("CREATE with no concrete init code")
        frame.push(1)
        return

    init_hex = bytes(raw).hex()
    ctor_args = ConcreteCalldata(get_next_transaction_id(), payload[boundary:])
    charge_sha3_gas(frame.state, len(init_hex) // 2)

    env = frame.env
    new_address = None
    if salt is not None:
        creator = env.active_account.address
        if salt.symbolic:
            if salt.size() != 256:
                salt = Concat(
                    symbol_factory.BitVecVal(0, 256 - salt.size()), salt
                )
            from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
                keccak_function_manager,
            )

            digest, link = keccak_function_manager.create_keccak(
                Concat(
                    symbol_factory.BitVecVal(255, 8),
                    creator,
                    salt,
                    symbol_factory.BitVecVal(
                        int(get_code_hash(init_hex), 16), 256
                    ),
                )
            )
            new_address = Extract(255, 96, digest)
            frame.require(link)
        else:
            preimage = (
                "0xff"
                + "{:040x}".format(creator.value)
                + "{:064x}".format(salt.value)
                + get_code_hash(init_hex)[2:]
            )
            new_address = int(get_code_hash(preimage)[26:], 16)

    _dispatch(
        frame,
        ContractCreationTransaction(
            world_state=frame.world,
            caller=env.active_account.address,
            code=Disassembly(init_hex),
            call_data=ctor_args,
            gas_price=env.gasprice,
            gas_limit=frame.ms.gas_limit,
            origin=env.origin,
            call_value=value,
            contract_address=new_address,
        ),
    )


@full("CREATE", writes=True)
def _create(frame: Frame):
    value, mem_at, mem_len = frame.ms.pop(3)
    _spawn_contract(frame, value, mem_at, mem_len)


@full("CREATE2", writes=True)
def _create2(frame: Frame):
    value, mem_at, mem_len, salt = frame.ms.pop(4)
    _spawn_contract(frame, value, mem_at, mem_len, salt=salt)


def _resume_create(frame: Frame, n_operands: int):
    frame.ms.pop(n_operands)
    created = frame.state.last_return_data
    frame.push(
        symbol_factory.BitVecVal(int(created, 16) if created else 0, 256)
    )


full("CREATE", post=True)(lambda f: _resume_create(f, 3))
full("CREATE2", post=True)(lambda f: _resume_create(f, 4))
