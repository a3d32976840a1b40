"""Memory, storage, keccak and the bulk-copy opcode family.

The copy family (CALLDATACOPY/CODECOPY/EXTCODECOPY/RETURNDATACOPY)
shares two primitives: `pour_calldata` and `pour_code`, which move a
byte window into machine memory and degrade to symbolic placeholder
bytes whenever an operand refuses to concretize — the same graceful
degradation ladder as the reference (instructions.py copy helpers),
expressed once instead of per-opcode.
"""

from __future__ import annotations

import logging
from typing import Union

from mythril_tpu_torch.laser.ethereum.instruction_data import calculate_sha3_gas
from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
    keccak_function_manager,
)
from mythril_tpu_torch.laser.ethereum.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.ethereum.vm.core import enforce_gas_limit, full
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame
from mythril_tpu_torch.laser.smt import BitVec, Concat, Extract, simplify, symbol_factory

log = logging.getLogger(__name__)

#: stand-in byte count when a copy size is symbolic (overwritten later)
FALLBACK_COPY_SIZE = 320


# ---------------------------------------------------------------------------
# plain memory + storage
# ---------------------------------------------------------------------------
@full("MLOAD")
def _mload(frame: Frame):
    where = frame.stack.pop()
    frame.ms.mem_extend(where, 32)
    frame.push(frame.memory.get_word_at(where))


@full("MSTORE")
def _mstore(frame: Frame):
    where, word = frame.pops_raw(2)
    try:
        frame.ms.mem_extend(where, 32)
    except Exception:
        log.debug("MSTORE could not extend memory")
    frame.memory.write_word_at(where, word)


@full("MSTORE8")
def _mstore8(frame: Frame):
    where, word = frame.pops_raw(2)
    frame.ms.mem_extend(where, 1)
    try:
        low_byte: Union[int, BitVec] = frame.concrete(word) % 256
    except TypeError:
        low_byte = Extract(7, 0, word)
    frame.memory[where] = low_byte


@full("SLOAD")
def _sload(frame: Frame):
    slot = frame.stack.pop()
    frame.push(frame.env.active_account.storage[slot])


@full("SSTORE", writes=True)
def _sstore(frame: Frame):
    slot, word = frame.pops_raw(2)
    frame.env.active_account.storage[slot] = word


# ---------------------------------------------------------------------------
# keccak
# ---------------------------------------------------------------------------
def charge_sha3_gas(state, n_bytes: int) -> None:
    lo, hi = calculate_sha3_gas(n_bytes)
    state.mstate.min_gas_used += lo
    state.mstate.max_gas_used += hi
    enforce_gas_limit(state)


@full("SHA3", gas=False)
def _sha3(frame: Frame):
    start, size_word = frame.pops_raw(2)
    try:
        n_bytes = frame.concrete(size_word)
    except TypeError:
        # symbolic length: pin it to the two-word mapping-slot shape,
        # by far the dominant source of symbolic-length hashes
        n_bytes = 64
        frame.require(size_word == n_bytes)
    charge_sha3_gas(frame.state, n_bytes)

    frame.ms.mem_extend(start, n_bytes)
    window = [
        b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
        for b in frame.memory[start : start + n_bytes]
    ]
    if not window:
        frame.push(keccak_function_manager.get_empty_keccak_hash())
        return
    preimage = simplify(Concat(window)) if len(window) > 1 else window[0]
    digest, link = keccak_function_manager.create_keccak(preimage)
    frame.push(digest)
    frame.require(link)


# ---------------------------------------------------------------------------
# copy primitives
# ---------------------------------------------------------------------------
def _placeholder(frame: Frame, what: str, at, detail="") -> None:
    """One symbolic byte standing in for an uncopyable window."""
    frame.memory[at] = frame.fresh(f"{what}({detail})", 8)


def pour_calldata(frame: Frame, mem_at, data_at, count) -> None:
    """Copy `count` calldata bytes to memory at `mem_at`; symbolic
    operands degrade per the reference ladder."""
    try:
        mem_at = frame.concrete(mem_at)
    except TypeError:
        log.debug("calldata copy to a symbolic memory offset")
        return
    try:
        data_at = frame.concrete(data_at)
    except TypeError:
        log.debug("calldata copy from a symbolic data offset")
        data_at = simplify(data_at)
    try:
        count = frame.concrete(count)
    except TypeError:
        log.debug("calldata copy of symbolic size")
        count = FALLBACK_COPY_SIZE

    if count <= 0:
        return
    tag = f"{frame.env.active_account.contract_name}[{data_at}: + {count}]"
    try:
        frame.ms.mem_extend(mem_at, count)
    except TypeError as why:
        log.debug("memory extension failed: %s", why)
        frame.ms.mem_extend(mem_at, 1)
        _placeholder(frame, "calldata_", mem_at, tag)
        return
    try:
        src = data_at
        window = []
        for _ in range(count):
            window.append(frame.env.calldata[src])
            src = src + 1 if isinstance(src, int) else simplify(src + 1)
        for i, b in enumerate(window):
            frame.memory[mem_at + i] = b
    except IndexError:
        log.debug("calldata read out of range")
        _placeholder(frame, "calldata_", mem_at, tag)


def pour_code(frame: Frame, bytecode: str, mem_at, code_at, count) -> None:
    """Copy a window of hex `bytecode` into memory; reads past the end
    stop short (EVM pads with zeros only conceptually — untouched
    memory already reads as zero)."""
    try:
        mem_at = frame.concrete(mem_at)
    except TypeError:
        log.debug("code copy to a symbolic memory offset")
        return

    who = frame.env.active_account.contract_name
    try:
        count = frame.concrete(count)
        frame.ms.mem_extend(mem_at, count)
    except TypeError:
        frame.ms.mem_extend(mem_at, 1)
        _placeholder(frame, "code", mem_at, who)
        return

    try:
        code_at = frame.concrete(code_at)
    except TypeError:
        log.debug("code copy from a symbolic code offset")
        frame.ms.mem_extend(mem_at, count)
        for i in range(count):
            _placeholder(frame, "code", mem_at + i, who)
        return

    if bytecode.startswith("0x"):
        bytecode = bytecode[2:]
    for i in range(count):
        lo = 2 * (code_at + i)
        if lo + 2 > len(bytecode):
            break
        frame.memory[mem_at + i] = int(bytecode[lo : lo + 2], 16)


# ---------------------------------------------------------------------------
# the copy opcodes
# ---------------------------------------------------------------------------
@full("CALLDATACOPY")
def _calldatacopy(frame: Frame):
    mem_at, data_at, count = frame.pops_raw(3)
    if isinstance(frame.state.current_transaction, ContractCreationTransaction):
        log.debug("CALLDATACOPY in a creation frame is a no-op")
        return
    pour_calldata(frame, mem_at, data_at, count)


@full("CODECOPY")
def _codecopy(frame: Frame):
    mem_at, code_at, count = frame.pops_raw(3)
    bytecode = frame.env.code.bytecode
    if bytecode.startswith("0x"):
        bytecode = bytecode[2:]
    code_len = len(bytecode) // 2

    if isinstance(frame.state.current_transaction, ContractCreationTransaction):
        # in a creation frame, offsets past the init code read the
        # constructor arguments, which live behind the calldata model
        if isinstance(frame.env.calldata, SymbolicCalldata):
            at = code_at if isinstance(code_at, int) else code_at.value
            if at is not None and at >= code_len:
                pour_calldata(frame, mem_at, code_at - code_len, count)
                return
        else:
            at = frame.concrete(code_at)
            n = frame.concrete(count)
            from_code = min(n, max(code_len - at, 0))
            pour_code(frame, bytecode, mem_at, at, from_code)
            spill = at + n - code_len
            if spill > 0:
                pour_calldata(
                    frame,
                    mem_at + from_code,
                    max(at - code_len, 0),
                    spill,
                )
            return

    pour_code(frame, bytecode, mem_at, code_at, count)


@full("EXTCODECOPY")
def _extcodecopy(frame: Frame):
    target, mem_at, code_at, count = frame.pops_raw(4)
    try:
        addr = hex(frame.concrete(target))
    except TypeError:
        log.debug("EXTCODECOPY of a symbolic address")
        return
    try:
        bytecode = frame.world.accounts_exist_or_load(
            addr, frame.loader
        ).code.bytecode
    except (ValueError, AttributeError) as why:
        log.debug("EXTCODECOPY lookup failed: %s", why)
        return
    pour_code(frame, bytecode, mem_at, code_at, count)


@full("RETURNDATACOPY")
def _returndatacopy(frame: Frame):
    mem_at, ret_at, count = frame.pops_raw(3)
    try:
        mem_at = frame.concrete(mem_at)
        ret_at = frame.concrete(ret_at)
        count = frame.concrete(count)
    except TypeError:
        log.debug("RETURNDATACOPY with symbolic operands")
        return
    returned = frame.state.last_return_data
    if returned is None:
        return
    frame.ms.mem_extend(mem_at, count)
    for i in range(count):
        frame.memory[mem_at + i] = (
            returned[ret_at + i] if ret_at + i < len(returned) else 0
        )
