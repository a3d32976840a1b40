"""Environment, block-context and introspection opcodes.

Everything here reads a value and pushes it; the `reading` form keeps
each one to a single expression. Block-context values that the EVM
leaves to the miner are fresh symbols with *stable names* — the
predictable-variables detector keys on exactly these names (reference:
mythril/analysis/module/modules/dependence_on_predictable_vars.py).
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.laser.ethereum.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.ethereum.vm.core import full, reading
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame
from mythril_tpu_torch.laser.smt import Extract, If, symbol_factory
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)

CONSTRUCTOR_ARG_ALLOWANCE = 0x200  # room for 16 word-sized args

reading("ADDRESS")(lambda f: f.env.address)
reading("ORIGIN")(lambda f: f.env.origin)
reading("CALLER")(lambda f: f.env.sender)
reading("CALLVALUE")(lambda f: f.env.callvalue)
reading("GASPRICE")(lambda f: f.env.gasprice)
reading("CHAINID")(lambda f: f.env.chainid)
reading("BASEFEE")(lambda f: f.env.basefee)
reading("SELFBALANCE")(lambda f: f.env.active_account.balance())
reading("NUMBER")(lambda f: f.env.block_number)
reading("GASLIMIT")(lambda f: f.ms.gas_limit)
reading("MSIZE")(lambda f: f.ms.memory_size)

# miner-chosen values: fresh symbols, names are detector-visible API
reading("COINBASE")(lambda f: f.fresh("coinbase", 256))
reading("TIMESTAMP")(lambda f: f.fresh("timestamp", 256))
reading("DIFFICULTY")(lambda f: f.fresh("block_difficulty", 256))
reading("GAS")(lambda f: f.fresh("gas", 256))

reading("PC")(lambda f: f.byte_addr)


@full("BLOCKHASH")
def _blockhash(frame: Frame):
    height = frame.stack.pop()
    frame.push(frame.fresh(f"blockhash_block_{height}", 256))


@full("BALANCE")
def _balance(frame: Frame):
    who = frame.pop()
    if not who.symbolic:
        account = frame.world.accounts_exist_or_load(
            hex(who.value), frame.loader
        )
        frame.push(account.balance())
        return
    # symbolic address: If-chain over the known accounts, 0 otherwise
    total = symbol_factory.BitVecVal(0, 256)
    for account in frame.world.accounts.values():
        total = If(who == account.address, account.balance(), total)
    frame.push(total)


@full("CALLDATALOAD")
def _calldataload(frame: Frame):
    offset = frame.stack.pop()
    frame.push(frame.env.calldata.get_word_at(offset))


@full("CALLDATASIZE")
def _calldatasize(frame: Frame):
    if isinstance(frame.state.current_transaction, ContractCreationTransaction):
        # no calldata in a creation frame (args ride on the code)
        frame.push(0)
    else:
        frame.push(frame.env.calldata.calldatasize)


@full("CODESIZE")
def _codesize(frame: Frame):
    n = len(frame.env.code.bytecode) // 2
    if isinstance(frame.state.current_transaction, ContractCreationTransaction):
        # constructor arguments are appended to the init code; model
        # their size through the calldata abstraction
        args = frame.env.calldata
        if isinstance(args, ConcreteCalldata):
            n += args.size
        else:
            n += CONSTRUCTOR_ARG_ALLOWANCE
            frame.require(args.calldatasize == n)
    frame.push(n)


@full("EXTCODESIZE")
def _extcodesize(frame: Frame):
    target = frame.stack.pop()
    try:
        addr = hex(frame.concrete(target))
    except TypeError:
        log.debug("EXTCODESIZE of a symbolic address")
        frame.push(frame.fresh(f"extcodesize_{target}", 256))
        return
    try:
        bytecode = frame.world.accounts_exist_or_load(
            addr, frame.loader
        ).code.bytecode
    except (ValueError, AttributeError) as why:
        log.debug("EXTCODESIZE lookup failed: %s", why)
        frame.push(frame.fresh(f"extcodesize_{addr}", 256))
        return
    frame.push(len(bytecode) // 2)


@full("EXTCODEHASH")
def _extcodehash(frame: Frame):
    target = Extract(159, 0, frame.stack.pop())
    if target.symbolic:
        digest = int(get_code_hash(""), 16)
    elif target.value not in frame.world.accounts:
        digest = 0
    else:
        bytecode = frame.world.accounts_exist_or_load(
            "0x{:040x}".format(target.value), frame.loader
        ).code.bytecode
        digest = int(get_code_hash(bytecode), 16)
    frame.push(symbol_factory.BitVecVal(digest, 256))


@full("RETURNDATASIZE")
def _returndatasize(frame: Frame):
    data = frame.state.last_return_data
    if data is None:
        log.debug("RETURNDATASIZE before any call; unconstrained")
        frame.push(frame.fresh("returndatasize", 256))
    else:
        frame.push(len(data))
