"""Opcode registry and dispatch core.

Semantics are declared, not subclassed: each handler registers itself
in `TABLE` via the decorators below, together with the bookkeeping the
dispatcher applies uniformly — write protection inside STATICCALL
frames, gas-bound accumulation, and the pc bump. This replaces the
reference's one-class/one-method-per-opcode layout
(mythril/laser/ethereum/instructions.py) with the same table shape the
batched device engine uses, so host and device semantics stay listed
side by side.

Registration forms:

    @full("SHA3", gas=False)           handler(frame) -> [states]
    @pure("ADD", arity=2)              fn(a, b) -> result pushed as-is
    @reading("CALLER")                 fn(frame) -> value pushed
"""

from __future__ import annotations

import logging
from copy import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    OutOfGasException,
    WriteProtection,
)
from mythril_tpu_torch.laser.ethereum.instruction_data import get_opcode_gas
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame, as_word
from mythril_tpu_torch.laser.smt import BitVec

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class OpSpec:
    """How one opcode runs through the dispatcher."""

    handler: Callable[[Frame], Optional[list]]
    writes_state: bool = False  # refuse inside STATICCALL frames
    auto_gas: bool = True  # charge the opcode-table gas bounds
    auto_pc: bool = True  # bump pc after the handler


#: canonical-name -> spec; resume handlers live under "<name>/post"
TABLE: Dict[str, OpSpec] = {}


def canonical(op_code: str) -> str:
    """Collapse the numbered families to one table entry each
    (PUSH1..PUSH32 -> PUSH, and likewise DUP/SWAP/LOG)."""
    for family in ("PUSH", "DUP", "SWAP", "LOG"):
        if op_code.startswith(family) and op_code != family:
            return family
    return op_code


def full(name: str, *, writes=False, gas=True, pc=True, post=False):
    """Register a handler that works on the whole frame."""

    def register(fn):
        key = name + "/post" if post else name
        TABLE[key] = OpSpec(fn, writes_state=writes, auto_gas=gas, auto_pc=pc)
        return fn

    return register


def pure(name: str, arity: int):
    """Register a stack-to-stack operator: pops `arity` coerced words,
    pushes the function's result (which may be a Bool — comparisons
    stay Bool on the stack)."""

    def register(fn):
        def handler(frame: Frame):
            frame.push(fn(*frame.pops(arity)))

        TABLE[name] = OpSpec(handler)
        return fn

    return register


def reading(name: str):
    """Register a nullary environment read: pushes fn(frame)."""

    def register(fn):
        def handler(frame: Frame):
            frame.push(fn(frame))

        TABLE[name] = OpSpec(handler)
        return fn

    return register


def charge_gas(state, op_code: str) -> None:
    """Accumulate the opcode's (min,max) gas bounds and stop the path
    when even the lower bound exceeds the transaction's limit."""
    lo, hi = get_opcode_gas(op_code)
    ms = state.mstate
    ms.min_gas_used += lo
    ms.max_gas_used += hi
    enforce_gas_limit(state)


def enforce_gas_limit(state) -> None:
    state.mstate.check_gas()
    tx = state.current_transaction
    if isinstance(tx.gas_limit, BitVec):
        if tx.gas_limit.value is None:
            return
        tx.gas_limit = tx.gas_limit.value
    if state.mstate.min_gas_used >= tx.gas_limit:
        raise OutOfGasException()


def run_opcode(
    op_code: str,
    global_state,
    loader=None,
    post: bool = False,
) -> list:
    """Execute one opcode against a private copy of `global_state` and
    return the successor states."""
    key = canonical(op_code) + ("/post" if post else "")
    spec = TABLE.get(key)
    if spec is None:
        raise NotImplementedError(op_code)

    if spec.writes_state and global_state.environment.static:
        raise WriteProtection(
            f"{op_code} is a state-mutating instruction and cannot run "
            "inside a static call"
        )

    frame = Frame(copy(global_state), op_code, loader)
    successors = spec.handler(frame)
    if successors is None:
        successors = [frame.state]

    for state in successors:
        if spec.auto_gas:
            charge_gas(state, op_code)
        if spec.auto_pc:
            state.mstate.pc += 1
    return successors
