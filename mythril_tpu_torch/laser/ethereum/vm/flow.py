"""Control flow and frame-ending opcodes.

JUMPI is where paths are born: each feasible branch gets its own
forked state carrying the branch condition as a fresh path constraint
(reference: instructions.py jumpi_). The frame-ending family routes
through `current_transaction.end(...)`, which raises the
TransactionEndSignal the engine unwinds on.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    StackUnderflowException,
)
from mythril_tpu_torch.laser.ethereum.instruction_data import get_opcode_gas
from mythril_tpu_torch.laser.ethereum.util import get_instruction_index
from mythril_tpu_torch.laser.ethereum.vm.core import full
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame
from mythril_tpu_torch.laser.smt import BitVec, Bool, Not, is_false, simplify

log = logging.getLogger(__name__)


def _tally_jump_gas(state, opcode: str) -> None:
    """Accumulate jump gas bounds WITHOUT the limit check — jumps
    never out-of-gas mid-branch; the successor's next instruction
    enforces the budget (matches the reference's enable_gas=False
    handlers)."""
    lo, hi = get_opcode_gas(opcode)
    state.mstate.min_gas_used += lo
    state.mstate.max_gas_used += hi


def _dest_index(frame: Frame, byte_addr: int):
    return get_instruction_index(frame.env.code.instruction_list, byte_addr)


@full("JUMP", gas=False, pc=False)
def _jump(frame: Frame):
    try:
        target = frame.concrete(frame.stack.pop())
    except TypeError:
        raise InvalidJumpDestination("symbolic jump target")
    except IndexError:
        raise StackUnderflowException()

    index = _dest_index(frame, target)
    if index is None:
        raise InvalidJumpDestination("jump into the void")
    if frame.env.code.instruction_list[index]["opcode"] != "JUMPDEST":
        raise InvalidJumpDestination(f"jump target {target} is not a JUMPDEST")

    landed = frame.fork().state
    _tally_jump_gas(landed, "JUMP")
    landed.mstate.pc = index
    landed.mstate.depth += 1
    return [landed]


@full("JUMPI", gas=False, pc=False)
def _jumpi(frame: Frame):
    target_word = frame.stack.pop()
    guard = frame.stack.pop()

    try:
        target = frame.concrete(target_word)
    except TypeError:
        # symbolic destination: not explored, fall through
        log.debug("JUMPI with a symbolic destination — falling through")
        _tally_jump_gas(frame.state, "JUMPI")
        frame.ms.pc += 1
        return [frame.state]

    if isinstance(guard, Bool):
        taken_cond = simplify(guard)
        skip_cond = simplify(Not(guard))
    else:
        taken_cond = guard != 0
        skip_cond = guard == 0

    def feasible(cond) -> bool:
        if isinstance(cond, bool):
            return cond
        return isinstance(cond, Bool) and not is_false(cond)

    branches = []
    # byte address of this JUMPI: the key the device prepass coverage
    # guide is indexed by (svm._device_precovered)
    src_addr = frame.here["address"]

    if feasible(skip_cond):
        fallthrough = frame.fork().state
        _tally_jump_gas(fallthrough, "JUMPI")
        fallthrough.mstate.pc += 1
        fallthrough.mstate.depth += 1
        fallthrough.world_state.constraints.append(skip_cond)
        fallthrough.branch_obs = (src_addr, False)
        branches.append(fallthrough)
    else:
        log.debug("JUMPI fall-through branch is unsatisfiable")

    index = _dest_index(frame, target)
    if index is None:
        log.debug("JUMPI target %s is outside the code", target)
        return branches
    if frame.env.code.instruction_list[index]["opcode"] == "JUMPDEST":
        if feasible(taken_cond):
            taken = frame.fork().state
            _tally_jump_gas(taken, "JUMPI")
            taken.mstate.pc = index
            taken.mstate.depth += 1
            taken.world_state.constraints.append(taken_cond)
            taken.branch_obs = (src_addr, True)
            branches.append(taken)
        else:
            log.debug("JUMPI taken branch is unsatisfiable")
    return branches


# ---------------------------------------------------------------------------
# logging (events are unmodeled; only the stack effect matters)
# ---------------------------------------------------------------------------
@full("LOG", writes=True)
def _log(frame: Frame):
    n_topics = int(frame.op[3:])
    for _ in range(2 + n_topics):
        frame.stack.pop()


# ---------------------------------------------------------------------------
# frame enders
# ---------------------------------------------------------------------------
@full("STOP")
def _stop(frame: Frame):
    frame.state.current_transaction.end(frame.state)


@full("RETURN")
def _return(frame: Frame):
    where, length = frame.pops_raw(2)
    if isinstance(length, BitVec) and length.symbolic:
        log.debug("RETURN with a symbolic length")
        payload = [frame.fresh("return_data", 8)]
    else:
        frame.ms.mem_extend(where, length)
        from mythril_tpu_torch.laser.ethereum.vm.core import enforce_gas_limit

        enforce_gas_limit(frame.state)
        payload = frame.memory[where : where + length]
    frame.state.current_transaction.end(frame.state, payload)


@full("REVERT")
def _revert(frame: Frame):
    where, length = frame.pops_raw(2)
    payload = [frame.fresh("return_data", 8)]
    try:
        payload = frame.memory[
            frame.concrete(where) : frame.concrete(where + length)
        ]
    except TypeError:
        log.debug("REVERT with symbolic bounds")
    frame.state.current_transaction.end(
        frame.state, return_data=payload, revert=True
    )


@full("SUICIDE", writes=True)
def _suicide(frame: Frame):
    heir = frame.stack.pop()
    estate = frame.env.active_account.balance()
    # the heir may be symbolic; the balances array accepts that
    frame.world.balances[heir] += estate

    from copy import copy as shallow

    corpse = shallow(frame.env.active_account)
    frame.env.active_account = corpse
    frame.state.accounts[corpse.address.value] = corpse
    corpse.set_balance(0)
    corpse.deleted = True
    frame.state.current_transaction.end(frame.state)


@full("INVALID")
def _invalid(frame: Frame):
    raise InvalidInstruction


@full("ASSERT_FAIL")
def _assert_fail(frame: Frame):
    # 0xfe — solc's designated invalid opcode for failed assertions
    raise InvalidInstruction
