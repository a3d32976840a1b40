"""SWC-101: integer overflow / underflow.

Covers mythril/analysis/module/modules/integer.py. Arithmetic
pre-hooks annotate the result with the negated no-overflow predicate;
use-site hooks (SSTORE/JUMPI/CALL/RETURN) promote those taints into a
state annotation ("the wrapped value was actually used"); at
transaction end every collected wrap condition is solved against the
full path, with a satisfiability cache keyed on the overflowing state.
"""

from __future__ import annotations

import logging
from copy import copy
from math import ceil, log2
from typing import Callable, Dict, List, Set

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    DetectionModule,
    EntryPoint,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import (
    And,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    BitVec,
    Bool,
    Expression,
    If,
    Not,
    symbol_factory,
)

log = logging.getLogger(__name__)

REMEDIATION = (
    "It is possible to cause an integer overflow or underflow in the"
    " arithmetic operation. Prevent this by constraining inputs using"
    " the require() statement or use the OpenZeppelin SafeMath"
    " library for integer arithmetic operations. Refer to the"
    " transaction trace generated for this issue to reproduce the"
    " issue."
)


class OverUnderflowAnnotation:
    """Symbol annotation: this value may have wrapped around."""

    def __init__(
        self, overflowing_state: GlobalState, operator: str, constraint: Bool
    ) -> None:
        self.overflowing_state = overflowing_state
        self.operator = operator
        self.constraint = constraint

    def __deepcopy__(self, memodict={}):
        return copy(self)


class OverUnderflowStateAnnotation(StateAnnotation):
    """State annotation: wraps both possible and used on this path.

    The taint collection is an insertion-ordered identity set (a dict
    used for its keys): annotation objects hash by identity, so a
    plain `set` iterates in memory-address order — which varies run to
    run with allocator layout, letting a different taint win the
    per-address issue dedupe and drift the reported witness. Dict key
    order is insertion order: deterministic."""

    def __init__(self) -> None:
        self.overflowing_state_annotations: Dict[
            OverUnderflowAnnotation, None
        ] = {}

    def __copy__(self):
        twin = OverUnderflowStateAnnotation()
        twin.overflowing_state_annotations = copy(
            self.overflowing_state_annotations
        )
        return twin


def _flow_annotation(state: GlobalState) -> OverUnderflowStateAnnotation:
    existing = next(
        iter(state.get_annotations(OverUnderflowStateAnnotation)), None
    )
    if existing is not None:
        return existing
    fresh = OverUnderflowStateAnnotation()
    state.annotate(fresh)
    return fresh


def _word_at(stack, index) -> BitVec:
    """stack[index] as a BitVec, converting in place if needed."""
    value = stack[index]
    if isinstance(value, BitVec):
        return value
    if isinstance(value, Bool):
        return If(value, 1, 0)
    stack[index] = symbol_factory.BitVecVal(value, 256)
    return stack[index]


def _promote_taints(state: GlobalState, value) -> None:
    """Move wrap taints from a used value onto the state."""
    if not isinstance(value, Expression):
        return
    flow = _flow_annotation(state)
    for taint in value.annotations:
        if isinstance(taint, OverUnderflowAnnotation):
            flow.overflowing_state_annotations[taint] = None


class IntegerArithmetics(DetectionModule):
    """Searches for integer over- and underflows."""

    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = (
        "For every SUB instruction, check if there's a possible state "
        "where op1 > op0. For every ADD, MUL instruction, check if "
        "there's a possible state where op1 + op0 > 2^32 - 1"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD",
        "MUL",
        "EXP",
        "SUB",
        "SSTORE",
        "JUMPI",
        "STOP",
        "RETURN",
        "CALL",
    ]

    #: wrap predicates per arithmetic opcode
    WRAP_RULES = {
        "ADD": ("addition", lambda a, b: Not(BVAddNoOverflow(a, b, False))),
        "MUL": ("multiplication", lambda a, b: Not(BVMulNoOverflow(a, b, False))),
        "SUB": ("subtraction", lambda a, b: Not(BVSubNoUnderflow(a, b, False))),
    }

    def __init__(self) -> None:
        super().__init__()
        self._known_sat: Set[GlobalState] = set()
        self._known_unsat: Set[GlobalState] = set()

    def reset_module(self):
        super().reset_module()
        self._known_sat = set()
        self._known_unsat = set()

    # -- dispatch ------------------------------------------------------
    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        opcode = state.get_current_instruction()["opcode"]
        routes: Dict[str, List[Callable]] = {
            "ADD": [self._taint_arith],
            "SUB": [self._taint_arith],
            "MUL": [self._taint_arith],
            "EXP": [self._taint_exp],
            "SSTORE": [self._use_sstore],
            "JUMPI": [self._use_jumpi],
            "CALL": [self._use_call],
            "RETURN": [self._use_return, self._finalize],
            "STOP": [self._finalize],
        }
        for step in routes[opcode]:
            step(state)

    # -- taint producers -----------------------------------------------
    def _taint_arith(self, state: GlobalState) -> None:
        opcode = state.get_current_instruction()["opcode"]
        operator, predicate = self.WRAP_RULES[opcode]
        stack = state.mstate.stack
        a, b = _word_at(stack, -1), _word_at(stack, -2)
        a.annotate(OverUnderflowAnnotation(state, operator, predicate(a, b)))

    def _taint_exp(self, state: GlobalState) -> None:
        stack = state.mstate.stack
        base, power = _word_at(stack, -1), _word_at(stack, -2)
        if base.symbolic and power.symbolic:
            wraps = And(
                power > symbol_factory.BitVecVal(256, 256),
                base > symbol_factory.BitVecVal(1, 256),
            )
        elif power.symbolic:
            if base.value < 2:
                return
            wraps = power >= symbol_factory.BitVecVal(
                ceil(256 / log2(base.value)), 256
            )
        elif base.symbolic:
            if power.value == 0:
                return
            wraps = base >= symbol_factory.BitVecVal(
                2 ** ceil(256 / power.value), 256
            )
        else:
            wraps = base.value**power.value >= 2**256
        base.annotate(OverUnderflowAnnotation(state, "exponentiation", wraps))

    # -- taint consumers -----------------------------------------------
    @staticmethod
    def _use_sstore(state: GlobalState) -> None:
        _promote_taints(state, state.mstate.stack[-2])

    @staticmethod
    def _use_jumpi(state: GlobalState) -> None:
        _promote_taints(state, state.mstate.stack[-2])

    @staticmethod
    def _use_call(state: GlobalState) -> None:
        _promote_taints(state, state.mstate.stack[-3])

    @staticmethod
    def _use_return(state: GlobalState) -> None:
        """Taints reachable through the returned memory window."""
        stack = state.mstate.stack
        offset, length = stack[-1], stack[-2]
        for cell in state.mstate.memory[offset : offset + length]:
            _promote_taints(state, cell)

    # -- transaction end -----------------------------------------------
    def _finalize(self, state: GlobalState) -> None:
        from mythril_tpu_torch.analysis.prepass import device_already_proved

        for taint in _flow_annotation(state).overflowing_state_annotations:
            origin = taint.overflowing_state

            if origin in self._known_unsat:
                continue
            if device_already_proved(origin, INTEGER_OVERFLOW_AND_UNDERFLOW):
                # a device lane concretely wrapped at this site and
                # used the result; its banked witness carries the issue
                continue
            if origin not in self._known_sat:
                # cheap pre-check against the origin state's own path
                try:
                    solver.get_model(
                        origin.world_state.constraints + [taint.constraint]
                    )
                    self._known_sat.add(origin)
                except Exception:
                    self._known_unsat.add(origin)
                    continue

            log.debug(
                "Checking overflow in %s at transaction end address %s, "
                "ostate address %s",
                state.get_current_instruction()["opcode"],
                state.get_current_instruction()["address"],
                origin.get_current_instruction()["address"],
            )

            try:
                witness = solver.get_transaction_sequence(
                    state, state.world_state.constraints + [taint.constraint]
                )
            except UnsatError:
                continue

            issue = Issue(
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                title="Integer Arithmetic Bugs",
                severity="High",
                description_head="The arithmetic operator can {}.".format(
                    "underflow"
                    if taint.operator == "subtraction"
                    else "overflow"
                ),
                description_tail=REMEDIATION,
                gas_used=gas_range(state),
                transaction_sequence=witness,
                **found_at(origin),
            )
            self.cache.add(origin.get_current_instruction()["address"])
            self.issues.append(issue)


detector = IntegerArithmetics()
