"""LASER — the symbolic EVM engine.

Covers the reference engine's whole job (mythril/laser/ethereum/
svm.py: worklist scheduling, the multi-transaction driver, frame
enter/leave on call signals, hook surface, CFG capture) with a
different decomposition:

  * all hooks ride one `HookBus` (hooks.py) with batched opcode
    channels shared with the device engine;
  * CFG capture lives in `StateSpaceRecorder` (statespace.py);
  * frame transitions are explicit methods (`_enter_frame`,
    `_leave_frame`) keyed off the transaction signals instead of
    inline exception-handler bodies;
  * the step core returns an (outcome, successors) pair.

Layering note: `check_potential_issues` is imported lazily at its
single call site; the engine package stays importable without the
analysis layer (SURVEY.md §1 flags the reference's import knot).
"""

from __future__ import annotations

import logging
from abc import ABCMeta
from copy import copy
from datetime import datetime, timedelta
from typing import Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.ethereum.evm_exceptions import VmException
from mythril_tpu_torch.laser.ethereum.hooks import HookBus
from mythril_tpu_torch.laser.ethereum.instruction_data import (
    get_required_stack_elements,
)
from mythril_tpu_torch.laser.ethereum.instructions import Instruction, transfer_ether
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.statespace import StateSpaceRecorder
from mythril_tpu_torch.laser.ethereum.strategy.basic import DepthFirstSearchStrategy
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.laser.ethereum.transaction import (
    ContractCreationTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    execute_contract_creation,
    execute_message_call,
)
from mythril_tpu_torch.laser.execution_info import ExecutionInfo
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState, PluginSkipWorldState
from mythril_tpu_torch.laser.smt import symbol_factory
from mythril_tpu_torch.support.opcodes import OPCODES

log = logging.getLogger(__name__)


class SVMError(Exception):
    """Unexpected engine state."""


class LaserEVM:
    """Schedules path states, steps them one instruction at a time,
    and carries world states across transactions."""

    def __init__(
        self,
        dynamic_loader=None,
        max_depth=float("inf"),
        execution_timeout=60,
        create_timeout=10,
        strategy=DepthFirstSearchStrategy,
        transaction_count=2,
        requires_statespace=True,
        iprof=None,
    ) -> None:
        self.dynamic_loader = dynamic_loader
        self.max_depth = max_depth
        self.transaction_count = transaction_count
        self.execution_timeout = execution_timeout or 0
        self.create_timeout = create_timeout or 0
        self.iprof = iprof

        self.open_states: List[WorldState] = []
        self.total_states = 0
        self.execution_info: List[ExecutionInfo] = []

        self.work_list: List[GlobalState] = []
        self.strategy = strategy(self.work_list, max_depth)

        self.bus = HookBus()
        self.requires_statespace = requires_statespace
        self._recorder = StateSpaceRecorder(keep=requires_statespace)
        if requires_statespace:
            self.nodes = self._recorder.nodes
            self.edges = self._recorder.edges

        self.time: Optional[datetime] = None

        # device-prepass coverage guide: branch directions the device
        # explorer concretely executed for this runtime code. Forks
        # into this set skip their feasibility query — a concrete
        # execution is a stronger sat certificate than a solver call.
        # (Skipping defers pruning; issue verification still solves
        # full constraints.)
        from mythril_tpu_torch.support.phase_profile import PhaseProfile

        self._phases = PhaseProfile()

        self.device_covered: set = set()
        self.device_covered_bytecode: Optional[str] = None
        self.device_precovered_skips = 0

        log.info("LASER EVM initialized with dynamic loader: %s", dynamic_loader)

    def seed_device_coverage(self, covered: set, runtime_hex: str) -> None:
        """Install the device explorer's covered (pc, taken) set for
        `runtime_hex` (byte addresses, matching instruction addresses)."""
        self.device_covered = covered
        self.device_covered_bytecode = runtime_hex

    # ------------------------------------------------------------------
    # top-level drivers
    # ------------------------------------------------------------------
    def extend_strategy(self, extension: ABCMeta, *extension_args) -> None:
        self.strategy = extension(self.strategy, extension_args)

    def sym_exec(
        self,
        world_state: WorldState = None,
        target_address: int = None,
        creation_code: str = None,
        contract_name: str = None,
    ) -> None:
        """Run the whole analysis: either message calls against a
        preloaded account, or a creation transaction followed by
        message calls against the deployed contract."""
        against_existing = target_address is not None
        from_creation = creation_code is not None and contract_name is not None
        if against_existing == from_creation:
            raise ValueError("Symbolic execution started with invalid parameters")

        log.debug("Starting LASER execution")
        self.bus.emit("start_sym_exec")
        time_handler.start_execution(self.execution_timeout)
        self.time = datetime.now()

        if against_existing:
            self.open_states = [world_state]
            log.info("Starting message call transaction to %s", target_address)
            self._transaction_rounds(
                symbol_factory.BitVecVal(target_address, 256)
            )
        else:
            log.info("Starting contract creation transaction")
            deployed = execute_contract_creation(
                self, creation_code, contract_name, world_state=world_state
            )
            log.info(
                "Finished contract creation, found %d open states",
                len(self.open_states),
            )
            if not self.open_states:
                log.warning(
                    "No contract was created during the execution of contract "
                    "creation. Increase the resources for creation execution "
                    "(--max-depth or --create-timeout)"
                )
            self._transaction_rounds(deployed.address)

        log.info("Finished symbolic execution")
        if self.requires_statespace:
            log.info(
                "%d nodes, %d edges, %d total states",
                len(self.nodes),
                len(self.edges),
                self.total_states,
            )
        self.bus.emit("stop_sym_exec")

    def _transaction_rounds(self, address) -> None:
        """Fire `transaction_count` symbolic transactions at
        `address`, dropping provably-unreachable world states between
        rounds."""
        self.time = datetime.now()
        for round_no in range(self.transaction_count):
            if not self.open_states:
                break
            feasible = [
                ws for ws in self.open_states if ws.constraints.is_possible
            ]
            if len(feasible) < len(self.open_states):
                log.info(
                    "Pruned %d unreachable states",
                    len(self.open_states) - len(feasible),
                )
            self.open_states = feasible
            log.info(
                "Starting message call transaction, iteration: %d, "
                "%d initial states",
                round_no,
                len(feasible),
            )
            self.bus.emit("start_sym_trans")
            execute_message_call(self, address)
            self.bus.emit("stop_sym_trans")

    # ------------------------------------------------------------------
    # time budget
    # ------------------------------------------------------------------
    def _out_of_time(self, creating: bool) -> bool:
        if creating and self.open_states:
            budget = self.create_timeout
        else:
            budget = self.execution_timeout
        return (
            budget > 0
            and self.time + timedelta(seconds=budget) <= datetime.now()
        )

    # ------------------------------------------------------------------
    # the hot loop
    # ------------------------------------------------------------------
    def exec(self, create=False, track_gas=False) -> Optional[List[GlobalState]]:
        finals: List[GlobalState] = []
        for state in self.strategy:
            if self._out_of_time(create):
                log.debug("Hit the time budget, returning.")
                return finals + [state] if track_gas else None

            try:
                with self._phases.measure("step"):
                    successors, opcode = self.execute_state(state)
            except NotImplementedError:
                log.debug("Encountered an unimplemented instruction")
                continue

            with self._phases.measure("feasibility"):
                successors = [
                    s
                    for s in successors
                    if self._device_precovered(s)
                    or s.world_state.constraints.is_possible
                ]

            self._recorder.observe(opcode, successors)
            if successors:
                self.work_list.extend(successors)
            elif track_gas:
                finals.append(state)
            self.total_states += len(successors)
        return finals if track_gas else None

    def _device_precovered(self, state: GlobalState) -> bool:
        """True when this fork's branch direction was concretely
        executed by the device prepass on the same runtime code. The
        `branch_obs` tag is consumed here — it describes one fork
        decision, not the straight-line states that follow it."""
        obs = getattr(state, "branch_obs", None)
        if obs is None:
            return False
        del state.branch_obs
        if not self.device_covered or obs not in self.device_covered:
            return False
        code = getattr(state.environment, "code", None)
        if not self._device_code_matches(code):
            return False
        self.device_precovered_skips += 1
        from mythril_tpu_torch.laser.smt.solver.solver_statistics import (
            SolverStatistics,
        )

        SolverStatistics().device_cert_count += 1
        return True

    def _device_code_matches(self, code) -> bool:
        """Is this the runtime the device explored? One string compare
        per consumed fork tag (branch_obs), which is cheap enough to
        skip memoization and its id-reuse hazards."""
        bytecode = getattr(code, "bytecode", None)
        if isinstance(bytecode, str) and bytecode.startswith("0x"):
            bytecode = bytecode[2:]
        return bytecode == self.device_covered_bytecode

    def execute_state(
        self, state: GlobalState
    ) -> Tuple[List[GlobalState], Optional[str]]:
        """Advance one state by one instruction; returns (successors,
        opcode)."""
        self.bus.emit("execute_state", state)

        code = state.environment.code.instruction_list
        try:
            opcode = code[state.mstate.pc]["opcode"]
        except IndexError:
            # ran off the end of the code — implicit STOP
            self._settle_world_state(state)
            return [], None

        if len(state.mstate.stack) < get_required_stack_elements(opcode):
            shortfall = (
                "Stack Underflow Exception due to insufficient "
                "stack elements for the address {}".format(
                    code[state.mstate.pc]["address"]
                )
            )
            successors = self._abort_frame(state, opcode, shortfall)
            return self.bus.emit_opcode("post", opcode, successors), opcode

        try:
            self.bus.emit(("pre", opcode), state)
        except PluginSkipState:
            self._settle_world_state(state)
            return [], None

        try:
            successors = self._step(opcode, state)
        except VmException as failure:
            successors = self._abort_frame(state, opcode, str(failure))
        except TransactionStartSignal as call:
            return [self._enter_frame(call, state)], opcode
        except TransactionEndSignal as ret:
            successors = self._leave_frame(ret, opcode, state)

        return self.bus.emit_opcode("post", opcode, successors), opcode

    def _step(self, opcode: str, state: GlobalState) -> List[GlobalState]:
        return Instruction(
            opcode,
            self.dynamic_loader,
            pre_hooks=self.bus.subscribers(("instr:pre", opcode)),
            post_hooks=self.bus.subscribers(("instr:post", opcode)),
        ).evaluate(state)

    # ------------------------------------------------------------------
    # frame transitions
    # ------------------------------------------------------------------
    def _enter_frame(
        self, call: TransactionStartSignal, caller_state: GlobalState
    ) -> GlobalState:
        """Push the callee frame for a CALL/CREATE-family signal."""
        callee = call.transaction.initial_global_state()
        callee.transaction_stack = copy(caller_state.transaction_stack) + [
            (call.transaction, caller_state)
        ]
        callee.node = caller_state.node
        callee.world_state.constraints = (
            call.global_state.world_state.constraints
        )
        transfer_ether(
            callee,
            call.transaction.caller,
            call.transaction.callee_account.address,
            call.transaction.call_value,
        )
        log.debug("Starting new transaction %s", call.transaction)
        return callee

    def _leave_frame(
        self,
        ret: TransactionEndSignal,
        opcode: str,
        state: GlobalState,
    ) -> List[GlobalState]:
        """Unwind one frame on RETURN/STOP/REVERT/SELFDESTRUCT."""
        transaction, caller_state = ret.global_state.transaction_stack[-1]
        log.debug("Ending transaction %s.", transaction)

        if caller_state is None:
            # outermost frame: this transaction is complete
            produced_code = (
                not isinstance(transaction, ContractCreationTransaction)
                or transaction.return_data
            )
            if produced_code and not ret.revert:
                from mythril_tpu_torch.analysis.potential_issues import (
                    check_potential_issues,
                )

                check_potential_issues(state)
                ret.global_state.world_state.node = state.node
                self._settle_world_state(ret.global_state)
            return []

        # nested frame: resume the caller
        self.bus.emit_opcode("post", opcode, [ret.global_state])
        caller_state.add_annotations(
            [a for a in state.annotations if a.persist_over_calls]
        )
        return self._resume_caller(
            copy(caller_state),
            state,
            reverted=ret.revert,
            returned=transaction.return_data,
        )

    def _resume_caller(
        self,
        caller_state: GlobalState,
        callee_state: GlobalState,
        reverted: bool,
        returned,
    ) -> List[GlobalState]:
        """Merge the callee's effects into the caller and re-run the
        call opcode in resume mode (`<op>/post`)."""
        caller_state.world_state.constraints += (
            callee_state.world_state.constraints
        )
        opcode = caller_state.environment.code.instruction_list[
            caller_state.mstate.pc
        ]["opcode"]
        caller_state.last_return_data = returned

        if not reverted:
            caller_state.world_state = copy(callee_state.world_state)
            caller_state.environment.active_account = callee_state.accounts[
                caller_state.environment.active_account.address.value
            ]
            if isinstance(
                callee_state.current_transaction, ContractCreationTransaction
            ):
                caller_state.mstate.min_gas_used += (
                    callee_state.mstate.min_gas_used
                )
                caller_state.mstate.max_gas_used += (
                    callee_state.mstate.max_gas_used
                )

        resumed = Instruction(
            opcode,
            self.dynamic_loader,
            pre_hooks=self.bus.subscribers(("instr:pre", opcode)),
            post_hooks=self.bus.subscribers(("instr:post", opcode)),
        ).evaluate(caller_state, True)
        for s in resumed:
            s.node = callee_state.node
        return resumed

    def _abort_frame(
        self, state: GlobalState, opcode: str, why: str
    ) -> List[GlobalState]:
        """Exceptional halt: discard the frame's effects; a nested
        frame resumes its caller with revert semantics."""
        _, caller_state = state.transaction_stack.pop()
        if caller_state is None:
            log.debug("VmException on the outermost frame: `%s`", why)
            return []
        self.bus.emit_opcode("post", opcode, [state])
        return self._resume_caller(
            caller_state, state, reverted=True, returned=None
        )

    def handle_vm_exception(
        self, global_state: GlobalState, op_code: str, error_msg: str
    ) -> List[GlobalState]:
        # historical name, kept for API compatibility
        return self._abort_frame(global_state, op_code, error_msg)

    def _settle_world_state(self, state: GlobalState) -> None:
        """Promote a finished transaction's world state into the open
        set unless a pruner vetoes it."""
        try:
            self.bus.emit("add_world_state", state)
        except PluginSkipWorldState:
            return
        self.open_states.append(state.world_state)

    # kept under its historical name for plugins/tests
    def _add_world_state(self, global_state: GlobalState) -> None:
        self._settle_world_state(global_state)

    # ------------------------------------------------------------------
    # hook registration (public surface, unchanged)
    # ------------------------------------------------------------------
    def register_hooks(self, hook_type: str, hook_dict: Dict[str, List[Callable]]):
        if hook_type not in ("pre", "post"):
            raise ValueError(
                "Invalid hook type %s. Must be one of {pre, post}" % hook_type
            )
        for opcode, fns in hook_dict.items():
            self.bus.extend((hook_type, opcode), fns)

    def register_laser_hooks(self, hook_type: str, hook: Callable):
        if hook_type not in (
            "add_world_state",
            "execute_state",
            "start_sym_exec",
            "stop_sym_exec",
            "start_sym_trans",
            "stop_sym_trans",
        ):
            raise ValueError(f"Invalid hook type {hook_type}")
        self.bus.on(hook_type, hook)

    def register_instr_hooks(
        self, hook_type: str, opcode: Optional[str], hook: Callable
    ):
        """Per-instruction hooks; opcode None fans the factory form
        `hook(op)` out over the whole table."""
        phase = f"instr:{hook_type}"
        if opcode is None:
            for op in OPCODES:
                self.bus.on((phase, op), hook(op))
        else:
            self.bus.on((phase, opcode), hook)

    def instr_hook(self, hook_type, opcode) -> Callable:
        def wrap(fn: Callable):
            self.register_instr_hooks(hook_type, opcode, fn)

        return wrap

    def laser_hook(self, hook_type: str) -> Callable:
        def wrap(fn: Callable):
            self.register_laser_hooks(hook_type, fn)
            return fn

        return wrap

    def pre_hook(self, op_code: str) -> Callable:
        def wrap(fn: Callable):
            self.bus.on(("pre", op_code), fn)
            return fn

        return wrap

    def post_hook(self, op_code: str) -> Callable:
        def wrap(fn: Callable):
            self.bus.on(("post", op_code), fn)
            return fn

        return wrap
