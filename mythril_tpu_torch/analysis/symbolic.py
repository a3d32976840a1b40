"""SymExecWrapper: configure and run LASER for one analysis.

The port's copy of the JAX package's analysis/symbolic.py (reference:
mythril/analysis/symbolic.py): strategy selection, the bounded-loops
extension, plugin loading, actor accounts, detection-module hook
registration, the device prepass, running `sym_exec`, and pre-digesting
the statespace's CALL operations for POST modules.

It differs from the JAX package in three places. The wrapper takes a
`device` (None: the card): the device prepass explores there, and every
solver query of the walk races there (`support.model.solver_device`).
A static pre-screen (analysis/static) that raises mounts every module,
as in the JAX package, but is recorded in the DegradationLog
(`static-prepass-failed`) rather than logged at DEBUG. A prepass that
raises propagates: the walk does not quietly go on without the card.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Set, Union

from mythril_tpu_torch.analysis.module import (
    EntryPoint,
    ModuleLoader,
    get_detection_module_hooks,
)
from mythril_tpu_torch.analysis.ops import Call, VarType, get_variable
from mythril_tpu_torch.laser.ethereum import svm
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.strategy.basic import (
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
)
from mythril_tpu_torch.laser.ethereum.strategy.extensions.bounded_loops import (
    BoundedLoopsStrategy,
)
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.execution_info import ExecutionInfo
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.laser.plugin.plugins import (
    CallDepthLimitBuilder,
    CoveragePluginBuilder,
    DependencyPrunerBuilder,
    InstructionProfilerBuilder,
    MutationPrunerBuilder,
)
from mythril_tpu_torch.laser.smt import BitVec, symbol_factory
from mythril_tpu_torch.support.model import solver_device
from mythril_tpu_torch.support.resilience import DegradationLog, DegradationReason
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

STRATEGIES = {
    "dfs": DepthFirstSearchStrategy,
    "bfs": BreadthFirstSearchStrategy,
    "naive-random": ReturnRandomNaivelyStrategy,
    "weighted-random": ReturnWeightedRandomStrategy,
}

CALL_OPS = ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL")


class DeviceExplorationInfo(ExecutionInfo):
    """Device-prepass counters, surfaced in jsonv2 execution info."""

    def __init__(self, stats: dict) -> None:
        self.stats = stats

    def as_dict(self):
        return {"device_symbolic_prepass": self.stats}


class StaticAnalysisInfo(ExecutionInfo):
    """Static-prepass counters (analysis/static), surfaced in the
    jsonv2 report meta: CFG/prune stats plus the detector screen."""

    def __init__(self, stats: dict) -> None:
        self.stats = stats

    def as_dict(self):
        return {"static_analysis": self.stats}


def _as_address_term(address: Union[int, str, BitVec]) -> BitVec:
    if isinstance(address, str):
        address = int(address, 16)
    if isinstance(address, int):
        address = symbol_factory.BitVecVal(address, 256)
    return address


class SymExecWrapper:
    """Symbolically executes a contract and pre-digests the statespace
    for the analysis layer."""

    def __init__(
        self,
        contract,
        address: Union[int, str, BitVec],
        strategy: str,
        dynloader=None,
        max_depth: int = 22,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        custom_modules_directory: str = "",
        prepass_outcome: Optional[dict] = None,
        device=None,
    ):
        # fresh per-contract solver session: the blast store shares
        # structure within one analysis but would tax the next contract
        from mythril_tpu_torch.analysis.prepass import reset_proven
        from mythril_tpu_torch.laser.smt.solver.solver import reset_blast_session
        from mythril_tpu_torch.support.phase_profile import PhaseProfile

        reset_blast_session()
        PhaseProfile().reset()
        reset_proven()  # device witnesses never outlive their contract

        if strategy not in STRATEGIES:
            raise ValueError("Invalid strategy argument supplied")
        address = _as_address_term(address)

        self.dynloader = dynloader
        deploys = bool(getattr(contract, "creation_code", None))

        requires_statespace = (
            compulsory_statespace
            or len(ModuleLoader().get_detection_modules(EntryPoint.POST, modules)) > 0
        )

        self.accounts = self._actor_accounts(include_creator=deploys)
        self.laser = svm.LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            strategy=STRATEGIES[strategy],
            create_timeout=create_timeout,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
        )
        if loop_bound is not None:
            self.laser.extend_strategy(BoundedLoopsStrategy, loop_bound)

        # the static prepass (analysis/static): CFG + dataflow once
        # per code hash, detector pre-screen BEFORE any hook mounts
        self.static_summary = None
        self.static_screen: Optional[Set[str]] = None
        self._static_prescreen(contract, deploys)

        self._mount_plugins(disable_dependency_pruning)
        if run_analysis_modules:
            self._mount_detectors(modules)

        world_state = WorldState()
        for account in self.accounts.values():
            world_state.put_account(account)

        self.device = device
        self._injected_outcome = prepass_outcome
        self.device_exploration = self._device_prepass(
            contract, address, execution_timeout
        )

        with solver_device(device):
            if deploys:
                self.laser.sym_exec(
                    creation_code=contract.creation_code,
                    contract_name=contract.name,
                    world_state=world_state,
                )
            else:
                world_state.put_account(
                    self._target_account(contract, address, world_state)
                )
                self.laser.sym_exec(
                    world_state=world_state, target_address=address.value
                )

        if requires_statespace:
            self.nodes = self.laser.nodes
            self.edges = self.laser.edges
            self.calls = list(self._digest_calls())

    # -- static prepass -------------------------------------------------
    def _static_prescreen(self, contract, deploys: bool) -> None:
        """Run the host-side static pass (cached by code hash) and
        derive the detector screen: modules whose opcode signature
        cannot fire on this code are never mounted and never run their
        POST pass (analysis/static/screen.py).

        Screening is skipped when on-chain loading is active (a
        DELEGATECALL into foreign code executes opcodes this
        contract's bytecode does not contain) and when the user
        passed --no-static-prune."""
        if not getattr(args, "static_prune", True):
            return
        if self.dynloader is not None and getattr(
            self.dynloader, "active", False
        ):
            return
        runtime = getattr(contract, "code", "") or ""
        if len(runtime) < 4:
            return
        try:
            from mythril_tpu_torch.analysis.static import (
                screen_modules,
                summary_for,
            )

            self.static_summary = summary_for(runtime)
            if deploys:
                # creation code executes under the same hooks; its
                # linear sweep over-approximates (embedded runtime
                # decodes as instructions), which only ADDS features,
                # conservative in the right direction. The semantic
                # sink predicates only hold for the runtime body, so a
                # deploying analysis screens on opcodes alone.
                features = set(self.static_summary.features)
                features |= summary_for(
                    getattr(contract, "creation_code", "") or ""
                ).features
                applicable, skipped = screen_modules(features)
            else:
                # runtime-only: the semantic screen (opcode signature
                # AND the taint/value-set sink predicate) decides
                applicable, skipped = (
                    self.static_summary.applicable_modules()
                )
            self.static_screen = set(applicable)
            stats = self.static_summary.stats()
            stats["modules_skipped"] = sorted(skipped)
            self.laser.execution_info.append(StaticAnalysisInfo(stats))
            if skipped:
                log.info(
                    "Static pre-screen: %d/%d detection modules "
                    "applicable (skipped: %s)",
                    len(applicable),
                    len(applicable) + len(skipped),
                    ", ".join(sorted(skipped)),
                )
        except Exception as why:
            self.static_summary = None
            self.static_screen = None
            DegradationLog().record(
                DegradationReason.STATIC_PREPASS_FAILED,
                site="walk",
                detail=f"{type(why).__name__}: {why}; all modules mount",
                contract=getattr(contract, "name", "") or "",
            )

    # -- device symbolic prepass ----------------------------------------
    def _device_prepass(self, contract, address: BitVec, execution_timeout):
        """Explore the contract's runtime code with the device
        symbolic engine before the host walk (arena + portfolio; see
        laser/batch/explore.py), on the wrapper's device, unless an
        outcome was injected (the corpus prepass explored it already) or
        `args.device_prepass` is "never".

        The prepass is not a warmup: its results drive the analysis.
        Trigger witnesses become concrete Issues (analysis/prepass.py)
        and the covered branch-direction set lets the host walk skip
        per-fork feasibility queries the device already has a concrete
        execution for (svm.py). A failure raises."""
        self.device_issues = []
        runtime = getattr(contract, "code", "") or ""
        if runtime.startswith("0x"):
            runtime = runtime[2:]

        outcome = self._injected_outcome
        if outcome is None:
            if getattr(args, "device_prepass", "auto") == "never":
                return None
            if len(runtime) < 8:
                return None

            # bounded by wall clock: waves stop at a coverage plateau or
            # when the budget can't fit another wave. Tiny analysis
            # timeouts skip the prepass outright: even a warm wave would
            # eat a meaningful slice of them.
            budget = float(getattr(args, "device_prepass_budget", 12.0))
            if execution_timeout:
                if execution_timeout < 6:
                    return None
                budget = min(budget, execution_timeout / 3.0)
            from mythril_tpu_torch.laser.batch.explore import (
                DeviceSymbolicExplorer,
                required_calldata_len,
            )

            outcome = DeviceSymbolicExplorer(
                runtime,
                calldata_len=required_calldata_len(runtime),
                lanes=int(getattr(args, "device_prepass_lanes", 128)),
                waves=8,
                steps_per_wave=512,
                budget_s=budget,
                address=address.value,
                transaction_count=self.laser.transaction_count,
                # with on-chain loading, foreign accounts may carry
                # code: CALLs must hand off to the host engine
                empty_world=not (
                    self.dynloader is not None
                    and getattr(self.dynloader, "active", False)
                ),
                device=self.device,
            ).run()

        from mythril_tpu_torch.support.phase_profile import PhaseProfile

        stats = outcome["stats"]
        if self._injected_outcome is None:
            # an injected outcome's wall was paid once for the whole
            # corpus; only an in-line exploration bills this contract
            PhaseProfile().add("prepass", stats.get("wall_s", 0.0))
        from mythril_tpu_torch.analysis.prepass import (
            register_proven,
            witness_issues,
        )

        self.device_issues = witness_issues(contract, outcome, address.value)
        # the host modules skip their concretization solve at addresses
        # the device already holds a witness for
        register_proven(self.device_issues, runtime)
        stats["witness_issues"] = len(self.device_issues)

        log.info(
            "Device symbolic prepass: %d device steps over %d waves in "
            "%.1fs, %d arena nodes, %d/%d flips feasible (%d sat on "
            "device), %d branch directions covered, %d witness issues",
            stats["device_steps"],
            stats["waves"],
            stats["wall_s"],
            stats["arena_nodes"],
            stats["forks_feasible"],
            stats["forks_tried"],
            stats["device_sat"],
            stats["branches_covered"],
            stats["witness_issues"],
        )
        self.laser.execution_info.append(DeviceExplorationInfo(stats))
        # hand the host walk the concretely-executed branch directions:
        # forks into this set skip their feasibility query (the device
        # holds a concrete witness for the direction)
        self.laser.seed_device_coverage(
            {tuple(b) for b in outcome["covered_branches"]}, runtime
        )
        return outcome

    # -- setup pieces --------------------------------------------------
    @staticmethod
    def _actor_accounts(include_creator: bool) -> dict:
        accounts = {
            hex(ACTORS.attacker.value): Account(
                hex(ACTORS.attacker.value),
                "",
                dynamic_loader=None,
                contract_name=None,
            )
        }
        if include_creator:
            accounts[hex(ACTORS.creator.value)] = Account(
                hex(ACTORS.creator.value),
                "",
                dynamic_loader=None,
                contract_name=None,
            )
        return accounts

    def _mount_plugins(self, disable_dependency_pruning: bool) -> None:
        loader = LaserPluginLoader()
        loader.load(CoveragePluginBuilder())
        loader.load(MutationPrunerBuilder())
        loader.load(CallDepthLimitBuilder())
        if args.iprof:
            loader.load(InstructionProfilerBuilder())
        loader.add_args("call-depth-limit", call_depth_limit=args.call_depth_limit)
        if not disable_dependency_pruning:
            loader.load(DependencyPrunerBuilder())
        loader.instrument_virtual_machine(self.laser, None)

    def _mount_detectors(self, modules: Optional[List[str]]) -> None:
        detectors = ModuleLoader().get_detection_modules(
            EntryPoint.CALLBACK, modules
        )
        if self.static_screen is not None:
            # the pre-screen: a module whose opcode signature cannot
            # fire on this code never mounts its hooks (the svm pays
            # hook dispatch per executed instruction)
            detectors = [
                d
                for d in detectors
                if type(d).__name__ in self.static_screen
            ]
        for phase in ("pre", "post"):
            self.laser.register_hooks(
                hook_type=phase,
                hook_dict=get_detection_module_hooks(detectors, hook_type=phase),
            )

    def _target_account(self, contract, address: BitVec, world_state) -> Account:
        loader = self.dynloader
        account = Account(
            address,
            contract.disassembly,
            dynamic_loader=loader,
            contract_name=contract.name,
            balances=world_state.balances,
            concrete_storage=bool(loader is not None and loader.active),
        )
        if loader is not None:
            try:
                account.set_balance(
                    loader.read_balance("{0:#0{1}x}".format(address.value, 42))
                )
            except Exception:
                pass  # balance stays symbolic
        return account

    # -- statespace digestion ------------------------------------------
    def _digest_calls(self):
        """Yield a `Call` record for every CALL-family state in the
        statespace (input to the POST analysis modules)."""
        for node in self.nodes.values():
            for state_index, state in enumerate(node.states):
                try:
                    op = state.get_current_instruction()["opcode"]
                except IndexError:
                    continue
                if op not in CALL_OPS:
                    continue
                stack = state.mstate.stack
                gas = get_variable(stack[-1])
                to = get_variable(stack[-2])

                if op in ("CALL", "CALLCODE"):
                    value = get_variable(stack[-3])
                    mem_start = get_variable(stack[-4])
                    mem_size = get_variable(stack[-5])
                    if to.type == VarType.CONCRETE and 0 < to.val <= PRECOMPILE_COUNT:
                        continue  # precompile call, not interesting
                    if (
                        mem_start.type == VarType.CONCRETE
                        and mem_size.type == VarType.CONCRETE
                    ):
                        payload = state.mstate.memory[
                            mem_start.val : mem_start.val + mem_size.val
                        ]
                        yield Call(
                            node, state, state_index, op, to, gas, value, payload
                        )
                    else:
                        yield Call(node, state, state_index, op, to, gas, value)
                else:
                    yield Call(node, state, state_index, op, to, gas)

    @property
    def execution_info(self) -> List[ExecutionInfo]:
        return self.laser.execution_info
