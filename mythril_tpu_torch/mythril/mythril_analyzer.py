"""Facade: per-contract analysis orchestration.

The port's copy of the JAX package's mythril/mythril_analyzer.py
(reference: mythril/mythril/mythril_analyzer.py): it publishes the run
options to the global `args` bag, drives SymExecWrapper + fire_lasers
for each loaded contract with crash containment (a crashing contract
reports its traceback and salvages the callback issues already found),
overlaps a corpus of two or more contracts with the striped device
prepass (analysis/corpus.py `OverlappedPrepass`), and produces the
graph and statespace artifacts. `python -m mythril_tpu_torch analyze`
runs through it.

Where the port differs, and how it says so:

- the analyzer takes a `device` (None: the card, which must be there;
  "cpu" runs the plain versions of the kernels): the overlapped prepass,
  each walk's own device prepass and each walk's solver races run there.
  `device_prepass` "auto" runs the prepass on that device, as the port's
  SymExecWrapper does (the JAX "auto" runs it only on an accelerator
  backend);
- a failure of the overlapped prepass raises (`OverlappedPrepass`
  re-raises the thread's exception): no contract is walked without the
  card after it, and the witness merge (`_merge_prepass_issues`) raises
  where the JAX one logs at DEBUG and goes on;
- not ported, and refused with the module named rather than ignored:
  the verdict store's write-back (`store_dir` with `store`: store/) and
  the routing record (`_routing_record`: routing/, observe/routing.py),
  the device mesh (`mesh_devices > 1`), the host-first solver funnel
  (`device_first=False`), and `sparse_pruning` / `unconstrained_storage`,
  whose branches the port's host walk does not have. With no routing
  record there is no per-contract journey, so the report meta carries no
  `journeys` key; the solver attribution, the loss reasons, the captured
  query count and the degradation block are filled as in the JAX
  package;
- the port has no chain RPC client: the loader is `DynLoader(None,
  active=use_onchain_data)`, whose reads raise (support/loader.py);
- the pipelined schedule keeps the port's default, off (`pipeline`).
"""

from __future__ import annotations

import logging
import os
import traceback
from contextlib import nullcontext
from typing import List, Optional

from mythril_tpu_torch.analysis.callgraph import generate_graph
from mythril_tpu_torch.analysis.report import Issue, Report
from mythril_tpu_torch.analysis.security import fire_lasers, retrieve_callback_issues
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.analysis.traceexplore import get_serializable_statespace
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.exceptions import DeadlineExpiredError, DetectorNotFoundError
from mythril_tpu_torch.laser.execution_info import ExecutionInfo
from mythril_tpu_torch.laser.smt.solver import SolverStatistics
from mythril_tpu_torch.mythril.mythril_disassembler import MythrilDisassembler
from mythril_tpu_torch.support.accel import resolve_device
from mythril_tpu_torch.support.loader import DynLoader
from mythril_tpu_torch.support.source_support import Source
from mythril_tpu_torch.support.start_time import StartTime
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

CRASH_NOTICE = (
    "Exception occurred, aborting analysis. Please report this "
    "issue to the project's issue tracker.\n"
)


#: analyzer-local options and their defaults
_RUN_DEFAULTS = dict(
    use_onchain_data=True,
    strategy="dfs",
    address=None,
    max_depth=None,
    execution_timeout=None,
    loop_bound=None,
    create_timeout=None,
    disable_dependency_pruning=False,
    custom_modules_directory="",
    # deadline-aware supervision (support/resilience.py): a wall-clock
    # budget for the WHOLE run; on expiry the analyzer stops launching
    # contracts and either reports partial (with per-contract
    # completion status) or fails hard, per on_timeout
    deadline=None,
    on_timeout="partial",
    # solver query flight recorder (observe/querylog.py): when set,
    # every solved SMT query serializes into this directory as a
    # replayable artifact
    capture_queries=None,
)

#: options published to the global `args` bag for the deep layers
_GLOBAL_DEFAULTS = dict(
    parallel_solving=False,
    call_depth_limit=3,
    device_prepass="auto",
    device_solving="auto",
    device_prepass_budget=12.0,
    device_prepass_lanes=128,
    device_ownership="auto",
    deterministic_solving=False,
    static_prune=True,
    # the port's default: lock-step waves (a wave's loop holds the GIL)
    pipeline=False,
    specialize=True,
    # None = leave the flag bag as-is (the command line always passes
    # the explicit value)
    blockjit=None,
)

#: the JAX facade's options whose modules the port does not have:
#: (option, its default, the value test that asks for nothing, refusal)
_REFUSED = (
    ("sparse_pruning", False, lambda v: not v,
     "sparse_pruning: its branch of the host walk (laser/ethereum/svm.py) "
     "is not in the port"),
    ("unconstrained_storage", False, lambda v: not v,
     "unconstrained_storage: its branch of the host walk "
     "(laser/ethereum/state/account.py) is not in the port"),
    ("mesh_devices", None, lambda v: v is None or v <= 1,
     "mesh_devices > 1 needs the device mesh (parallel/mesh.py, "
     "topology.py, scheduler.py), which is not ported"),
    ("device_first", True, lambda v: bool(v),
     "device_first=False needs the host-first solver funnel, which is not "
     "in the port's explorer"),
)


class MythrilAnalyzer:
    """Runs the security analysis over the disassembler's contracts.

    Accepts the JAX facade's option set as keywords; anything in
    `_RUN_DEFAULTS` configures this analyzer, anything in
    `_GLOBAL_DEFAULTS` (plus enable_iprof / solver_timeout) is pushed
    into the global `args` bag for the deep layers. The refused options
    raise NotImplementedError before any flag is set."""

    def __init__(
        self,
        disassembler: MythrilDisassembler,
        requires_dynld: bool = False,
        enable_iprof: bool = False,
        solver_timeout: Optional[int] = None,
        device=None,
        **options,
    ):
        refused = [
            why
            for field, default, fine, why in _REFUSED
            if not fine(options.pop(field, default))
        ]
        store_dir = options.pop(
            "store_dir", os.environ.get("MYTHRIL_STORE_DIR") or None
        )
        if store_dir and options.pop("store", True):
            refused.append(
                f"the verdict store at {store_dir} needs store/store.py, "
                "which is not ported"
            )
        options.pop("store", None)
        if refused:
            raise NotImplementedError("; ".join(refused))
        self.device = resolve_device(device)
        self.eth = disassembler.eth
        self.contracts: List[EVMContract] = disassembler.contracts or []
        self.enable_online_lookup = disassembler.enable_online_lookup

        for field, default in _RUN_DEFAULTS.items():
            setattr(self, field, options.pop(field, default))
        for field, default in _GLOBAL_DEFAULTS.items():
            value = options.pop(field, default)
            if value is None and field == "blockjit":
                continue  # None = keep the bag's current value
            setattr(args, field, value)
        # the sprint cap keeps its default unless explicitly overridden
        sprint_cap_s = options.pop("sprint_cap_s", None)
        if sprint_cap_s is not None:
            args.sprint_cap_s = float(sprint_cap_s)
        if options:
            raise TypeError(f"unknown analyzer options: {sorted(options)}")

        args.iprof = enable_iprof
        if solver_timeout is not None:
            args.solver_timeout = solver_timeout
        # mirrored into the flag bag for observability (deep layers
        # consult resilience.run_deadline(), set in fire_lasers)
        args.run_deadline_s = self.deadline
        args.on_timeout = self.on_timeout

    # -- shared engine construction ------------------------------------
    def _symbolically_execute(self, contract, **overrides) -> SymExecWrapper:
        options = dict(
            dynloader=DynLoader(self.eth, active=self.use_onchain_data),
            max_depth=self.max_depth,
            execution_timeout=self.execution_timeout,
            create_timeout=self.create_timeout,
            disable_dependency_pruning=self.disable_dependency_pruning,
            custom_modules_directory=self.custom_modules_directory,
            device=self.device,
        )
        options.update(overrides)
        return SymExecWrapper(
            contract or self.contracts[0], self.address, self.strategy, **options
        )

    # -- artifacts -----------------------------------------------------
    def dump_statespace(self, contract: EVMContract = None) -> dict:
        """Serializable statespace of the contract."""
        sym = self._symbolically_execute(contract, run_analysis_modules=False)
        return get_serializable_statespace(sym)

    def graph_html(
        self,
        contract: EVMContract = None,
        enable_physics: bool = False,
        phrackify: bool = False,
        transaction_count: Optional[int] = None,
    ) -> str:
        """Interactive callgraph HTML."""
        sym = self._symbolically_execute(
            contract,
            transaction_count=transaction_count,
            run_analysis_modules=False,
        )
        return generate_graph(sym, physics=enable_physics, phrackify=phrackify)

    # -- the analysis run ----------------------------------------------
    def _corpus_prepass(self, transaction_count: Optional[int]):
        """The overlapped striped device prepass for multi-contract
        runs (analysis/corpus.py OverlappedPrepass): the card explores
        the whole corpus while this process analyzes contracts one by
        one. None when there is nothing to overlap (a single contract,
        or --device-prepass never)."""
        if len(self.contracts) < 2:
            return None
        if getattr(args, "device_prepass", "auto") == "never":
            return None
        from mythril_tpu_torch.analysis.corpus import OverlappedPrepass
        from mythril_tpu_torch.support import resilience

        return OverlappedPrepass(
            [
                (c.code or "", getattr(c, "creation_code", "") or "", c.name)
                for c in self.contracts
            ],
            self._prepass_address(),
            transaction_count or 2,
            execution_timeout=self.execution_timeout,
            ownership=getattr(args, "device_ownership", "auto") != "never",
            deadline=resilience.run_deadline(),
            device=self.device,
        )

    def _prepass_address(self) -> int:
        address = self.address
        if isinstance(address, str):
            return int(address, 16)
        if isinstance(address, int):
            return address
        from mythril_tpu_torch.laser.batch.explore import DEFAULT_ADDRESS

        return DEFAULT_ADDRESS

    def fire_lasers(
        self,
        modules: Optional[List[str]] = None,
        transaction_count: Optional[int] = None,
    ) -> Report:
        """Analyze every loaded contract; one contract crashing doesn't
        lose the others' findings. With several contracts, the striped
        device prepass overlaps the loop.

        The run is supervised (support/resilience.py): a deadline
        installs the process-global run deadline every solver query and
        wave loop clamps to, SIGINT/SIGTERM degrade to a graceful stop,
        and an expired budget yields a PARTIAL report — per-contract
        completion status plus degradation-reason counts in the meta —
        or a hard DeadlineExpiredError under on_timeout="fail"."""
        from mythril_tpu_torch import observe
        from mythril_tpu_torch.observe import querylog
        from mythril_tpu_torch.support import resilience

        SolverStatistics().enabled = True
        degradation_marker = resilience.DegradationLog().marker()
        if self.capture_queries:
            observe.configure_capture(self.capture_queries)
        solver_marker = observe.solver_marker()
        loss_marker = querylog.loss_marker()
        if self.deadline is not None:
            resilience.set_run_deadline(self.deadline)
        pre = None
        try:
            pre = self._corpus_prepass(transaction_count)
            with resilience.graceful_shutdown():
                (
                    collected,
                    crashes,
                    execution_info,
                    completion,
                ) = self._analyze_contracts(pre, modules, transaction_count)
        finally:
            # an exception escaping the loop (DetectorNotFoundError)
            # must not orphan the prepass thread on the card
            try:
                final = pre.finish() if pre is not None else {}
            finally:
                if self.deadline is not None:
                    resilience.clear_run_deadline()
        collected += self._merge_prepass_issues(final, collected)
        for i, status in enumerate(completion):
            outcome = final.get(i)
            if outcome is not None:
                status["device_complete"] = bool(outcome.get("device_complete"))

        # prime the source registry for the report
        Source().get_source_from_contracts_list(self.contracts)

        report = self._build_report(collected, crashes, execution_info)
        # per-run solver attribution (observe/solverstats.py): which
        # engine answered how many queries at what cost
        attribution = observe.solver_attribution(solver_marker)
        if attribution:
            report.meta["solver_attribution"] = attribution
        # the flight recorder's loss waterfall: why host-answered
        # queries were not device-answered (all verdicts + the
        # host-WON restriction), plus how many queries the capture
        # corpus banked this run
        losses = observe.loss_reasons(since=loss_marker)
        if losses:
            report.meta["solver_loss_reasons"] = losses
            report.meta["solver_loss_reasons_sat"] = observe.loss_reasons(
                since=loss_marker, verdict="sat"
            )
        if self.capture_queries:
            report.meta["captured_queries"] = observe.captured_total(
                since=loss_marker
            )
        reasons = resilience.DegradationLog().counts_since(degradation_marker)
        partial = any(not status["complete"] for status in completion)
        if reasons or partial:
            report.partial = partial
            report.degradation = {
                "reasons": reasons,
                "contracts": completion,
            }
        return report

    def _analyze_contracts(
        self,
        pre,
        modules: Optional[List[str]],
        transaction_count: Optional[int],
    ):
        """The per-contract host loop (crash-contained per contract),
        consulting the resilience supervisor at every contract
        boundary: an expired deadline or a delivered signal marks the
        remaining contracts skipped (partial report) or raises
        (on_timeout=fail) instead of running past the budget."""
        from mythril_tpu_torch.observe.spans import trace
        from mythril_tpu_torch.support import resilience
        from mythril_tpu_torch.support.phase_profile import PhaseProfile

        collected: List[Issue] = []
        crashes: List[str] = []
        execution_info: Optional[List[ExecutionInfo]] = None
        completion: List[dict] = []
        halt_reason: Optional[str] = None
        for index, contract in enumerate(self.contracts):
            if halt_reason is None:
                halt_reason = resilience.interrupted_reason()
            if halt_reason is not None:
                if self.on_timeout == "fail":
                    raise DeadlineExpiredError(
                        f"{len(self.contracts) - index} contract(s) "
                        f"unanalyzed at the deadline ({halt_reason})"
                    )
                resilience.DegradationLog().record(
                    resilience.DegradationReason.CONTRACT_SKIPPED,
                    site="analyzer",
                    detail=halt_reason,
                    contract=contract.name,
                )
                completion.append(
                    {
                        "contract": contract.name,
                        "complete": False,
                        "skipped": halt_reason,
                    }
                )
                continue
            StartTime()  # fresh discovery-time baseline per contract
            outcome, device_ok = (
                pre.outcome_for(index) if pre is not None else (None, True)
            )
            restore = None
            crashed = False
            if not device_ok:
                # the card belongs to the prepass thread; the injected
                # (possibly partial) outcome stands in for this
                # contract's own device prepass
                restore = (args.device_prepass, args.device_solving)
                args.device_prepass = "never"
                args.device_solving = "never"
            try:
                with trace("contract.analyze", contract=contract.name):
                    with pre.lock if pre is not None else nullcontext():
                        sym = self._symbolically_execute(
                            contract,
                            loop_bound=self.loop_bound,
                            transaction_count=transaction_count,
                            modules=modules,
                            compulsory_statespace=False,
                            prepass_outcome=outcome,
                        )
                        issues = fire_lasers(sym, modules)
                execution_info = sym.execution_info
            except DetectorNotFoundError:
                raise
            except KeyboardInterrupt:
                log.critical("Keyboard Interrupt")
                issues = retrieve_callback_issues(modules)
            except Exception:
                log.critical(CRASH_NOTICE + traceback.format_exc())
                issues = retrieve_callback_issues(modules)
                crashes.append(traceback.format_exc())
                crashed = True
            finally:
                if restore is not None:
                    args.device_prepass, args.device_solving = restore
            if pre is not None:
                pre.yield_lock()

            for issue in issues:
                issue.add_code_info(contract)
            collected += issues
            completion.append({"contract": contract.name, "complete": not crashed})
            log.info("Host phase profile: %s", PhaseProfile().as_dict())
        return collected, crashes, execution_info, completion

    def _merge_prepass_issues(self, final: dict, collected: List[Issue]) -> List[Issue]:
        """Witness issues the device banked for contracts the host walk
        missed (one issue per (address, swc-id) PER CONTRACT — two
        contracts may hold the same vulnerability at the same byte
        offset). A conversion that raises propagates."""
        from mythril_tpu_torch.analysis.prepass import witness_issues

        seen = {(issue.contract, issue.address, issue.swc_id) for issue in collected}
        extra: List[Issue] = []
        address = self._prepass_address()
        for i, contract in enumerate(self.contracts):
            outcome = final.get(i)
            if not outcome:
                continue
            for issue in witness_issues(contract, outcome, address):
                if (issue.contract, issue.address, issue.swc_id) in seen:
                    continue
                issue.add_code_info(contract)
                extra.append(issue)
        if extra:
            log.info(
                "Device prepass contributed %d issue(s) the host walk did not find",
                len(extra),
            )
        return extra

    def _build_report(self, collected, crashes, execution_info) -> Report:
        report = Report(
            contracts=self.contracts,
            exceptions=crashes,
            execution_info=execution_info,
        )
        for issue in collected:
            report.append_issue(issue)
        return report
