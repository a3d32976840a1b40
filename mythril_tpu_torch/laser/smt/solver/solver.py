"""Solver / Optimize: the word-level SMT entry points.

The port's copy of the JAX package's laser/smt/solver/solver.py. What
differs: the race grace is PORTFOLIO_DEFAULTS' alone (no
MYTHRIL_RACE_GRACE_MS override); the device race and the
--parallel-solving escape run the port's portfolio on the `device` the
caller names (`Solver`, `Optimize`, `check_terms` and `get_model` take
it: None means the card and raises where there is none, "cpu" runs the
plain portfolio); the race has no off switch (the JAX package's
`args.device_solving`): it starts wherever no exploration holds the
card (`device_race.race_available`), which no caller of the port's
reaches yet (device_race.py); and the race's errors are counted, never
swallowed (device_race.py).
The statistics are plain in-process counters (solver_statistics.py,
observe/solverstats.py).

Reference parity: mythril/laser/smt/solver/solver.py:16-105 (`Solver`
with timeout + add/check/model, `Optimize` with minimize/maximize).
The engine differs by design: instead of z3's C++ stack the pipeline
is  lower (preprocess.py) → bit-blast (bitblast.py) → native CDCL
(native/host/cdcl.cpp),  with every SAT model verified against the
original constraints by concrete evaluation before it is returned —
an end-to-end soundness check z3 users get implicitly.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.bool import Bool
from mythril_tpu_torch.laser.smt.bitvec import BitVec
from mythril_tpu_torch.laser.smt.evalterm import eval_term
from mythril_tpu_torch.laser.smt.model import Model
from mythril_tpu_torch.laser.smt.solver import native_sat
from mythril_tpu_torch.laser.smt.solver.bitblast import NativeBlaster
from mythril_tpu_torch.laser.smt.solver.preprocess import Recon, lower
from mythril_tpu_torch.laser.smt.solver.solver_statistics import (
    SolverStatistics,
    stat_smt_query,
)

sat = "sat"
unsat = "unsat"
unknown = "unknown"


class BaseSolver:
    def __init__(self, timeout: int = 10_000, device=None):
        self.timeout = timeout  # milliseconds, reference default 10s
        # where a race or the --parallel-solving escape searches
        # (None: the card)
        self.device = device
        self.constraints: List[terms.Term] = []
        self._model: Optional[Model] = None

    def set_timeout(self, timeout: int) -> None:
        self.timeout = timeout

    def add(self, *constraints) -> None:
        self.constraints.extend(self._norm(constraints))

    append = add

    @staticmethod
    def _norm(constraints) -> List[terms.Term]:
        out: List[terms.Term] = []
        for c in constraints:
            if isinstance(c, (list, tuple)):
                out.extend(BaseSolver._norm(c))
            elif isinstance(c, Bool):
                out.append(c.raw)
            elif isinstance(c, terms.Term):
                out.append(c)
            elif isinstance(c, bool):
                out.append(terms.bool_const(c))
            else:
                raise TypeError(f"cannot add {type(c)} as constraint")
        return out

    def model(self) -> Model:
        if self._model is None:
            raise ValueError("no model available (last check was not sat)")
        return self._model

    # ------------------------------------------------------------------
    @stat_smt_query
    def check(self, *extra) -> str:
        # extras are assumptions scoped to this call (z3 semantics);
        # they are NOT persisted into self.constraints
        self._model = None
        status, model = check_terms(
            self.constraints + self._norm(extra), timeout_ms=self.timeout,
            device=self.device,
        )
        if status == sat:
            self._model = model
        return status


class Solver(BaseSolver):
    """A solver object with the reference Solver's interface."""


class Optimize(BaseSolver):
    """Solver with min/max objectives, via binary search on the bound.

    Reference parity: mythril/laser/smt/solver/solver.py `Optimize`
    (z3.Optimize); used by analysis/solver.py to minimize calldatasize
    and callvalue when concretizing transaction sequences.
    """

    def __init__(self, timeout: int = 10_000, device=None):
        super().__init__(timeout=timeout, device=device)
        self.objectives: List[(terms.Term, bool)] = []

    def minimize(self, element: BitVec) -> None:
        self.objectives.append((element.raw, True))

    def maximize(self, element: BitVec) -> None:
        self.objectives.append((element.raw, False))

    #: fixed per-step budgets and emergency aggregate stop for
    #: objective refinement. These are deliberately NOT derived from
    #: the analysis' remaining execution time: a load-dependent
    #: refinement deadline made the minimized witness (e.g. the
    #: reported calldata length) vary run to run — the refinement
    #: schedule must be a pure function of the query. Steps are
    #: conflict-budgeted (deterministic); the ms value is only the
    #: wall valve, sized so a typical step's conflicts finish far
    #: inside it.
    REFINE_STEP_CONFLICTS = 250_000
    REFINE_STEP_MS = 10_000
    REFINE_EMERGENCY_S = 10.0

    @stat_smt_query
    def check(self, *extra) -> str:
        base = self.constraints + self._norm(extra)
        self._model = None
        caller_deadline = time.monotonic() + self.timeout / 1000.0
        status, model = check_terms(base, timeout_ms=self.timeout, device=self.device)
        if status != sat:
            return status
        # refine objectives one at a time (lexicographic, like z3's default)
        constraints = list(base)
        for obj, is_min in self.objectives:
            model = self._refine(
                constraints, obj, is_min, model, caller_deadline, device=self.device
            )
            constraints.append(
                terms.eq(obj, terms.bv_const(eval_term(obj, model.assignment), obj.width))
            )
        self._model = model
        return sat

    @classmethod
    def _refine(
        cls,
        constraints: List[terms.Term],
        obj: terms.Term,
        is_min: bool,
        model: Model,
        caller_deadline: float,
        device=None,
    ) -> Model:
        """Binary search the objective value downward (or upward).

        Default mode respects the caller's wall deadline (the query
        timeout, itself clamped to the analysis' remaining execution
        budget). Under --deterministic-solving the schedule is instead
        a pure function of the query — convergence under an iteration
        cap with fixed conflict-budgeted steps — so the minimized
        witness cannot vary with machine load; the fixed emergency
        stop then only exists for pathological objectives and is
        enforced BETWEEN steps (the loop-head deadline check), never
        inside one — a step's wall valve stays the fixed
        REFINE_STEP_MS, because a load-clamped valve would let a slow
        conflict rate cut a step short and reintroduce exactly the
        run-to-run witness drift this mode exists to prevent. An
        objective overruns the emergency stop by at most one full
        step."""
        from mythril_tpu_torch.support.support_args import args as _args

        deterministic = _args.deterministic_solving
        deadline = (
            time.monotonic() + cls.REFINE_EMERGENCY_S
            if deterministic
            else caller_deadline
        )
        best = eval_term(obj, model.assignment)
        lo, hi = (0, best) if is_min else (best, (1 << obj.width) - 1)
        iters = 0
        while lo < hi and iters <= obj.width + 2:
            if time.monotonic() >= deadline:
                break
            iters += 1
            mid = (lo + hi) // 2 if is_min else (lo + hi + 1) // 2
            bound = (
                terms.ule(obj, terms.bv_const(mid, obj.width))
                if is_min
                else terms.ule(terms.bv_const(mid, obj.width), obj)
            )
            if deterministic:
                step_ms = cls.REFINE_STEP_MS
                step_conflicts = cls.REFINE_STEP_CONFLICTS
            else:
                step_ms = max(
                    100, int((deadline - time.monotonic()) * 1000)
                )
                step_conflicts = None
            status, candidate = check_terms(
                constraints + [bound],
                timeout_ms=step_ms,
                conflict_budget=step_conflicts,
                device=device,
            )
            if status == sat:
                model = candidate
                best = eval_term(obj, candidate.assignment)
                if is_min:
                    hi = min(mid, best)
                else:
                    lo = max(mid, best)
            elif status == unsat:
                if is_min:
                    lo = mid + 1
                else:
                    hi = mid - 1
            else:  # unknown: stop refining, keep best so far
                break
        return model


# ---------------------------------------------------------------------------
# the core check pipeline
# ---------------------------------------------------------------------------


# Persistent solver session: gate clauses are pure Tseitin definitions
# (they constrain nothing until a root literal is asserted), so the
# blast store grows monotonically across queries and every shared
# path-prefix constraint is blasted exactly once per run. The paired
# native solver is persistent too: each query loads only the store
# delta and solves under its root literals as *assumptions*, keeping
# learned clauses across queries (MiniSat-style incremental solving).
_session: Optional[tuple] = None
_SESSION_MAX_VARS = 2_000_000
_SESSION_MAX_LITS = 40_000_000

# Deterministic sprint budget, in CDCL conflicts. Calibrated on this
# box: easy queries (the vast majority) finish in well under 1k
# conflicts / ~10ms; at the worst observed conflict rate (~11k/s on a
# clogged clause DB) 10k conflicts is bounded by ~1s of wall — in the
# same band as the old 250ms wall sprint, but machine-independent.
SPRINT_CONFLICTS = 10_000


def _blast_session():
    global _session
    if _session is not None:
        blaster, native = _session
        if (
            blaster.nvars > _SESSION_MAX_VARS
            or len(blaster.flat) > _SESSION_MAX_LITS
            or native.poisoned
        ):
            native.close()
            _session = None
    if _session is None:
        _session = (NativeBlaster(), native_sat.SolverSession())
    return _session


def reset_blast_session() -> None:
    global _session
    if _session is not None:
        _session[1].close()
    _session = None


def _rebuild_native_session() -> native_sat.SolverSession:
    """Replace a wedged native session with a fresh one paired to the
    SAME blaster: the new session's first solve reloads the whole flat
    store (loaded_lits starts at 0), so no blasted clause is lost —
    only the learned clauses, the price of abandoning a hung solver."""
    global _session
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
    )

    DegradationLog().record(
        DegradationReason.SOLVER_SESSION_REBUILT, site="cdcl"
    )
    if _session is None:
        return _blast_session()[1]
    blaster, old = _session
    old.close()  # a no-op leak when the watchdog abandoned it
    fresh = native_sat.SolverSession()
    _session = (blaster, fresh)
    return fresh


def _collect_vars(lowered: List[terms.Term]):
    """Free (name, width) bit-vector vars and bool var names of a
    lowered constraint set (iterative walk over the interned DAG)."""
    bv_keys = set()
    bool_names = set()
    seen = set()
    stack = list(lowered)
    while stack:
        t = stack.pop()
        if t._id in seen:
            continue
        seen.add(t._id)
        if t.op == "var":
            bv_keys.add((t.args[0], t.width))
        elif t.op == "bvar":
            bool_names.add(t.args[0])
        else:
            for a in t.args:
                if isinstance(a, terms.Term):
                    stack.append(a)
    return bv_keys, bool_names


def _race_cone(
    lowered: List[terms.Term], max_constraints: int = 384
) -> List[terms.Term]:
    """The cone of influence of the query's TAIL constraints — what
    the device portfolio race actually searches.

    Analysis queries lower into thousands of conjuncts (per-query
    select-elimination axioms over calldata), which the portfolio
    compiler chokes on (in the JAX package, a 4573-conjunct query
    missed where its 2-conjunct core won). The race doesn't need the whole set: any witness it
    finds is validated against the FULL raw constraints by the
    reconstruction gate before it is believed, so racing a relevant
    subset is sound — an under-constrained witness just fails
    validation and the CDCL proceeds. Seeded from the last conjuncts
    (the freshly-appended branch/property condition), grown by shared
    variables breadth-first, capped."""
    if len(lowered) <= max_constraints:
        return lowered

    var_memo: Dict[int, frozenset] = {}

    def vars_of(t: terms.Term) -> frozenset:
        hit = var_memo.get(t._id)
        if hit is not None:
            return hit
        names = set()
        seen = set()
        stack = [t]
        while stack:
            s = stack.pop()
            if s._id in seen:
                continue
            seen.add(s._id)
            if s.op in ("var", "bvar"):
                names.add(s.args[0])
            else:
                for a in s.args:
                    if isinstance(a, terms.Term):
                        stack.append(a)
        out = frozenset(names)
        var_memo[t._id] = out
        return out

    per = [vars_of(c) for c in lowered]
    active = set().union(*per[-2:]) if len(per) >= 2 else set(per[-1])
    chosen = set(range(len(lowered) - 2, len(lowered)))
    # breadth-first rounds: constraints sharing a live var join the
    # cone and contribute their vars; stop at the cap — proximity to
    # the seed is the relevance order
    for _ in range(4):
        added = False
        for i in range(len(lowered) - 1, -1, -1):
            if i in chosen or len(chosen) >= max_constraints:
                continue
            if per[i] & active:
                chosen.add(i)
                active |= per[i]
                added = True
        if not added or len(chosen) >= max_constraints:
            break
    return [lowered[i] for i in sorted(chosen)]


def _race_grace_s() -> float:
    """The funnel's escalation threshold: how long the host HOLDS a
    verdict it just found while a device race is still in flight,
    giving the card the chance to own it (PORTFOLIO_DEFAULTS, the JAX
    package's value)."""
    from mythril_tpu_torch.laser.smt.solver.portfolio import PORTFOLIO_DEFAULTS

    return max(0.0, float(PORTFOLIO_DEFAULTS["race_grace_ms"])) / 1000.0


#: thread-local channel the device-win and funnel-exit sites mark so
#: the telemetry wrapper below attributes the verdict to the right
#: engine AND the right loss reason (the origin/loss are decided deep
#: inside the race/escape paths, the wall is measured at the entry)
import threading as _threading

_QUERY_ORIGIN = _threading.local()


def _set_loss(reason: str) -> None:
    """Mark WHY the device portfolio will not own this query's verdict
    (observe/querylog.py taxonomy); later sites overwrite — the reason
    standing at the final verdict is the one recorded."""
    _QUERY_ORIGIN.loss = reason


def check_terms(
    raw_constraints: List[terms.Term],
    timeout_ms: int = 10_000,
    conflict_budget: Optional[int] = None,
    device=None,
) -> (str, Optional[Model]):
    """Decide a constraint set — `_check_terms_impl` under solver
    query telemetry: every verdict is tagged with its answering origin
    (host CDCL vs device portfolio), wall time, and escalation hop
    (observe/solverstats.py; the per-run attribution table lands in
    bench records and report meta). Host-answered verdicts
    additionally carry a loss reason — why the device did NOT answer
    (observe/querylog.py `mtpu_solver_loss_total`) — and, under
    --capture-queries, the lowered query itself lands in the capture
    corpus (laser/smt/solver/capture.py). `device` is where the race
    and the --parallel-solving escape search (None: the card: where no
    CUDA device is present, a race or an escape raises, it is never
    quietly skipped)."""
    from mythril_tpu_torch.observe import querylog
    from mythril_tpu_torch.observe.solverstats import (
        ORIGIN_DEVICE,
        ORIGIN_HOST_CDCL,
        record_query,
    )
    from mythril_tpu_torch.laser.smt.solver import capture

    _QUERY_ORIGIN.origin = None
    _QUERY_ORIGIN.loss = None
    _QUERY_ORIGIN.counted_sat = False
    capture.discard()
    t0 = time.perf_counter()
    verdict, model = _check_terms_impl(
        raw_constraints, timeout_ms, conflict_budget, device
    )
    wall = time.perf_counter() - t0
    origin = getattr(_QUERY_ORIGIN, "origin", None) or ORIGIN_HOST_CDCL
    hop = 1 if origin == ORIGIN_DEVICE else 0
    record_query(origin, verdict, wall, hop=hop)
    loss = getattr(_QUERY_ORIGIN, "loss", None)
    if origin == ORIGIN_HOST_CDCL:
        if verdict == sat:
            # pair the loss count EXACTLY with the legacy cdcl-sat
            # counter (the bench acceptance: sum(loss reasons over sat)
            # == cdcl_sat_verdicts) — the trivial early-sat paths bump
            # neither
            if getattr(_QUERY_ORIGIN, "counted_sat", False):
                loss = loss or querylog.LOSS_UNCLASSIFIED
                querylog.record_loss(loss, verdict=sat, site="check_terms")
        elif loss is not None:
            querylog.record_loss(loss, verdict=verdict, site="check_terms")
    else:
        loss = None  # the device won: nothing was lost
    capture.capture_check(
        verdict=verdict, engine=origin, wall_s=wall, hop=hop,
        loss_reason=loss,
    )
    return verdict, model


def _check_terms_impl(
    raw_constraints: List[terms.Term],
    timeout_ms: int = 10_000,
    conflict_budget: Optional[int] = None,
    device=None,
) -> (str, Optional[Model]):
    """Decide a constraint set. With `conflict_budget` the MARATHON is
    also conflict-capped (the sprint always is), so the verdict is a
    pure function of the query whenever the wall valve doesn't fire —
    callers that must be reproducible (objective refinement) pass a
    budget sized to finish well inside their wall allowance."""
    from mythril_tpu_torch.observe import querylog
    from mythril_tpu_torch.support import resilience
    from mythril_tpu_torch.laser.smt.solver import capture

    run_dl = resilience.run_deadline()
    if run_dl is not None:
        if run_dl.expired:
            # the run is out of wall: every further query degrades to
            # UNKNOWN-with-reason instead of spending time the caller
            # no longer has (the supervisor reports the count)
            resilience.DegradationLog().record(
                resilience.DegradationReason.SOLVER_TIMEOUT,
                site="check_terms",
                detail="run deadline expired before solve",
            )
            _set_loss(querylog.LOSS_DEADLINE_EXPIRED)
            return unknown, None
        timeout_ms = run_dl.clamp_ms(timeout_ms)
    t_total = time.monotonic()
    lowered, recon = lower(raw_constraints)
    if capture.capture_active():
        capture.note_lowered(lowered)
    if any(c is terms.FALSE for c in lowered):
        _set_loss(querylog.LOSS_QUERY_TRIVIAL)
        return unsat, None
    if not lowered:
        _set_loss(querylog.LOSS_QUERY_TRIVIAL)
        return sat, _reconstruct({}, {}, recon, raw_constraints)

    blaster, native_session = _blast_session()

    def _native_solve(units_, timeout_ms_, conflict_budget_=None):
        """One rung of the escalation ladder's hang recovery: a native
        solve whose watchdog fired is abandoned, the clause session
        rebuilt (same blaster — the store reloads), and the query
        retried ONCE; a second hang degrades to UNKNOWN-with-reason.
        Reassigns the enclosing session so later rungs of this query
        use the rebuilt one."""
        nonlocal native_session
        from mythril_tpu_torch.exceptions import WatchdogTimeout

        for attempt in (1, 2):
            try:
                return native_session.solve(
                    blaster.nvars,
                    blaster.flat,
                    units_,
                    timeout_ms=timeout_ms_,
                    conflict_budget=conflict_budget_,
                )
            except WatchdogTimeout as why:
                resilience.DegradationLog().record(
                    resilience.DegradationReason.SOLVER_HANG,
                    site="cdcl",
                    detail=f"attempt {attempt}: {why}",
                )
                native_session = _rebuild_native_session()
        return native_sat.UNKNOWN, None

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    units = []
    try:
        for c in lowered:
            root = blaster.blast_bool(c)
            if root == -1:  # constant false
                _set_loss(querylog.LOSS_QUERY_TRIVIAL)
                return unsat, None
            if root != 1:  # constant true contributes nothing
                units.append(root)
    except (NotImplementedError, RecursionError):
        _set_loss(querylog.LOSS_LOWERING_UNSUPPORTED)
        return unknown, None
    finally:
        sys.setrecursionlimit(old_limit)

    # Cost-ordered solving (the JAX package's order): a short
    # native-CDCL sprint answers the easy majority of queries; the
    # device portfolio only sees queries that survive the sprint, and
    # the CDCL marathon is the complete backstop.
    #
    # The sprint is CONFLICT-budgeted, not wall-budgeted: given the
    # same query stream its verdicts are identical on any machine at
    # any load, so report goldens cannot flake on a sprint timing
    # edge. The caller's wall budget rides along as a safety valve
    # only — a query that trips it would have ended as a marathon
    # timeout regardless of machine. The marathon below stays
    # wall-budgeted as the completeness backstop.
    from mythril_tpu_torch.support.support_args import args as _glob_args

    deterministic = _glob_args.deterministic_solving
    # default loss classification for sprint-answered verdicts (the
    # easy majority): the device never got a chance — because the gate
    # is administratively closed (deterministic mode forgoes the race
    # entirely), or because the sprint was simply first
    _set_loss(
        querylog.LOSS_SPRINT_PREEMPTED
        if not deterministic
        else querylog.LOSS_GATE_DISABLED
    )
    remaining = max(200, timeout_ms - int((time.monotonic() - t_total) * 1000))
    # In deterministic mode the conflict budget binds and the wall
    # valve must not (a load-variable valve could flip a verdict), so
    # the sprint gets the full remaining wall. Default mode keeps a
    # modest wall cap: a CNF whose conflict rate is far below the
    # calibrated ~10k/s must not burn most of the per-query wall
    # inside the sprint and starve the device attempt + marathon.
    sprint_ms = remaining if deterministic else min(2000, remaining)
    t_sprint = time.perf_counter()
    status, bits = _native_solve(
        units, sprint_ms, conflict_budget_=SPRINT_CONFLICTS
    )
    SolverStatistics().bump("sprint_time", time.perf_counter() - t_sprint)
    if status == native_sat.UNSAT:
        return unsat, None
    device_tried = False
    t_marathon = time.perf_counter()
    if status == native_sat.UNKNOWN:
        # The marathon. Deterministic mode (and explicit caller
        # conflict budgets) run it as ONE conflict/wall-bounded call —
        # the verdict must stay a pure function of the query. Default
        # mode races the card: a daemon thread runs the portfolio
        # search on the same query (the thread waits on the card and
        # the ctypes CDCL call releases the GIL) while the marathon
        # proceeds in short wall slices, polling the race between
        # slices; the first engine with an answer wins. This is the
        # device's `--parallel-solving` (reference: z3
        # parallel.enable, mythril/laser/smt/solver/__init__.py:8-9):
        # two engines on two processors.
        if conflict_budget is None and deterministic:
            # budget sized to bind BEFORE the wall even at the slowest
            # observed conflict rate on bit-blasted CNFs (~10k/s), so
            # the verdict is load-independent; only queries slower
            # than ~8k conflicts/s still fall to the wall valve
            conflict_budget = timeout_ms * 8
        if deterministic or conflict_budget is not None:
            # reproducible mode forgoes the race by design: the device
            # gate is administratively closed for this query
            _set_loss(querylog.LOSS_GATE_DISABLED)
            # the valve must not inherit the sprint's (load-variable)
            # wall consumption, or a hard query flips verdicts under
            # load — the budget above is the binding constraint, the
            # full caller budget the emergency stop (worst ≤2× wall)
            remaining = (
                timeout_ms
                if deterministic
                else max(
                    200,
                    timeout_ms - int((time.monotonic() - t_total) * 1000),
                )
            )
            status, bits = _native_solve(
                units, remaining, conflict_budget_=conflict_budget
            )
        else:
            from mythril_tpu_torch.laser.smt.solver import device_race

            race = None
            if len(lowered) < 2:
                # below the race's minimum useful size: the cone would
                # be the whole (tiny) query and the dispatch chain
                # costs more than the marathon
                _set_loss(querylog.LOSS_QUERY_TRIVIAL)
            elif not device_race.race_available():
                _set_loss(querylog.LOSS_RACE_NOT_STARTED)
            else:
                race = device_race.DeviceRace(_race_cone(lowered), device=device)
                if not race.started:
                    race = None
                    _set_loss(querylog.LOSS_RACE_NOT_STARTED)
            device_tried = race is not None
            while True:
                if race is not None:
                    found = race.poll()
                    if found is device_race.FAILED:
                        # the portfolio finished WITHOUT a witness —
                        # distinct from a timing loss (satellite: the
                        # race-loss waterfall)
                        SolverStatistics().bump("race_losses")
                        _set_loss(querylog.LOSS_SLS_NONCONVERGED)
                        race = None
                    elif found is not device_race.PENDING:
                        model = _reconstruct(
                            found, {}, recon, raw_constraints
                        )
                        if model is None:
                            # the cone witness alone doesn't cover the
                            # full vocabulary: pin it and let the CDCL
                            # extend it (the card did the hard search)
                            model = _extend_race_witness(
                                found, blaster, native_session, units,
                                lowered, recon, raw_constraints,
                                remaining_ms=timeout_ms
                                - int((time.monotonic() - t_total) * 1000),
                            )
                        if model is not None:
                            SolverStatistics().bump("device_sat_count")
                            SolverStatistics().bump("race_wins")
                            _QUERY_ORIGIN.origin = "device-portfolio"
                            return sat, model
                        SolverStatistics().bump("race_losses")
                        _set_loss(querylog.LOSS_WITNESS_INVALID)
                        race = None  # invalid witness: back to CDCL
                        # the witness extension may have abandoned a
                        # wedged session; resync so the CDCL continues
                        # on the rebuilt one instead of a poisoned stub
                        blaster, native_session = _blast_session()
                rem = timeout_ms - int((time.monotonic() - t_total) * 1000)
                if rem <= 0:
                    if race is not None:
                        # the query's budget ran out with the race
                        # still searching: that IS a loss
                        SolverStatistics().bump("race_losses")
                        _set_loss(
                            querylog.LOSS_SLS_NONCONVERGED
                            if race.outcome() == "failed"
                            else querylog.LOSS_RACE_LOST_TIMING
                        )
                    status = native_sat.UNKNOWN
                    break
                # short slices only while a race could preempt the
                # marathon; alone, the session gets the full remainder
                # (the incremental session keeps learned clauses, so
                # slicing costs only empty delta loads)
                slice_ms = min(1000, rem) if race is not None else rem
                status, bits = _native_solve(units, max(200, slice_ms))
                if status != native_sat.UNKNOWN:
                    if race is not None:
                        # Device-first verdict ownership: the host
                        # HOLDS a sat answer for the escalation grace
                        # window while the race is still in flight —
                        # a witness arriving inside it is the device's
                        # verdict (validated like any other). Unsat
                        # can never be ceded: the race cone is a
                        # subset, its witness proves nothing there.
                        grace_invalid = False
                        if status == native_sat.SAT:
                            g_dl = time.monotonic() + _race_grace_s()
                            found = race.poll()
                            while (
                                found is device_race.PENDING
                                and time.monotonic() < g_dl
                            ):
                                time.sleep(0.002)
                                found = race.poll()
                            if found not in (
                                device_race.PENDING,
                                device_race.FAILED,
                            ):
                                model = _reconstruct(
                                    found, {}, recon, raw_constraints
                                )
                                if model is not None:
                                    SolverStatistics().bump("device_sat_count")
                                    SolverStatistics().bump("race_wins")
                                    _QUERY_ORIGIN.origin = (
                                        "device-portfolio"
                                    )
                                    return sat, model
                                grace_invalid = True
                        # the host keeps the verdict: split "still
                        # searching" from "finished empty, unpolled"
                        # from "witness failed the gate" — different
                        # losses
                        SolverStatistics().bump("race_losses")
                        if grace_invalid:
                            _set_loss(querylog.LOSS_WITNESS_INVALID)
                        elif race.outcome() == "failed":
                            _set_loss(querylog.LOSS_SLS_NONCONVERGED)
                        else:
                            _set_loss(querylog.LOSS_RACE_LOST_TIMING)
                    break
                if race is None:
                    break  # full remaining budget spent in one call
        SolverStatistics().bump("marathon_time", time.perf_counter() - t_marathon)
    if status == native_sat.UNSAT:
        return unsat, None
    if status == native_sat.UNKNOWN:
        # portfolio escape hatch: the card's local search may still
        # find a witness where CDCL timed out (--parallel-solving).
        # Skipped when the gated device attempt already searched this
        # exact query — a second multi-second dispatch buys nothing.
        from mythril_tpu_torch.support.support_args import args as _args

        if _args.parallel_solving and not device_tried:
            from mythril_tpu_torch.laser.smt.solver import portfolio

            prog, compile_loss = portfolio.compile_program_ex(lowered)
            if prog is None:
                _set_loss(compile_loss or querylog.LOSS_LOWERING_UNSUPPORTED)
                return unknown, None
            # one card: the multi-card escape is ROADMAP Queue 1 item 8
            # (portfolio's n_devices > 1 raises)
            asn = portfolio.device_check(
                lowered, n_devices=1, prog=prog, device=device
            )
            if asn is not None:
                model = _reconstruct(asn, {}, recon, raw_constraints)
                if model is not None:
                    SolverStatistics().bump("device_sat_count")
                    _QUERY_ORIGIN.origin = "device-portfolio"
                    return sat, model
                _set_loss(querylog.LOSS_WITNESS_INVALID)
            else:
                _set_loss(querylog.LOSS_SLS_NONCONVERGED)
        return unknown, None

    # decode CNF bits -> word-level assignment, restricted to the vars
    # this query references: the session store holds vars from every
    # query this run, and a same-named var of another width would
    # otherwise clobber the live one
    model = _decode_bits(blaster, bits, lowered, recon, raw_constraints)
    if model is None:
        return unknown, None
    SolverStatistics().bump("cdcl_sat_count")
    # the flag pairs the loss-reason count to THIS counter 1:1 (the
    # wrapper records the sat-loss only for counted verdicts)
    _QUERY_ORIGIN.counted_sat = True
    return sat, model


def _decode_bits(blaster, bits, lowered, recon, raw_constraints):
    """SAT bit vector -> validated word-level model (or None)."""
    bv_keys, bool_names = _collect_vars(lowered)
    base: Dict[str, int] = {}
    for key in bv_keys:
        var_bits = blaster.var_bits.get(key)
        if var_bits is None:
            continue
        val = 0
        for i, lit in enumerate(var_bits):
            if bits[lit - 1]:
                val |= 1 << i
        base[key[0]] = val
    bools: Dict[str, int] = {
        name: bits[blaster.bool_vars[name] - 1]
        for name in bool_names
        if name in blaster.bool_vars
    }
    return _reconstruct(base, bools, recon, raw_constraints)


def _extend_race_witness(
    found: Dict[str, int],
    blaster,
    native_session,
    units: List[int],
    lowered,
    recon,
    raw_constraints,
    remaining_ms: int = 8_000,
):
    """Two-stage device-led sat: the portfolio cracked the race cone's
    core (found = {var: value}); pin those values as assumptions and
    let the incremental CDCL extend them to a FULL model of the query
    in one short propagation-heavy call. The hard search happened on
    the card; the CDCL only fills in the easy remainder (eliminated
    select names, size bounds). Returns a validated model or None —
    an inconsistent core (cone under-approximation) comes back unsat
    here and the caller treats the race as lost."""
    # keyed lookup: THIS query's (name, width) vocabulary — a linear
    # scan of the persistent store would also pin stale same-named
    # vars of other widths from earlier queries
    bv_keys, _bool_names = _collect_vars(lowered)
    width_of = {name: width for (name, width) in bv_keys}

    def pins_for(names) -> List[int]:
        pins: List[int] = []
        for name in names:
            value = found[name]
            if name in blaster.bool_vars:
                lit = blaster.bool_vars[name]
                pins.append(lit if value else -lit)
                continue
            width = width_of.get(name)
            var_bits = (
                blaster.var_bits.get((name, width))
                if width is not None
                else None
            )
            if var_bits is None:
                continue
            for i, lit in enumerate(var_bits):
                pins.append(lit if (value >> i) & 1 else -lit)
        return pins

    # full pin first; if the cone witness is inconsistent with the
    # constraints outside the cone, relax to single-var pins — even
    # one concretized 256-bit operand collapses the mul/div circuit
    # the CDCL was grinding on. Every attempt respects the caller's
    # remaining wall: the extension must not overrun the query budget.
    deadline = time.monotonic() + max(0, remaining_ms) / 1000.0
    attempts = [list(found.keys())]
    attempts += [[n] for n in list(found.keys())[:3]]
    for names in attempts:
        left_ms = int((deadline - time.monotonic()) * 1000)
        if left_ms <= 100:
            return None
        pins = pins_for(names)
        if not pins:
            continue
        try:
            status, bits = native_session.solve(
                blaster.nvars,
                blaster.flat,
                units + pins,
                timeout_ms=min(2_000, left_ms),
                conflict_budget=50_000,
            )
        except Exception as why:
            from mythril_tpu_torch.exceptions import WatchdogTimeout

            if not isinstance(why, WatchdogTimeout):
                raise
            # the extension is best-effort on top of a race win: a
            # wedged session loses the witness, never the query — the
            # caller treats the race as lost and the CDCL (on a
            # rebuilt session) proceeds
            from mythril_tpu_torch.support.resilience import (
                DegradationLog,
                DegradationReason,
            )

            DegradationLog().record(
                DegradationReason.SOLVER_HANG, site="cdcl-extend"
            )
            _rebuild_native_session()
            return None
        if status == native_sat.SAT:
            model = _decode_bits(
                blaster, bits, lowered, recon, raw_constraints
            )
            if model is not None:
                return model
    return None


def _reconstruct(
    base: Dict[str, int],
    bools: Dict[str, int],
    recon: Recon,
    raw_constraints: List[terms.Term],
) -> Optional[Model]:
    """CNF assignment -> full model over the original vocabulary."""
    assignment: Dict = dict(base)
    assignment.update(bools)
    # propagated bindings are constant terms; they override any decoded
    # SAT value — a persistent blast session may hold stale bits for a
    # same-named var from an earlier query, and a bound var was never
    # part of this query's CNF
    for name, val in recon.bindings.items():
        v = val.value
        assignment[name] = v if v is not None else 0
    # arrays: evaluate each recorded select index under the assignment
    for arr_name, apps in recon.sel_apps.items():
        table = {}
        for idx_term, fresh in apps:
            idx_val = eval_term(idx_term, assignment)
            table.setdefault(idx_val, assignment.get(fresh, 0))
        assignment[arr_name] = (0, table)
    # UFs: same, keyed on evaluated argument tuples
    for uf_name, apps in recon.uf_apps.items():
        table = {}
        for arg_terms_, fresh in apps:
            key = tuple(eval_term(a, assignment) for a in arg_terms_)
            table.setdefault(key, assignment.get(fresh, 0))
        assignment[uf_name] = table
    model = Model(assignment)
    # soundness gate: the model must satisfy every original constraint
    for c in raw_constraints:
        if not eval_term(c, assignment):
            return None
    return model
