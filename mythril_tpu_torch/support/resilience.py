"""Deadline-aware resilient supervision.

The port's copy of the JAX package's support/resilience.py. Two
changes: `is_device_fault` classifies torch's CUDA faults (the JAX
version matches XLA's runtime errors), and the metrics-registry mirror
of `DegradationLog.record` is left out (the port has no registry yet).

Production symbolic-execution tools treat resource exhaustion as a
first-class outcome, not a crash (PAPERS.md: Manticore ships per-query
solver timeouts and state snapshotting). This module is the one place
that policy lives for the whole pipeline:

- **Deadline / run budget** — a wall-clock budget every layer consults:
  the corpus driver at contract boundaries, the wave loop at wave
  boundaries, the solver at query entry (`clamp_ms`). `--deadline` on
  the CLI creates the process-global run deadline.
- **DegradationReason taxonomy + DegradationLog** — structured record
  of every degradation (solver hang, device fault, deadline skip,
  host takeover, ...) so reports can surface WHAT degraded and WHY
  instead of logging it away.
- **RetryPolicy / retry_device_dispatch** — exponential-backoff retry
  for device dispatches, with fault classification (CUDA OOM and
  runtime errors are retriable; logic errors are not).
- **call_with_watchdog** — abandon a wedged native call (the ctypes
  CDCL boundary releases the GIL, so a daemon thread + bounded join
  observes the hang without being hostage to it).
- **Fault injection** — deterministic, test-armed faults at named
  sites (`arm_fault` / `inject`): production code calls `inject(site)`
  at the boundaries the fault suite exercises; the call is a no-op
  unless a test armed that site.
- **Graceful shutdown** — SIGINT/SIGTERM handlers that set a shutdown
  event the wave/contract boundaries poll, so an interrupted run
  flushes its checkpoint and emits a partial report instead of dying
  with a traceback.

Everything here is host-side and dependency-free (threading + signal
only): it must keep working precisely when the accelerator stack is
the thing that is failing.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.exceptions import (
    DeviceDispatchError,
    InjectedFault,
    WatchdogTimeout,
)
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# degradation taxonomy
# ---------------------------------------------------------------------------
class DegradationReason:
    """Structured reasons a run degraded instead of crashing. String
    constants (not an Enum): they travel through result dicts and JSON
    reports, and the stable wire form IS the taxonomy."""

    SOLVER_TIMEOUT = "solver-timeout"
    SOLVER_HANG = "solver-hang"
    SOLVER_SESSION_REBUILT = "solver-session-rebuilt"
    DEVICE_DISPATCH_FAILED = "device-dispatch-failed"
    DEVICE_SPLIT_DISPATCH = "device-split-dispatch"
    #: the device race of a `check_terms` query raised (a kernel build
    #: or launch error, or any other exception) instead of finishing
    #: with or without a witness; the CDCL decided the query
    DEVICE_RACE_FAILED = "device-race-failed"
    #: a device fault surfaced at a wave's READBACK rather than its
    #: dispatch (the pipelined wave engine's worker thread): the
    #: record carries the faulted wave's serial so a fault on the
    #: in-flight wave N+1 is attributed to N+1, not to whichever wave
    #: the host happened to be consuming
    ASYNC_DEVICE_FAULT = "async-device-fault"
    WAVE_ABANDONED = "wave-abandoned"
    #: a device GROUP's shard degraded under the multi-chip scheduler
    #: (parallel/topology.py FailureDomain): the site names the group,
    #: so a faulted chip is attributed — and contained — per group
    #: while the other groups' shards keep dispatching
    MESH_GROUP_DEGRADED = "mesh-group-degraded"
    HOST_TAKEOVER = "host-takeover"
    DEADLINE_EXPIRED = "deadline-expired"
    INTERRUPTED = "interrupted"
    CONTRACT_SKIPPED = "contract-skipped"
    PREPASS_FAILED = "prepass-failed"
    #: the analyzer facade's overlapped corpus prepass (analysis/corpus.py
    #: OverlappedPrepass) did not end within its drain or finish grace,
    #: a device call hung: its banked witnesses are lost (port-only: the
    #: JAX package only logs it)
    PREPASS_DRAIN_TIMED_OUT = "prepass-drain-timed-out"
    #: the static pass (analysis/static) raised on a contract: it
    #: explores unpruned, every detection module mounts and the triage
    #: takes the full path, so the report is the unpruned analysis's
    STATIC_PREPASS_FAILED = "static-prepass-failed"
    #: the explorer's kernel specialization setup (signatures, the
    #: fuse or block-program table) raised on the host: the waves run
    #: the generic kernel, whose results the specialized one equals
    SPECIALIZE_FAILED = "specialize-failed"
    #: the analysis service's arena warmup (service/engine.py) failed:
    #: a kernel library did not build or load, or the warmup wave
    #: faulted; the replica stays redlined, never ready
    ARENA_WARMUP_FAILED = "arena-warmup-failed"
    #: a poison job — implicated in repeated wave faults (in-process
    #: strike counter fed by wave-fault attribution plus a
    #: crash-implication strike at journal recovery) — was isolated to
    #: a solo wave, failed again, and is now settled FAILED with its
    #: codehash denylisted for the process lifetime (service/engine.py)
    QUARANTINED = "quarantined"
    #: a journal append failed (disk full, injected fault): the job
    #: journal degrades to NON-DURABLE for the rest of its life and
    #: admission keeps working — crash-safety is reported lost, never
    #: traded for availability (service/journal.py)
    JOURNAL_DEGRADED = "journal-degraded"
    #: the verdict store (store/) could not be opened or read: the
    #: lookup is a miss and the contract takes the full path (port-only:
    #: the JAX package only logs it)
    STORE_UNAVAILABLE = "store-unavailable"
    #: a verdict could not be written back into the store: the analysis
    #: stands, the next run recomputes it (port-only: the JAX package
    #: only logs it)
    STORE_WRITEBACK_FAILED = "store-writeback-failed"
    #: the learned router (routing/) raised while it loaded or decided
    #: a route: that call site keeps the built-in ladder (port-only: the
    #: JAX package only logs it; a refused artifact is counted in
    #: mtpu_router_refused_total, not recorded here)
    ROUTER_FAILED = "router-failed"
    #: a routing-feature record (observe/routing.py) could not be built
    #: or written: one row of the training log is lost, the analysis
    #: stands (port-only: the JAX package only logs it)
    ROUTING_RECORD_FAILED = "routing-record-failed"


#: observers notified after every DegradationLog.record — the
#: telemetry layer registers its flight-recorder
#: auto-dump here. This module stays dependency-free: hooks are plain
#: callables `(reason, site)` and a broken hook is contained.
_DEGRADATION_HOOKS: List[Callable[[str, str], None]] = []


def add_degradation_hook(fn: Callable[[str, str], None]) -> None:
    """Register an observer called (outside the log's lock) after every
    degradation record. Idempotent per function object."""
    if fn not in _DEGRADATION_HOOKS:
        _DEGRADATION_HOOKS.append(fn)


class DegradationLog(object, metaclass=Singleton):
    """Process-global degradation record: full per-reason counts plus a
    bounded tail of detailed events (a hung corpus can degrade
    thousands of queries — the counts must stay exact while the event
    list stays bounded)."""

    EVENT_CAP = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.events: List[Dict] = []

    def record(
        self, reason: str, site: str = "", detail: str = "", contract: str = ""
    ) -> None:
        try:
            # the registry mirror (reason label only — site/contract
            # stay out of the label set to bound cardinality): the SLO
            # engine's wave-abandon objective burns against this
            from mythril_tpu_torch.observe.registry import registry

            registry().counter(
                "mtpu_degradations_total",
                "degradation events by reason (resilience taxonomy)",
            ).labels(reason=reason).inc()
        except Exception:
            pass  # telemetry must never sink the degradation record
        with self._lock:
            self.counts[reason] = self.counts.get(reason, 0) + 1
            self.events.append(
                {
                    "reason": reason,
                    "site": site,
                    "detail": detail,
                    "contract": contract,
                }
            )
            if len(self.events) > self.EVENT_CAP:
                del self.events[: len(self.events) - self.EVENT_CAP]
        # routine by-design fallbacks (takeover) log quietly; genuine
        # infrastructure degradation warns
        level = (
            logging.INFO
            if reason == DegradationReason.HOST_TAKEOVER
            else logging.WARNING
        )
        log.log(
            level,
            "degraded [%s] at %s%s%s",
            reason,
            site or "?",
            f" ({contract})" if contract else "",
            f": {detail}" if detail else "",
        )
        for hook in list(_DEGRADATION_HOOKS):
            try:
                hook(reason, site)
            except Exception:  # telemetry must never sink the run
                log.debug("degradation hook failed", exc_info=True)

    def marker(self) -> Dict[str, int]:
        """Snapshot for delta accounting (the log is process-global but
        a report covers one run)."""
        with self._lock:
            return dict(self.counts)

    def counts_since(self, marker: Dict[str, int]) -> Dict[str, int]:
        with self._lock:
            out = {
                reason: n - marker.get(reason, 0)
                for reason, n in self.counts.items()
                if n - marker.get(reason, 0) > 0
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self.counts = {}
            self.events = []


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
class Deadline:
    """A wall-clock budget that every layer can consult cheaply."""

    def __init__(self, budget_s: Optional[float], label: str = "run") -> None:
        self.label = label
        self.budget_s = budget_s
        self._t0 = time.monotonic()

    @property
    def remaining(self) -> float:
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - (time.monotonic() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining <= 0

    def clamp_ms(self, timeout_ms: int, floor_ms: int = 200) -> int:
        """A per-query timeout must never promise more wall than the
        run has left; the floor keeps a nearly-expired run from posing
        zero-budget queries that flake as spurious unknowns."""
        if self.budget_s is None:
            return timeout_ms
        return min(timeout_ms, max(floor_ms, int(self.remaining * 1000)))

    def check(self, site: str = "") -> None:
        if self.expired:
            from mythril_tpu_torch.exceptions import DeadlineExpiredError

            raise DeadlineExpiredError(
                f"{self.label} deadline ({self.budget_s}s) expired"
                + (f" at {site}" if site else "")
            )


_RUN_DEADLINE: Optional[Deadline] = None


def set_run_deadline(budget_s: Optional[float]) -> Optional[Deadline]:
    """Install the process-global run deadline (CLI --deadline). The
    clock starts NOW; pass None to clear."""
    global _RUN_DEADLINE
    _RUN_DEADLINE = None if budget_s is None else Deadline(budget_s)
    return _RUN_DEADLINE


def run_deadline() -> Optional[Deadline]:
    return _RUN_DEADLINE


def clear_run_deadline() -> None:
    set_run_deadline(None)


def interrupted_reason(deadline: Optional[Deadline] = None) -> Optional[str]:
    """Why the supervised loop should stop NOW, or None: an expired
    deadline (the given one, falling back to the run deadline) or a
    delivered SIGINT/SIGTERM. The one check every wave/contract
    boundary makes."""
    if shutdown_requested():
        return DegradationReason.INTERRUPTED
    dl = deadline if deadline is not None else _RUN_DEADLINE
    if dl is not None and dl.expired:
        return DegradationReason.DEADLINE_EXPIRED
    return None


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------
class RetryPolicy:
    """Exponential backoff schedule: `delays()` yields the sleep before
    each RETRY (so `attempts` total tries get `attempts - 1` delays)."""

    def __init__(
        self,
        attempts: int = 3,
        base_delay_s: float = 0.1,
        multiplier: float = 2.0,
        max_delay_s: float = 5.0,
    ) -> None:
        self.attempts = max(1, attempts)
        self.base_delay_s = base_delay_s
        self.multiplier = multiplier
        self.max_delay_s = max_delay_s

    def delays(self) -> List[float]:
        out, delay = [], self.base_delay_s
        for _ in range(self.attempts - 1):
            out.append(delay)
            delay = min(delay * self.multiplier, self.max_delay_s)
        return out


def _torch_fault_types() -> tuple:
    """torch's exception types for a faulting card: the CUDA allocator's
    OutOfMemoryError and, where the installed torch has it,
    AcceleratorError (the type newer torch raises for CUDA runtime
    errors)."""
    import torch

    types = [torch.cuda.OutOfMemoryError]
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(accel, type):
        types.append(accel)
    return tuple(types)


def is_device_fault(exc: BaseException) -> bool:
    """Classify an exception from a device dispatch: True only for
    faults of the card or its runtime worth retrying/degrading (CUDA
    OOM, a CUDA runtime error, an injected `device*` fault), so genuine
    bugs (a ValueError, a shape error) still propagate with their
    tracebacks. A sticky CUDA error (an illegal address poisons the
    context) fails every retry again: it leaves the ladder as
    DeviceDispatchError and the caller degrades; nothing here falls
    back to the CPU."""
    if isinstance(exc, InjectedFault):
        return exc.site.startswith("device")
    if isinstance(exc, _torch_fault_types()):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def retry_device_dispatch(
    dispatch: Callable,
    label: str = "device",
    policy: Optional[RetryPolicy] = None,
    contract: str = "",
):
    """Run a device dispatch under the retry ladder: classified faults
    back off and retry per `policy`; anything else propagates. Every
    attempt re-runs `dispatch` itself, so a dispatch bound to the card
    is retried on the card. After
    the last attempt the fault is raised as DeviceDispatchError so the
    caller can degrade (host takeover / partial outcome) instead of
    crashing the corpus. The `device.dispatch` injection site fires
    inside every attempt, so armed faults exercise exactly this path."""
    policy = policy or RetryPolicy()
    delays = policy.delays()
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        try:
            inject("device.dispatch")
            return dispatch()
        except Exception as why:
            if not is_device_fault(why):
                raise
            last = why
            DegradationLog().record(
                DegradationReason.DEVICE_DISPATCH_FAILED,
                site=label,
                detail=f"attempt {attempt + 1}/{policy.attempts}: {why}",
                contract=contract,
            )
            if attempt < len(delays):
                time.sleep(delays[attempt])
    raise DeviceDispatchError(f"{label}: {last}") from last


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
#: grace on top of a guarded call's own wall budget before the
#: watchdog declares it wedged. Sized so a pathological-but-progressing
#: CDCL chunk (20k conflicts at a ~1k/s worst-case rate) never trips
#: it; tests shrink it to exercise the hang path deterministically.
SOLVER_WATCHDOG_GRACE_S = 30.0


def solver_watchdog_budget_s(timeout_ms: Optional[int]) -> Optional[float]:
    """Watchdog budget for one native solve: its own wall budget plus
    the grace. None (watchdog off) for unbounded calls — with no wall
    budget there is no notion of 'wedged past it'."""
    if timeout_ms is None:
        return None
    return timeout_ms / 1000.0 + SOLVER_WATCHDOG_GRACE_S


def call_with_watchdog(fn: Callable, timeout_s: float, label: str = ""):
    """Run `fn` in a daemon thread and join with a bound. On timeout,
    raise WatchdogTimeout and LEAVE THE THREAD RUNNING — the caller
    must treat whatever state `fn` was touching as lost (never free it
    out from under the zombie)."""
    outcome: Dict[str, object] = {}
    done = threading.Event()

    def _work():
        try:
            outcome["value"] = fn()
        except BaseException as why:  # noqa: BLE001 — relayed below
            outcome["error"] = why
        finally:
            done.set()

    worker = threading.Thread(
        target=_work, daemon=True, name=f"watchdog-{label or 'call'}"
    )
    worker.start()
    if not done.wait(timeout_s):
        raise WatchdogTimeout(
            f"{label or 'guarded call'} exceeded its {timeout_s:.1f}s "
            "watchdog budget"
        )
    if "error" in outcome:
        raise outcome["error"]  # type: ignore[misc]
    return outcome["value"]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
class _FaultSpec:
    def __init__(
        self,
        site: str,
        times: int,
        action: str,
        exc: Optional[BaseException],
        delay_s: float,
        skip: int,
        fn: Optional[Callable],
    ) -> None:
        self.site = site
        self.times = times
        self.action = action
        self.exc = exc
        self.delay_s = delay_s
        self.skip = skip
        self.fn = fn
        self.calls = 0
        self.fired = 0


_FAULTS: Dict[str, _FaultSpec] = {}
_FAULT_LOCK = threading.Lock()


def arm_fault(
    site: str,
    times: int = 1,
    action: str = "raise",
    exc: Optional[BaseException] = None,
    delay_s: float = 0.0,
    skip: int = 0,
    fn: Optional[Callable] = None,
) -> None:
    """Arm a deterministic fault at `site` (test harness only).

    action: "raise" raises `exc` (default InjectedFault), "hang"
    sleeps `delay_s` — inside a watchdog-guarded region that simulates
    a wedged native call — and "call" invokes `fn` (e.g. deliver a
    SIGTERM mid-wave). The first `skip` calls pass through; the next
    `times` calls fire; later calls pass through again."""
    with _FAULT_LOCK:
        _FAULTS[site] = _FaultSpec(site, times, action, exc, delay_s, skip, fn)


def disarm_faults() -> None:
    with _FAULT_LOCK:
        _FAULTS.clear()


def fault_fire_count(site: str) -> int:
    with _FAULT_LOCK:
        spec = _FAULTS.get(site)
        return spec.fired if spec else 0


def inject(site: str) -> None:
    """Production-side hook: fire the armed fault for `site`, if any.
    A dict probe + None check when nothing is armed — cheap enough for
    hot paths."""
    if not _FAULTS:
        return
    with _FAULT_LOCK:
        spec = _FAULTS.get(site)
        if spec is None:
            return
        spec.calls += 1
        if spec.calls <= spec.skip or spec.fired >= spec.times:
            return
        spec.fired += 1
    if spec.action == "hang":
        time.sleep(spec.delay_s)
        return
    if spec.action == "call":
        if spec.fn is not None:
            spec.fn()
        return
    raise spec.exc if spec.exc is not None else InjectedFault(site)


# ---------------------------------------------------------------------------
# graceful shutdown
# ---------------------------------------------------------------------------
_SHUTDOWN = threading.Event()


def shutdown_event() -> threading.Event:
    return _SHUTDOWN


def shutdown_requested() -> bool:
    return _SHUTDOWN.is_set()


def clear_shutdown() -> None:
    _SHUTDOWN.clear()


_SHUTDOWN_DEPTH = 0
#: handlers that were installed before the supervisor's, keyed by
#: signal number — module-global (not per-scope) so re-entry can never
#: save the supervisor's OWN handler as "previous" and leak it
_PREVIOUS_HANDLERS: Dict[int, object] = {}


def _supervisor_handler(signum, frame) -> None:
    """The one supervisor signal handler: record the interruption, set
    the shutdown event the wave/contract boundaries poll, then CHAIN to
    whatever handler was installed before us — an embedding server
    (e.g. `myth serve`'s drain handler) keeps receiving its signals
    even while an analysis runs under the supervisor. The default
    KeyboardInterrupt handler and SIG_DFL/SIG_IGN are not chained:
    re-raising would kill exactly the run this handler exists to wind
    down gracefully."""
    DegradationLog().record(
        DegradationReason.INTERRUPTED,
        site="signal",
        detail=signal.Signals(signum).name,
    )
    _SHUTDOWN.set()
    previous = _PREVIOUS_HANDLERS.get(signum)
    if callable(previous) and previous is not signal.default_int_handler:
        previous(signum, frame)


class graceful_shutdown:
    """Context manager: SIGINT/SIGTERM set the shutdown event (polled
    at wave/contract boundaries) instead of killing the process, so the
    run flushes checkpoints and reports what it has. No-op off the main
    thread (signal handlers are a main-thread privilege). Nests: the
    analyzer and the corpus driver both guard their loops, handlers
    install once at the outermost entry and the event clears only when
    the outermost scope exits (an inner exit must not erase a signal
    the outer loop still needs to honor).

    Embedding-safe: installation is idempotent (finding our own handler
    already installed saves nothing, so repeated runs can't make the
    supervisor its own "previous" handler), the handler chains to the
    embedder's (see _supervisor_handler), and exit restores the
    previous handler ONLY while ours is still the installed one — an
    embedder that re-registered its own handler mid-run keeps it."""

    SIGNALS = (signal.SIGINT, signal.SIGTERM)

    def __init__(self) -> None:
        self._armed = False

    def __enter__(self) -> "graceful_shutdown":
        global _SHUTDOWN_DEPTH
        if threading.current_thread() is not threading.main_thread():
            return self
        _SHUTDOWN_DEPTH += 1
        self._armed = True
        if _SHUTDOWN_DEPTH > 1:
            return self
        for sig in self.SIGNALS:
            try:
                current = signal.getsignal(sig)
                if current is _supervisor_handler:
                    continue  # already installed: nothing to save
                _PREVIOUS_HANDLERS[sig] = current
                signal.signal(sig, _supervisor_handler)
            except (ValueError, OSError):  # exotic embedding: keep going
                pass
        return self

    def __exit__(self, *exc) -> None:
        global _SHUTDOWN_DEPTH
        if not self._armed:
            return None
        _SHUTDOWN_DEPTH -= 1
        if _SHUTDOWN_DEPTH > 0:
            return None
        for sig in self.SIGNALS:
            previous = _PREVIOUS_HANDLERS.pop(sig, None)
            if previous is None:
                continue
            try:
                if signal.getsignal(sig) is _supervisor_handler:
                    signal.signal(sig, previous)
            except (ValueError, OSError):
                pass
        _SHUTDOWN.clear()
        return None
