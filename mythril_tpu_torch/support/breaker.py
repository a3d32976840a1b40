"""Tier circuit breakers: stop re-failing a sick tier per job.

The resilience ladder (support/resilience.py) already degrades a
*single* failed operation down the tier ladder — device wave to host
walk, specialized kernel to generic, store read to miss. What it does
not do is remember: a persistently failing tier pays the whole
retry/backoff ladder on EVERY job, so a wedged device turns each
request into seconds of doomed retries before the fallback fires.

A `CircuitBreaker` is that memory — the standard three-state machine
production serving stacks wrap around flaky dependencies:

- **closed** — healthy; calls flow, failures are counted. Trips open
  on `failure_threshold` consecutive failures OR a failure rate of
  `rate_threshold` over the last `window` outcomes (both classes of
  sickness: hard-down and badly flapping).
- **open** — the tier is routed AROUND (device wave -> host walk,
  specialized -> generic kernel, store -> miss) with zero per-job
  retry cost. After `recovery_s` the breaker softens to half-open.
- **half-open** — probe traffic is allowed through; one recorded
  success closes the breaker, one failure re-opens it and re-arms
  the recovery clock.

`allow()` is non-consuming: callers may consult it more than once per
operation; state only moves on `record_success`/`record_failure`.

Breakers are process-wide, keyed by tier name (`breaker(tier)`), and
surfaced three ways: `mtpu_breaker_state{tier}` gauges (0 closed /
1 half-open / 2 open) + `mtpu_breaker_trips_total{tier}` counters,
`/stats breaker.*`, and `breaker-open:<tier>` entries in the
HealthMonitor redline vocabulary (observe/slo.py) so the federation
front can see a replica serving in fallback mode.

Like resilience.py, this module is dependency-free (threading only;
the registry import is guarded, and a failed export never sinks the
tier) — it must keep working precisely when the accelerator stack is
the thing that is failing. `--no-breakers`
(support_args.breakers) disables the whole layer: every tier then
behaves exactly as before this module existed.

The port's copy of the JAX package's support/breaker.py, less the
store and compile-plane tiers, whose layers the port does not have. The
port wires the explorer's device-solve tier and the analysis service's
device tier (wave dispatch) and kernel tier (bucket warmups and
specialized waves).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

#: breaker states (the gauge value is the index in STATES)
STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half-open"
STATE_OPEN = "open"
STATES = (STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN)

#: the wired tier names (the board is open-ended)
TIER_DEVICE = "device"  # the service's device wave dispatch
TIER_DEVICE_SOLVE = "device-solve"  # device-first solver funnel
TIER_KERNEL = "kernel"  # the service's bucket warmups and specialized waves
TIER_STORE = "store"  # verdict-store reads/writes

#: the redline-vocabulary prefix (observe/slo.py REDLINE_BREAKER_OPEN)
REASON_PREFIX = "breaker-open"


class CircuitBreaker:
    """One tier's closed -> open -> half-open state machine."""

    def __init__(
        self,
        tier: str,
        failure_threshold: int = 3,
        window: int = 16,
        rate_threshold: float = 0.5,
        recovery_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.tier = tier
        self.failure_threshold = max(1, int(failure_threshold))
        self.window = max(2, int(window))
        self.rate_threshold = float(rate_threshold)
        self.recovery_s = float(recovery_s)
        self._clock = clock
        self._mu = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive = 0
        self._outcomes: "deque[bool]" = deque(maxlen=self.window)
        self._opened_t: Optional[float] = None
        self.failures = 0
        self.successes = 0
        self.trips = 0
        self._export_state()

    # -- metrics -------------------------------------------------------
    def _export_state(self) -> None:
        try:
            from mythril_tpu_torch.observe.registry import registry

            registry().gauge(
                "mtpu_breaker_state",
                "tier circuit-breaker state "
                "(0=closed, 1=half-open, 2=open)",
            ).labels(tier=self.tier).set(STATES.index(self._state))
            registry().counter(
                "mtpu_breaker_trips_total",
                "breaker transitions into the open state, by tier",
            ).labels(tier=self.tier).inc(0)
        except Exception:  # telemetry must never sink the tier
            pass

    def _count_trip(self) -> None:
        try:
            from mythril_tpu_torch.observe.registry import registry

            registry().counter(
                "mtpu_breaker_trips_total",
                "breaker transitions into the open state, by tier",
            ).labels(tier=self.tier).inc()
        except Exception:
            pass

    # -- state machine -------------------------------------------------
    @property
    def state(self) -> str:
        with self._mu:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        """Under self._mu: soften open -> half-open once the recovery
        clock has run."""
        if (
            self._state == STATE_OPEN
            and self._opened_t is not None
            and self._clock() - self._opened_t >= self.recovery_s
        ):
            self._state = STATE_HALF_OPEN
            self._export_state()

    def allow(self) -> bool:
        """May the protected tier be attempted right now? Closed and
        half-open (probe) say yes; open says no — the caller routes
        down its ladder instead. Non-consuming: consult freely."""
        with self._mu:
            self._maybe_half_open()
            return self._state != STATE_OPEN

    def record_success(self) -> None:
        with self._mu:
            self.successes += 1
            self._consecutive = 0
            self._outcomes.append(True)
            if self._state == STATE_HALF_OPEN:
                # the probe came back healthy: close and forget
                self._state = STATE_CLOSED
                self._opened_t = None
                self._outcomes.clear()
                self._export_state()
                log.info("breaker [%s] closed after a healthy probe",
                         self.tier)

    def record_failure(self, detail: str = "") -> None:
        with self._mu:
            self.failures += 1
            self._consecutive += 1
            self._outcomes.append(False)
            self._maybe_half_open()
            if self._state == STATE_HALF_OPEN:
                self._trip(f"probe failed: {detail}" if detail else
                           "probe failed")
                return
            if self._state != STATE_CLOSED:
                return
            rate_bad = (
                len(self._outcomes) >= self.window
                and (
                    sum(1 for ok in self._outcomes if not ok)
                    / len(self._outcomes)
                )
                >= self.rate_threshold
            )
            if self._consecutive >= self.failure_threshold or rate_bad:
                self._trip(detail)

    def _trip(self, detail: str = "") -> None:
        """Under self._mu: transition into open."""
        self._state = STATE_OPEN
        self._opened_t = self._clock()
        self.trips += 1
        self._consecutive = 0
        self._export_state()
        self._count_trip()
        log.warning(
            "breaker [%s] OPEN (trip %d)%s — routing around the tier "
            "for %.0fs",
            self.tier, self.trips, f": {detail}" if detail else "",
            self.recovery_s,
        )

    # -- test / operator hooks -----------------------------------------
    def force_open(self) -> None:
        with self._mu:
            if self._state != STATE_OPEN:
                self._trip("forced open")

    def reset(self) -> None:
        with self._mu:
            self._state = STATE_CLOSED
            self._consecutive = 0
            self._outcomes.clear()
            self._opened_t = None
            self._export_state()

    def stats(self) -> Dict:
        with self._mu:
            self._maybe_half_open()
            return {
                "state": self._state,
                "failures": self.failures,
                "successes": self.successes,
                "trips": self.trips,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failure_threshold,
                "recovery_s": self.recovery_s,
            }


# ---------------------------------------------------------------------------
# the process-wide board
# ---------------------------------------------------------------------------
_BOARD: Dict[str, CircuitBreaker] = {}
_BOARD_MU = threading.Lock()


def breaker(tier: str, **kwargs) -> CircuitBreaker:
    """The process-wide breaker for `tier`, created on first use.
    `kwargs` configure a breaker being created (ignored on an existing
    one — use `configure` to re-shape a live breaker)."""
    with _BOARD_MU:
        br = _BOARD.get(tier)
        if br is None:
            br = CircuitBreaker(tier, **kwargs)
            _BOARD[tier] = br
        return br


def configure(tier: str, **kwargs) -> CircuitBreaker:
    """Replace `tier`'s breaker with a freshly-configured one (test /
    smoke hook: shrink thresholds and recovery clocks)."""
    with _BOARD_MU:
        br = CircuitBreaker(tier, **kwargs)
        _BOARD[tier] = br
        return br


def breakers_enabled() -> bool:
    """The --no-breakers switch (rides the global flag bag like the
    static/specialize/store switches)."""
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "breakers", True))


def allow(tier: str) -> bool:
    """One-line guard for call sites: True when breakers are disabled
    or `tier`'s breaker admits the attempt."""
    if not breakers_enabled():
        return True
    return breaker(tier).allow()


def record(tier: str, ok: bool, detail: str = "") -> None:
    """Feed one outcome to `tier`'s breaker (no-op when disabled)."""
    if not breakers_enabled():
        return
    if ok:
        breaker(tier).record_success()
    else:
        breaker(tier).record_failure(detail)


def open_reasons() -> List[str]:
    """`breaker-open:<tier>` for every OPEN breaker — the redline
    entries the HealthMonitor folds into /healthz (half-open probes
    are recovery in progress, not a redline)."""
    with _BOARD_MU:
        board = list(_BOARD.values())
    return [
        f"{REASON_PREFIX}:{br.tier}"
        for br in board
        if br.state == STATE_OPEN
    ]


def board_stats() -> Dict[str, Dict]:
    with _BOARD_MU:
        board = dict(_BOARD)
    return {tier: br.stats() for tier, br in board.items()}


def reset_all() -> None:
    """Test hook: forget every breaker (state and counters)."""
    with _BOARD_MU:
        _BOARD.clear()
