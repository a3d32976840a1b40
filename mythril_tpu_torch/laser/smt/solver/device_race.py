"""CPU-vs-card solver race for sprint-unknown queries.

The port's copy of the JAX package's laser/smt/solver/device_race.py.
The reference exposes `--parallel-solving` by turning on z3's internal
thread parallelism (reference: mythril/laser/smt/solver/__init__.py:8-9).
Here two genuinely different engines race on two processors:

- the incremental CDCL session keeps solving on the CPU (complete:
  can prove unsat), in short wall slices;
- the card's portfolio local search (`portfolio.device_check`: one
  portfolio_sls launch, which scores its own candidates) runs the SAME
  query on a daemon thread, on that thread's own CUDA stream
  (incomplete: a witness proves sat, a miss proves nothing).

The thread spends its life waiting on the card and the ctypes CDCL call
releases the GIL, so the race costs the host little. First finisher
wins; a device witness is validated against the original constraints
before it is believed (the same soundness gate every model passes).

At most one race is in flight per process (`_INFLIGHT`), and none
starts while a device exploration holds the card (`DEVICE_BUSY`): a
race queued behind multi-second waves would answer long after the
marathon.

What differs from the JAX race: a race that ends without a witness
passes quietly (the CDCL decides the query), but a race that RAISES (a
kernel build or launch error, or any other exception) is counted in
`SolverStatistics.race_errors` and recorded in the DegradationLog, and
a race with no device named where no CUDA device is present raises at
construction, as `resolve_device(None)` does. The JAX package's
near-miss histogram (``mtpu_solver_race_margin_seconds``, how late a
witness arrived after the host answered) waits for the metrics registry
(ROADMAP Queue 1 item 9).

The race's caller is the host walk (analysis/symbolic.py): its
`check_terms` run on the walk's device wherever no exploration holds
`DEVICE_BUSY`, and `args.device_solving` "never" starts none
(solver.py:device_solving_enabled; the analyzer facade sets it for a
walk beside its overlapped corpus prepass). The explorer's escalation
ladder solves while its exploration holds `DEVICE_BUSY`, so it starts
none.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from mythril_tpu_torch.support.accel import resolve_device


class _BusyCounter:
    """Reentrant chip-occupancy count. A plain Event breaks under
    nesting: a per-contract explorer finishing inside an overlapped
    corpus prepass would clear the flag the prepass still relies on,
    re-enabling races that queue behind multi-second waves."""

    def __init__(self) -> None:
        self._count = 0
        self._mu = threading.Lock()

    def acquire(self) -> None:
        with self._mu:
            self._count += 1

    def release(self) -> None:
        with self._mu:
            if self._count > 0:
                self._count -= 1

    def is_set(self) -> bool:
        with self._mu:
            return self._count > 0


#: chip-occupancy flag: held (counted) while a device exploration owns
#: the card; races started then would queue behind multi-second waves
#: and answer long after the host solve, so they are not started
DEVICE_BUSY = _BusyCounter()

_INFLIGHT = threading.Semaphore(1)

PENDING = "pending"
FAILED = "failed"


class DeviceRace:
    """One asynchronous portfolio attempt on the card.

    poll() is non-blocking and returns PENDING (still searching),
    FAILED (finished without a witness, raised, or never started), or
    the raw {var: value} assignment — which the caller must validate
    via its reconstruction + soundness gate before trusting.

    A race that cannot start because another holds the slot reports
    started=False and the caller's CDCL marathon proceeds alone.
    """

    def __init__(
        self,
        lowered: List,
        candidates: int = 32,
        steps: int = 256,
        device=None,
    ) -> None:
        from mythril_tpu_torch.laser.smt.solver.solver_statistics import (
            SolverStatistics,
        )

        # on the caller's thread: no card and no device named raises
        self._device = resolve_device(device)
        self._done = threading.Event()
        self._assignment: Optional[Dict[str, int]] = None
        self.error: Optional[BaseException] = None
        self._started = _INFLIGHT.acquire(blocking=False)
        if not self._started:
            self._done.set()
            return
        SolverStatistics().bump("race_started")
        try:
            self._thread = threading.Thread(
                target=self._work,
                args=(list(lowered), candidates, steps),
                daemon=True,
                name="device-race",
            )
            self._thread.start()
        except Exception as why:  # e.g. "can't start new thread"
            self._fail(why)
            self._started = False
            self._done.set()
            _INFLIGHT.release()

    def _fail(self, why: BaseException) -> None:
        """Count and record a race that raised: never a quiet loss."""
        from mythril_tpu_torch.laser.smt.solver.solver_statistics import (
            SolverStatistics,
        )
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        self.error = why
        SolverStatistics().bump("race_errors")
        DegradationLog().record(
            DegradationReason.DEVICE_RACE_FAILED,
            site="device-race",
            detail=f"{type(why).__name__}: {why}",
        )

    def _work(self, lowered: List, candidates: int, steps: int) -> None:
        import torch

        from mythril_tpu_torch.laser.smt.solver import portfolio

        try:
            if self._device.type == "cuda":
                with torch.cuda.device(self._device), torch.cuda.stream(
                    torch.cuda.Stream(self._device)
                ):
                    self._assignment = portfolio.device_check(
                        lowered, candidates=candidates, steps=steps,
                        device=self._device,
                    )
            else:
                self._assignment = portfolio.device_check(
                    lowered, candidates=candidates, steps=steps,
                    device=self._device,
                )
        except Exception as why:
            self._assignment = None
            self._fail(why)
        finally:
            self._done.set()
            _INFLIGHT.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the race has finished (or `timeout` seconds)."""
        return self._done.wait(timeout)

    def poll(self):
        if not self._done.is_set():
            return PENDING
        if self._assignment is None:
            return FAILED
        return self._assignment

    def outcome(self) -> str:
        """Where the race stands RIGHT NOW, without consuming it:
        "pending" (portfolio still searching), "failed" (finished
        without a witness, or raised), "witness" (finished with one).
        The loss attribution reads this when the CDCL answers first."""
        if not self._done.is_set():
            return "pending"
        return "failed" if self._assignment is None else "witness"

    @property
    def started(self) -> bool:
        return self._started


def race_available() -> bool:
    """A race may start: the chip is not owned by an exploration and
    no other race is in flight (checked again, atomically, at start)."""
    return not DEVICE_BUSY.is_set()


def wait_idle(timeout: Optional[float] = None) -> bool:
    """Block until no race is in flight (or `timeout` seconds); True
    when none is."""
    if not _INFLIGHT.acquire(timeout=timeout):
        return False
    _INFLIGHT.release()
    return True
