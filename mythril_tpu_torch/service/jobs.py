"""Job model + bounded admission queue for the analysis service.

A job is one contract analysis request travelling through the service:

    QUEUED -> RUNNING (device waves) -> ANALYZING (host walk)
           -> DONE | FAILED | CHECKPOINTED

CHECKPOINTED is the drain outcome: the service was asked to stop
(SIGTERM) before the job finished, so its seeded device frontier was
flushed to a replayable npz (laser/batch/checkpoint.py) instead of
being dropped — the accepted-work-is-never-lost half of the drain
contract.

The queue is the admission controller: bounded capacity, reject-on-full
(the HTTP layer turns a rejection into 429, and a draining server into
503) — backpressure instead of unbounded memory growth under a traffic
spike. Everything here is plain threading.

The port's copy of the JAX package's service/jobs.py, less the durable
journal's hooks (service/journal.py is not ported: `serve --journal`
is refused)."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional

from mythril_tpu_torch.observe import journey
from mythril_tpu_torch.observe.journey import journey_event
from mythril_tpu_torch.support.resilience import Deadline


class JobState:
    QUEUED = "queued"
    RUNNING = "running"  # resident in the device arena
    ANALYZING = "analyzing"  # device phase done; host walk in flight
    DONE = "done"
    FAILED = "failed"
    CHECKPOINTED = "checkpointed"

    TERMINAL = (DONE, FAILED, CHECKPOINTED)


class Job:
    """One analysis request. Mutated only under the queue's lock (the
    engine and the HTTP layer both go through JobQueue accessors)."""

    def __init__(
        self,
        code_hex: str,
        max_waves: Optional[int] = None,
        deadline_s: Optional[float] = None,
        host_walk: Optional[bool] = None,
        lanes: Optional[int] = None,
        idempotency_key: Optional[str] = None,
        frontier: Optional[Dict] = None,
    ) -> None:
        code_hex = code_hex[2:] if code_hex.startswith("0x") else code_hex
        self.code = bytes.fromhex(code_hex)  # raises ValueError on junk
        if not self.code:
            raise ValueError("empty bytecode")
        self.id = uuid.uuid4().hex[:12]
        self.state = JobState.QUEUED
        self.created_t = time.monotonic()
        self.started_t: Optional[float] = None
        self.device_done_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.max_waves = max_waves
        self.host_walk = host_walk
        self.lanes = lanes
        #: the per-request budget the PR-1 supervisor enforces at every
        #: wave boundary and clamps the host walk to
        self.deadline = None if deadline_s is None else Deadline(
            deadline_s, label=f"job-{self.id}"
        )
        self.report: Optional[Dict] = None
        self.error: Optional[str] = None
        self.checkpoint_path: Optional[str] = None
        self.waves = 0
        self.degraded: List[str] = []
        #: client-supplied dedupe key: a retried submit — same key —
        #: after a connection drop maps back to the SAME job instead of
        #: double-running
        self.idempotency_key = idempotency_key
        #: the tier-ladder timeline key (observe/journey.py): service
        #: jobs reuse the job id so /v1/jobs/<id>/trace needs no map
        self.journey_id = self.id
        #: cost-model routing (routing/): the tier the router picked at
        #: admission ("host-walk"), the promotion target when that tier
        #: overran its predicted budget ("device-waves"), and the budget
        #: itself; the routing record settles as routed-<tier> /
        #: promoted-<tier>
        self.routed: Optional[str] = None
        self.promoted: Optional[str] = None
        self.route_budget_s: Optional[float] = None
        #: a donor replica's exploration frontier (the shape
        #: explore.py export_frontier packs / GET /v1/frontier/export
        #: serves): covered branch directions + parent inputs seeded
        #: into this job's track so a rebalanced job CONTINUES the
        #: donor's exploration instead of restarting it
        self.frontier = frontier

    @property
    def terminal(self) -> bool:
        return self.state in JobState.TERMINAL

    def as_dict(self) -> Dict:
        now = time.monotonic()
        out = {
            "job_id": self.id,
            "state": self.state,
            "waves": self.waves,
            "age_s": round(now - self.created_t, 3),
            "code_len": len(self.code),
        }
        if self.finished_t is not None:
            out["latency_s"] = round(self.finished_t - self.created_t, 3)
        if self.error:
            out["error"] = self.error
        if self.checkpoint_path:
            out["checkpoint"] = self.checkpoint_path
        if self.degraded:
            out["degraded"] = list(self.degraded)
        if self.routed:
            out["routed"] = self.routed
        if self.promoted:
            out["promoted"] = self.promoted
        if self.report is not None:
            out["report"] = self.report
        return out


class JobQueue:
    """Bounded FIFO + registry of every job the service ever accepted.

    `submit` is the single admission point: it refuses when the queue
    is full (backpressure) or the service is draining (shutdown), and
    the refusal carries the reason so the HTTP layer can pick the
    status code. Accepted jobs stay in the registry for their whole
    lifetime; `settle` moves them to a terminal state and wakes any
    long-poll waiter."""

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = max(1, int(capacity))
        self._pending: List[Job] = []
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()
        self._settled = threading.Condition(self._lock)
        self.draining = False
        # admission counters for /stats
        self.accepted = 0
        self.rejected_full = 0
        self.rejected_draining = 0

    def submit(self, job: Job) -> None:
        """Admit `job` or raise QueueRefusal with the backpressure
        reason."""
        from mythril_tpu_torch.observe.registry import registry

        admissions = registry().counter(
            "mtpu_service_admissions_total",
            "service job admissions by outcome "
            "(accepted / rejected-full / rejected-draining)",
        )
        with self._lock:
            if self.draining:
                self.rejected_draining += 1
                admissions.labels(outcome="rejected-draining").inc()
                raise QueueRefusal("draining", "service is draining")
            if len(self._pending) >= self.capacity:
                self.rejected_full += 1
                admissions.labels(outcome="rejected-full").inc()
                raise QueueRefusal(
                    "full", f"queue full ({self.capacity} pending)"
                )
            self.accepted += 1
            admissions.labels(outcome="accepted").inc()
            self._pending.append(job)
            self._jobs[job.id] = job
            self._settled.notify_all()
        journey_event(
            job.journey_id, journey.TIER_QUEUED, "enqueued",
            depth=len(self._pending),
        )

    def register(self, job: Job) -> None:
        """Admit `job` into the registry WITHOUT a pending-queue slot:
        the static-answer triage path — the job is about to be settled
        DONE by the caller and will never occupy the arena, so a full
        queue is no reason to refuse it. Draining still refuses (the
        service is going away)."""
        from mythril_tpu_torch.observe.registry import registry

        admissions = registry().counter(
            "mtpu_service_admissions_total",
            "service job admissions by outcome "
            "(accepted / rejected-full / rejected-draining)",
        )
        with self._lock:
            if self.draining:
                self.rejected_draining += 1
                admissions.labels(outcome="rejected-draining").inc()
                raise QueueRefusal("draining", "service is draining")
            self.accepted += 1
            admissions.labels(outcome="accepted").inc()
            self._jobs[job.id] = job
            self._settled.notify_all()

    def claim(self, limit: int) -> List[Job]:
        """Pop up to `limit` queued jobs for arena admission (FIFO) and
        mark them RUNNING. The engine calls this between waves."""
        out: List[Job] = []
        with self._lock:
            while self._pending and len(out) < limit:
                job = self._pending.pop(0)
                job.state = JobState.RUNNING
                job.started_t = time.monotonic()
                out.append(job)
        for job in out:
            journey_event(
                job.journey_id, journey.TIER_QUEUED, "claimed",
                queued_s=round(job.started_t - job.created_t, 6),
            )
        return out

    def unclaim(self, job: Job) -> None:
        """Return a claimed job to the queue head (the arena couldn't
        fit it this wave)."""
        with self._lock:
            job.state = JobState.QUEUED
            job.started_t = None
            self._pending.insert(0, job)

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def nonterminal(self) -> List[Job]:
        """Every accepted job not yet in a terminal state, in
        admission order — the population GET /v1/frontier/export hands
        to the fleet front for cross-host rebalancing."""
        with self._lock:
            return [j for j in self._jobs.values() if not j.terminal]

    def settle(self, job: Job, state: str) -> None:
        from mythril_tpu_torch.observe.registry import LATENCY_BUCKETS, registry

        reg = registry()
        reg.counter(
            "mtpu_service_jobs_settled_total",
            "jobs reaching a terminal state, by state",
        ).labels(state=state).inc()
        with self._lock:
            job.state = state
            job.finished_t = time.monotonic()
            # the warm-tier ladder: settle latency spans ~1.9ms store
            # hits to ~21s cold walks, so the histogram gets its own
            # sub-5ms-resolving buckets (ISSUE 12)
            reg.histogram(
                "mtpu_service_job_latency_seconds",
                "submit-to-terminal latency",
                buckets=LATENCY_BUCKETS,
            ).observe(job.finished_t - job.created_t)
            # the settle tier event lands BEFORE waiters wake: a
            # client that saw the terminal state must find the full
            # journey at /v1/jobs/<id>/trace
            journey_event(
                job.journey_id, journey.TIER_SETTLE, state,
                latency_s=round(job.finished_t - job.created_t, 6),
            )
            self._settled.notify_all()

    def mark(self, job: Job, state: str) -> None:
        with self._lock:
            job.state = state
            self._settled.notify_all()

    def wait_terminal(self, job_id: str, timeout_s: float) -> Optional[Job]:
        """Block until `job_id` reaches a terminal state (long-poll
        support), returning the job (or None when unknown)."""
        end = time.monotonic() + timeout_s
        with self._lock:
            while True:
                job = self._jobs.get(job_id)
                if job is None or job.terminal:
                    return job
                left = end - time.monotonic()
                if left <= 0:
                    return job
                self._settled.wait(left)

    def drain_remaining(self) -> List[Job]:
        """Flip to draining (new submissions refuse) and hand back every
        still-queued job for checkpointing."""
        with self._lock:
            self.draining = True
            out, self._pending = self._pending, []
            return out

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def jobs_by_state(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for job in self._jobs.values():
                out[job.state] = out.get(job.state, 0) + 1
            return out


class QueueRefusal(Exception):
    """Admission refused; `reason` is 'full' (HTTP 429) or 'draining'
    (HTTP 503)."""

    def __init__(self, reason: str, message: str) -> None:
        super().__init__(message)
        self.reason = reason
