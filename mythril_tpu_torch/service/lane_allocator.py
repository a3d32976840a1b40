"""Lane-stripe allocation for the persistent analysis arena.

The service's device arena is ONE fixed-shape StateBatch (the shape is
what keeps the jit'd run kernel warm), carved into `stripes` equal
stripes of `lanes_per_stripe` lanes. A job owns one or more stripes
for its device phase and releases them the moment its exploration
finishes — between two waves, not between two corpus runs — which is
what lets the next queued contract join the very next wave
(continuous lane-level batching, the service counterpart of
continuous batching in LLM serving).

With `groups > 1` (myth serve --devices N) the stripes split into
contiguous per-device-group blocks: each group dispatches its own
wave over its own block (service/engine.py runs one dispatch/harvest
pair per group), so a job's stripes must all live in ONE group, and
admission stripes jobs over the groups least-loaded-first — the
static half of the mesh balance; the engine's job migration
(_rebalance) is the live half.

Stripes need not be contiguous within a group: every lane carries its
own code-table row id, so the allocator is a plain free-list +
occupancy ledger with no compaction. Pure host-side bookkeeping.

The port's copy of the JAX package's service/lane_allocator.py (the
port's engine runs one group: `serve --devices N>1` is refused)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class LaneAllocator:
    """Free-list allocator over `stripes` stripes of
    `lanes_per_stripe` lanes each, optionally split into `groups`
    contiguous device-group blocks."""

    def __init__(
        self, stripes: int, lanes_per_stripe: int, groups: int = 1
    ) -> None:
        if stripes < 1 or lanes_per_stripe < 1:
            raise ValueError(
                f"arena wants >=1 stripe of >=1 lane, got "
                f"{stripes}x{lanes_per_stripe}"
            )
        if groups < 1 or stripes % groups:
            raise ValueError(
                f"{stripes} stripes do not split evenly into "
                f"{groups} device group(s) — size the arena to the mesh"
            )
        self.stripes = stripes
        self.lanes_per_stripe = lanes_per_stripe
        self.groups = groups
        self.stripes_per_group = stripes // groups
        self._free: List[int] = list(range(stripes))
        self._owner: Dict[int, str] = {}  # stripe -> job id
        self._lock = threading.Lock()
        # high-water marks for /stats: how coalesced the waves actually
        # ran (the acceptance signal that concurrent jobs share waves)
        self.max_jobs_resident = 0
        self.max_lanes_busy = 0

    @property
    def n_lanes(self) -> int:
        return self.stripes * self.lanes_per_stripe

    @property
    def lanes_per_group(self) -> int:
        return self.stripes_per_group * self.lanes_per_stripe

    def group_of(self, stripe: int) -> int:
        return stripe // self.stripes_per_group

    def lanes_of(self, stripe: int) -> List[int]:
        base = stripe * self.lanes_per_stripe
        return list(range(base, base + self.lanes_per_stripe))

    def group_lanes(self, group: int) -> List[int]:
        base = group * self.lanes_per_group
        return list(range(base, base + self.lanes_per_group))

    def stripes_needed(self, lanes: int) -> int:
        """Smallest stripe count covering a lane request (ceil)."""
        return max(1, -(-int(lanes) // self.lanes_per_stripe))

    def _free_by_group(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {g: [] for g in range(self.groups)}
        for stripe in self._free:
            out[self.group_of(stripe)].append(stripe)
        return out

    def allocate(
        self, job_id: str, n_stripes: int = 1, group: Optional[int] = None
    ) -> Optional[List[int]]:
        """Claim `n_stripes` stripes for `job_id`, or None when no
        group can fit the request right now (the job stays queued and
        retries at the next wave boundary). All-or-nothing AND
        single-group: a job striped across groups would need its wave
        split across two dispatch streams. With `group`, the grant is
        pinned (the engine's job migration targets an idle group);
        otherwise the least-loaded group with room wins — admission
        stripes jobs over the device groups."""
        if n_stripes > self.stripes_per_group:
            raise ValueError(
                f"job {job_id} wants {n_stripes} stripes; a device "
                f"group holds {self.stripes_per_group} — resize the "
                f"arena (or drop --devices), not the request"
            )
        with self._lock:
            by_group = self._free_by_group()
            if group is not None:
                candidates = [group]
            else:
                # least busy first (fewest owned stripes), gid breaks
                # ties so the layout is deterministic
                candidates = sorted(
                    range(self.groups),
                    key=lambda g: (
                        self.stripes_per_group - len(by_group[g]),
                        g,
                    ),
                )
            chosen = next(
                (
                    g
                    for g in candidates
                    if len(by_group.get(g, [])) >= n_stripes
                ),
                None,
            )
            if chosen is None:
                return None
            granted = by_group[chosen][:n_stripes]
            for stripe in granted:
                self._free.remove(stripe)
                self._owner[stripe] = job_id
            jobs = len(set(self._owner.values()))
            self.max_jobs_resident = max(self.max_jobs_resident, jobs)
            self.max_lanes_busy = max(
                self.max_lanes_busy, len(self._owner) * self.lanes_per_stripe
            )
            return granted

    def release(self, stripes: List[int]) -> None:
        with self._lock:
            for stripe in stripes:
                if stripe in self._owner:
                    del self._owner[stripe]
                    self._free.append(stripe)
            self._free.sort()

    def owner_of(self, stripe: int) -> Optional[str]:
        with self._lock:
            return self._owner.get(stripe)

    def jobs_in_group(self, group: int) -> List[str]:
        """Distinct job ids resident in `group`, in stripe order."""
        with self._lock:
            seen = []
            for stripe in sorted(self._owner):
                if self.group_of(stripe) == group:
                    job = self._owner[stripe]
                    if job not in seen:
                        seen.append(job)
            return seen

    def occupancy(self) -> Dict:
        """The /stats view: stripe/lane busy counts plus high-water
        marks (max_jobs_resident > 1 is the proof that concurrent
        requests coalesced into shared waves) and the per-group
        occupancy the mesh counters surface."""
        with self._lock:
            busy = len(self._owner)
            per_group = []
            for g in range(self.groups):
                owned = [
                    s for s in self._owner if self.group_of(s) == g
                ]
                per_group.append(
                    {
                        "group": g,
                        "stripes_busy": len(owned),
                        "stripes": self.stripes_per_group,
                        "jobs_resident": len(
                            {self._owner[s] for s in owned}
                        ),
                    }
                )
            return {
                "stripes": self.stripes,
                "lanes_per_stripe": self.lanes_per_stripe,
                "lanes": self.n_lanes,
                "stripes_busy": busy,
                "lanes_busy": busy * self.lanes_per_stripe,
                "jobs_resident": len(set(self._owner.values())),
                "max_jobs_resident": self.max_jobs_resident,
                "max_lanes_busy": self.max_lanes_busy,
                "groups": per_group,
            }
