"""Per-job journey tracing: the tier-ladder timeline of one analysis
request.

Every job travels a ladder of tiers — admission, then either an
instant settle (verdict-store hit / static answer) or the full path
(queued -> lane grant -> device waves -> solver escalations -> host
walk -> settle). The flight recorder (spans.py) holds *spans*; this
module holds the sparse, per-job **tier-transition events** that turn
those spans into an answerable question: "what happened to job X, in
order, with timestamps".

- `journey_event(journey_id, tier, event, **attrs)` records one
  transition (a lock + dict append; honors the global observe
  switch).
- `assemble(journey_id)` builds the timeline document served at
  ``/v1/jobs/<id>/trace``: ordered events, the distinct tier
  sequence, per-tier dwell, and any flight-recorder spans tagged
  with this journey (``trace(..., job=<id>)``).
The log is bounded (journeys evicted oldest-first past the capacity)
— it is an operational instrument, not an archive.

The port's copy of the JAX package's observe/journey.py (whose
journey_id also rides the routing JSONL; the port has no routing log).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

#: journey/timeline document schema version (pinned by the service
#: journey tests and docs/observability.md)
SCHEMA_VERSION = 1

#: the tier vocabulary, in ladder order (stable wire schema)
TIER_ADMISSION = "admission"
TIER_STORE_HIT = "store-hit"
TIER_STATIC_ANSWER = "static-answer"
TIER_QUEUED = "queued"
TIER_LANE_GRANT = "lane-grant"
TIER_WAVE = "wave"
TIER_SOLVER = "solver"
TIER_HOST_WALK = "host-walk"
TIER_SETTLE = "settle"
TIERS = (
    TIER_ADMISSION, TIER_STORE_HIT, TIER_STATIC_ANSWER, TIER_QUEUED,
    TIER_LANE_GRANT, TIER_WAVE, TIER_SOLVER, TIER_HOST_WALK, TIER_SETTLE,
)


def new_journey_id() -> str:
    """A journey id for paths with no natural job id (the corpus
    driver); service jobs reuse their job id so the trace endpoint
    needs no mapping."""
    return uuid.uuid4().hex[:16]


class JourneyLog:
    """Bounded process-wide map journey_id -> ordered event list."""

    def __init__(self, capacity: int = 1024) -> None:
        self._mu = threading.Lock()
        self._events: "OrderedDict[str, List[Dict]]" = OrderedDict()
        self.capacity = max(16, capacity)
        self.recorded = 0

    def event(
        self, journey_id: str, tier: str, event: str, **attrs
    ) -> None:
        from mythril_tpu_torch import observe

        if not observe.enabled() or not journey_id:
            return
        row = {
            "t": round(time.perf_counter(), 6),
            "tier": tier,
            "event": event,
        }
        if attrs:
            row["attrs"] = {
                k: v for k, v in attrs.items() if v is not None
            }
        with self._mu:
            bucket = self._events.get(journey_id)
            if bucket is None:
                bucket = self._events[journey_id] = []
                while len(self._events) > self.capacity:
                    self._events.popitem(last=False)
            bucket.append(row)
            self.recorded += 1

    def events(self, journey_id: str) -> List[Dict]:
        with self._mu:
            return list(self._events.get(journey_id) or ())

    def known(self, journey_id: str) -> bool:
        with self._mu:
            return journey_id in self._events

    def clear(self) -> None:
        with self._mu:
            self._events.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._events)


_LOG = JourneyLog()


def journey_log() -> JourneyLog:
    return _LOG


def journey_event(journey_id: str, tier: str, event: str, **attrs) -> None:
    """Record one tier transition on the process journey log."""
    _LOG.event(journey_id, tier, event, **attrs)


def tier_sequence(events: List[Dict]) -> List[str]:
    """The distinct tiers in first-touch order — the compact ladder
    fingerprint the tests pin ("admission, store-hit, settle" vs
    "admission, queued, lane-grant, wave, settle")."""
    seen: List[str] = []
    for row in events:
        tier = row.get("tier")
        if tier and (not seen or seen[-1] != tier) and tier not in seen:
            seen.append(tier)
    return seen


def assemble(
    journey_id: str, spans: Optional[List] = None
) -> Optional[Dict]:
    """The journey/timeline document for one id, or None when the id
    is unknown. `spans` defaults to the flight recorder's tail; spans
    whose attrs carry ``job == journey_id`` are attached (the host
    walk, per-job solver escalations)."""
    events = _LOG.events(journey_id)
    if not events:
        return None
    if spans is None:
        from mythril_tpu_torch.observe.spans import flight_recorder

        spans = flight_recorder().tail(4096)
    t0 = events[0]["t"]
    t1 = events[-1]["t"]
    tiers = tier_sequence(events)
    # per-tier dwell: time from a tier's first event to the next
    # tier's first event (the last tier dwells to the final event)
    first_touch: Dict[str, float] = {}
    for row in events:
        first_touch.setdefault(row["tier"], row["t"])
    dwell: Dict[str, float] = {}
    for i, tier in enumerate(tiers):
        end = (
            first_touch[tiers[i + 1]] if i + 1 < len(tiers) else t1
        )
        dwell[tier] = round(max(0.0, end - first_touch[tier]), 6)
    doc = {
        "schema_version": SCHEMA_VERSION,
        "journey_id": journey_id,
        "tiers": tiers,
        "tier_dwell_s": dwell,
        "events": events,
        "wall_s": round(t1 - t0, 6),
    }
    attached = [
        span.as_dict()
        for span in spans
        if span.attrs and span.attrs.get("job") == journey_id
    ]
    if attached:
        doc["spans"] = attached
    return doc
