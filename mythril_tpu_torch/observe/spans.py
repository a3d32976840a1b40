"""Structured spans, the flight recorder and its Perfetto export.

The port's copy of the JAX package's observe/spans.py: the analysis
service serves the recent tail at ``/trace`` (``?format=perfetto`` for
a Chrome/Perfetto trace-event document, `to_perfetto`), and a drained
service leaves the ring beside its checkpoints (`export_trace`).

`trace(name, **attrs)` opens one span: monotonic start/end timestamps,
the caller's thread, an optional device-group *track*, and a parent
link (a thread-local stack gives nesting for free), recorded into a
bounded ring buffer — the **flight recorder**. The recorder is always
cheap (a deque append under a lock, nothing per step) and bounded, so
it can run in production and be read on demand (`tail`).

The explorer's spans:

    explore.run > phase > {wave.dispatch, wave.harvest, wave.consume,
    flip.solve.host, flip.solve.device}

and `wave.device` (dispatch to readback-ready, recorded after the fact
with `FlightRecorder.add` on the "device" track).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_IDS = itertools.count(1)
_TLS = threading.local()


class Span:
    """One closed span. Timestamps are `time.perf_counter()` seconds
    (monotonic, process-local)."""

    __slots__ = ("sid", "parent", "name", "t0", "t1", "tid", "track", "attrs")

    def __init__(self, sid, parent, name, t0, t1, tid, track, attrs) -> None:
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.track = track
        self.attrs = attrs

    def as_dict(self) -> Dict:
        out = {
            "sid": self.sid,
            "parent": self.parent,
            "name": self.name,
            "t0": round(self.t0, 6),
            "t1": round(self.t1, 6),
            "dur_s": round(self.t1 - self.t0, 6),
            "thread": self.tid,
        }
        if self.track is not None:
            out["track"] = self.track
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class FlightRecorder:
    """Bounded ring of closed spans (newest win; the recorder is a
    flight recorder, not an archive)."""

    def __init__(self, capacity: int = 8192) -> None:
        self._mu = threading.Lock()
        self._ring: "deque[Span]" = deque(maxlen=max(16, capacity))
        self.dropped = 0
        self.recorded = 0

    def record(self, span: Span) -> None:
        with self._mu:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
            self.recorded += 1

    def add(
        self,
        name: str,
        t0: float,
        t1: float,
        track: Optional[str] = None,
        **attrs,
    ) -> None:
        """Record a RETROSPECTIVE span from explicit timestamps — the
        idiom for device execution, whose start (dispatch) and end
        (readback-ready) are observed on the host at different call
        sites."""
        from mythril_tpu_torch import observe

        if not observe.enabled():
            return
        self.record(
            Span(
                next(_IDS), None, name, t0, t1,
                threading.current_thread().name, track, attrs or None,
            )
        )

    def tail(self, n: int = 512) -> List[Span]:
        with self._mu:
            spans = list(self._ring)
        return spans[-n:]

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _RECORDER


def _stack() -> List[int]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class _TraceCtx:
    """The `trace()` context manager: pushes a span id on the thread's
    stack at entry (so children see their parent), records the closed
    span at exit. Exceptions propagate; the span still closes and is
    marked with the exception type."""

    __slots__ = ("name", "track", "attrs", "sid", "t0")

    def __init__(self, name: str, track: Optional[str], attrs: Dict) -> None:
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self) -> "_TraceCtx":
        self.sid = next(_IDS)
        self.t0 = time.perf_counter()
        _stack().append(self.sid)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        parent = stack[-1] if stack else None
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs or {}, error=exc_type.__name__)
        _RECORDER.record(
            Span(
                self.sid, parent, self.name, self.t0, t1,
                threading.current_thread().name, self.track, attrs or None,
            )
        )


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullCtx()


def trace(name: str, track: Optional[str] = None, **attrs):
    """Open a structured span. Near-zero-cost no-op while telemetry is
    disabled (one bool check, a shared null context)."""
    from mythril_tpu_torch import observe

    if not observe.enabled():
        return _NULL
    return _TraceCtx(name, track, attrs or None)


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event export
# ---------------------------------------------------------------------------
def to_perfetto(spans: Optional[List[Span]] = None) -> Dict:
    """Render spans as Chrome trace-event JSON (the `traceEvents`
    array form Perfetto loads directly): one complete ("ph": "X")
    event per span with microsecond timestamps, plus thread_name
    metadata so tracks are labeled. Spans with a device-group `track`
    render on that track (device timelines beside host threads)."""
    if spans is None:
        spans = _RECORDER.tail(len(_RECORDER))
    events: List[Dict] = []
    tids: Dict[str, int] = {}

    def tid_of(label: str) -> int:
        tid = tids.get(label)
        if tid is None:
            tid = tids[label] = len(tids) + 1
        return tid

    pid = os.getpid()
    base = min((s.t0 for s in spans), default=0.0)
    for span in spans:
        label = span.track if span.track is not None else span.tid
        events.append(
            {
                "name": span.name,
                "ph": "X",
                "ts": int((span.t0 - base) * 1e6),
                "dur": max(1, int((span.t1 - span.t0) * 1e6)),
                "pid": pid,
                "tid": tid_of(label),
                "args": dict(span.attrs or {}, sid=span.sid,
                             parent=span.parent),
            }
        )
    for label, tid in tids.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": label},
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "mythril_tpu_torch.observe"},
    }


def export_trace(path: str, spans: Optional[List[Span]] = None) -> str:
    """Write the Perfetto JSON to `path` (atomic tmp+rename, the
    checkpoint writer's idiom) and return the path."""
    doc = to_perfetto(spans)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fp:
        json.dump(doc, fp)
    os.replace(tmp, path)
    return path


def overlap_fraction(
    spans: Optional[List[Span]] = None, name: str = "wave.device"
) -> float:
    """Fraction of the covered time that >= 2 spans named `name` were
    simultaneously open — the span-derived pipelining overlap figure
    chip_smoke.py reports for the service's pipelined waves. 0.0 when
    fewer than two such spans exist."""
    if spans is None:
        spans = _RECORDER.tail(len(_RECORDER))
    marks = []
    for span in spans:
        if span.name == name and span.t1 > span.t0:
            marks.append((span.t0, 1))
            marks.append((span.t1, -1))
    if len(marks) < 4:
        return 0.0
    marks.sort()
    covered = overlapped = 0.0
    depth = 0
    prev = marks[0][0]
    for t, d in marks:
        if depth >= 1:
            covered += t - prev
        if depth >= 2:
            overlapped += t - prev
        depth += d
        prev = t
    return round(overlapped / covered, 4) if covered > 0 else 0.0
