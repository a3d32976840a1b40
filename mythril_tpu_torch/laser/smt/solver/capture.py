"""The solver funnel's end of the query flight recorder.

The port's copy of the JAX package's laser/smt/solver/capture.py.
`check_terms` lowers its constraints deep inside `_check_terms_impl`;
the capture artifact wants exactly that LOWERED set (it is what both
replay engines consume). This module is the thread-local relay: the
impl parks the lowered set here when capture is armed (`note_lowered`),
and the telemetry wrapper turns it into a corpus artifact once the
verdict, wall, origin and loss reason are known (`capture_check`). The
batched device dispatch and the escalation ladder's deferrals bypass
`check_terms`, so the explorer captures its flip-frontier queries with
`capture_flip`.

Everything is a no-op (one boolean check) while capture is off
(`querylog.configure_capture(None)`, the default).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from mythril_tpu_torch.observe import querylog

_TL = threading.local()


def capture_active() -> bool:
    return querylog.capture_enabled()


def note_lowered(lowered: List) -> None:
    """Park the in-flight query's lowered constraint set for the
    wrapper (called by `_check_terms_impl` only when capture is on)."""
    _TL.lowered = list(lowered)


def discard() -> None:
    """Drop any parked set (wrapper entry): an impl that raised mid-
    query must not leak ITS lowered set into the next query's
    artifact."""
    _TL.lowered = None


def capture_check(
    verdict: str,
    engine: str,
    wall_s: float,
    hop: int = 0,
    loss_reason: Optional[str] = None,
) -> None:
    """Capture the query that just left `check_terms` (wrapper side).
    Consumes the parked lowered set either way so a query whose
    capture raced a `configure_capture(None)` never leaks into the
    next one."""
    lowered = getattr(_TL, "lowered", None)
    _TL.lowered = None
    if lowered is None or not capture_active():
        return
    querylog.capture_query(
        lowered,
        engine=engine,
        verdict=verdict,
        wall_s=wall_s,
        hop=hop,
        loss_reason=loss_reason,
        site="check_terms",
    )


def capture_flip(
    lowered: List,
    verdict: str,
    wall_s: float,
    hop: int = 1,
    loss_reason: Optional[str] = None,
    engine: str = "device-portfolio",
    site: str = "device_solve_batch",
    detail: Optional[dict] = None,
) -> None:
    """Capture one flip-frontier query from the explorer's funnel —
    the batched device dispatch AND the escalation ladder's
    sprint-cap exits bypass `check_terms`, so the wrapper hook never
    sees them. `detail` carries e.g. the actual sprint cap behind a
    SPRINT_PREEMPTED loss."""
    if not capture_active():
        return
    querylog.capture_query(
        lowered,
        engine=engine,
        verdict=verdict,
        wall_s=wall_s,
        hop=hop,
        loss_reason=loss_reason,
        site=site,
        origin=querylog.QUERY_ORIGIN_FLIP,
        detail=detail,
    )
