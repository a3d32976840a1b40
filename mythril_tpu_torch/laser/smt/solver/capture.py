"""The explorer's end of the query flight recorder.

The part of the JAX package's laser/smt/solver/capture.py that the
port's explorer calls: `capture_flip`. The batched device dispatch and
the escalation ladder's deferrals bypass `check_terms`, so the explorer
captures its flip-frontier queries here. The `check_terms` relay
(`note_lowered`, `capture_check`) comes with the host solver ladder.

A no-op (one boolean check) while capture is off
(`querylog.configure_capture(None)`, the default).
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.observe import querylog


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
    if not querylog.capture_enabled():
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
