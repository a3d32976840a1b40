"""Telemetry of the port: the solver's loss-reason taxonomy and query
capture (querylog.py), structured spans and the flight recorder
(spans.py). The metrics registry of the JAX package's observe/ is not
ported yet.

`set_enabled(False)` (the JAX package's `--no-observe`) turns span
recording into a near-zero-cost no-op."""

_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)
