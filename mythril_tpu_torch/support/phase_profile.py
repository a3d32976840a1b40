"""Per-phase wall-clock accounting for the analysis pipeline.

The port's copy of the part of the JAX package's
support/phase_profile.py that `support/model.py:get_model` writes: the
"solve" phase (every get_model call). The JAX package backs it with the
metrics registry's ``mtpu_phase_wall_seconds`` histogram and reports it
per contract; the port keeps plain in-process totals until the registry
is ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

from mythril_tpu_torch.support.support_utils import Singleton


class PhaseProfile(object, metaclass=Singleton):
    """Per-phase wall seconds and counts over the process."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._totals: Dict[str, list] = {}

    @contextmanager
    def measure(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            with self._mu:
                row = self._totals.setdefault(phase, [0.0, 0])
                row[0] += wall
                row[1] += 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._mu:
            return {phase: {"wall_s": round(wall, 3), "count": count}
                    for phase, (wall, count) in sorted(self._totals.items())}
