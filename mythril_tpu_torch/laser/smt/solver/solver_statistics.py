"""Query counting + cumulative solver time, and the race's scorecard.

The port's copy of the JAX package's
laser/smt/solver/solver_statistics.py (reference parity:
mythril/laser/smt/solver/solver_statistics.py:8-43, the
`SolverStatistics` singleton + `stat_smt_query` decorator). The JAX
package backs every field with an ``mtpu_solver_stats_*`` series of its
metrics registry; the port keeps them as plain in-process counters
(the registry-backed view is still to be ported: ROADMAP Queue 1 item 4).

Beside the JAX fields the port counts the device race's starts and its
errors (`race_started`, `race_errors`): a race that raised, rather than
finishing with or without a witness, is an error the caller must see,
never a quiet loss (device_race.py).
"""

from __future__ import annotations

import threading
import time
from functools import wraps

from mythril_tpu_torch.support.support_utils import Singleton

_FIELDS = (
    # queries through the public Solver/Optimize surface, and their wall
    "query_count", "solver_time",
    # where sat verdicts came from: the device portfolio vs the native
    # CDCL completeness path
    "device_sat_count", "cdcl_sat_count",
    # queries never posed because the device prepass held a concrete
    # execution of the branch direction
    "device_cert_count",
    # device-race outcomes (device_race.py): started, won by the
    # portfolio, lost to the CDCL (or finished empty), raised
    "race_started", "race_wins", "race_losses", "race_errors",
    # check_terms' wall in the CDCL sprint and in the marathon (with
    # its race), in seconds
    "sprint_time", "marathon_time",
)


class SolverStatistics(object, metaclass=Singleton):
    """Solver query stats; `enabled` turns on `stat_smt_query`'s count."""

    def __init__(self):
        self.enabled = False
        self._mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        for name in _FIELDS:
            setattr(self, name, 0.0 if name.endswith("_time") else 0)

    def bump(self, name: str, n=1) -> None:
        """Add `n` to a field under the lock (the race thread and the
        caller's thread both count)."""
        with self._mu:
            setattr(self, name, getattr(self, name) + n)

    def __repr__(self):
        return (
            f"Solver statistics:\n"
            f"Query count: {self.query_count}\n"
            f"Solver time: {self.solver_time}\n"
            f"Sat verdicts from device portfolio: {self.device_sat_count}\n"
            f"Sat verdicts from CDCL: {self.cdcl_sat_count}\n"
            f"Device races started/won/lost/errors: {self.race_started}/"
            f"{self.race_wins}/{self.race_losses}/{self.race_errors}\n"
            f"Queries preempted by device execution certificates: "
            f"{self.device_cert_count}"
        )


def stat_smt_query(func):
    """Measure and count every solver query routed through `func`."""
    stat_store = SolverStatistics()

    @wraps(func)
    def function_wrapper(*args, **kwargs):
        if not stat_store.enabled:
            return func(*args, **kwargs)
        stat_store.bump("query_count")
        begin = time.time()
        try:
            return func(*args, **kwargs)
        finally:
            stat_store.bump("solver_time", time.time() - begin)

    return function_wrapper
