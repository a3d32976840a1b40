"""Execution-time budget shared across the engine.

The port's copy of the JAX package's laser/ethereum/time_handler.py
(reference parity: mythril/laser/ethereum/time_handler.py:5-18): a
singleton started by the analysis; support/model.py clamps every solver
call to the remaining budget so no query outlives the run.
"""

from __future__ import annotations

import time

from mythril_tpu_torch.support.support_utils import Singleton


class TimeHandler(object, metaclass=Singleton):
    def __init__(self):
        self.start_time = None
        self.execution_time = None

    def start_execution(self, execution_time_seconds: int) -> None:
        self.start_time = int(time.time() * 1000)
        self.execution_time = execution_time_seconds * 1000

    def time_remaining(self) -> int:
        """Milliseconds left in the budget (large if never started)."""
        if self.start_time is None:
            return 2**31
        return self.execution_time - (int(time.time() * 1000) - self.start_time)


time_handler = TimeHandler()
