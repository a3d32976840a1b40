"""Execution-info record interface (the port's copy of the JAX
package's laser/execution_info.py; reference:
mythril/laser/execution_info.py)."""

from abc import ABC, abstractmethod


class ExecutionInfo(ABC):
    @abstractmethod
    def as_dict(self):
        """A primitive-types-only dictionary describing this record."""
