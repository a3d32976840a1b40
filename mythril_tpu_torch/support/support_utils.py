"""General utility objects: the Singleton metaclass.

The port's copy of the JAX package's support/support_utils.Singleton
(reference parity: mythril/support/support_utils.py:9-19).
"""

from __future__ import annotations

from typing import Dict


class Singleton(type):
    """A metaclass type implementing the singleton pattern.

    As in the reference, instances are per-process and not thread- or
    process-safe (reference: support/support_utils.py:16-19).
    """

    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super(Singleton, cls).__call__(*args, **kwargs)
        return cls._instances[cls]
