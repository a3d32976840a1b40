"""General utility objects: the Singleton metaclass and code hashing.

The port's copy of the JAX package's support/support_utils.Singleton and
get_code_hash (reference parity: mythril/support/support_utils.py:9-41).
"""

from __future__ import annotations

from typing import Dict

from mythril_tpu_torch.support.keccak import keccak256


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


def get_code_hash(code) -> str:
    """keccak of the runtime bytecode as '0x...' hex.

    Accepts '0x'-prefixed hex strings or raw bytes
    (reference: support/support_utils.py:22-41 get_code_hash).
    """
    if isinstance(code, str):
        code = code[2:] if code.startswith("0x") else code
        try:
            code = bytes.fromhex(code)
        except ValueError:
            return hex(hash(code))  # unhexable code string: stable fallback
    return "0x" + keccak256(bytes(code)).hex()
