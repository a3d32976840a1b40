"""Compatibility import surface for the symbolic EVM semantics.

The implementation lives in the table-driven `vm` package (see
mythril_tpu_torch/laser/ethereum/vm/): opcode handlers are registered
declaratively and dispatched through one core, replacing the
reference's monolithic Instruction class
(mythril/laser/ethereum/instructions.py, 2415 LoC). This module keeps
the historical import path alive for the engine, tests and
third-party plugins.
"""

from mythril_tpu_torch.laser.ethereum.vm import (  # noqa: F401
    Frame,
    Instruction,
    TABLE,
    run_opcode,
    transfer_ether,
)

__all__ = ["Instruction", "transfer_ether", "Frame", "TABLE", "run_opcode"]
