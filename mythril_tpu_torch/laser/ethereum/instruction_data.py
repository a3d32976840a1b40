"""Per-opcode gas/stack metadata accessors.

Reference parity: mythril/laser/ethereum/instruction_data.py:16-226.
The raw table lives in mythril_tpu_torch/support/opcodes.py (one merged
table); this module provides the reference-named accessors plus the
sha3/native dynamic-gas calculators.
"""

from __future__ import annotations

import math
from typing import Tuple

from mythril_tpu_torch.support.opcodes import OPCODES

Z_OPERATIONS = ("STOP", "RETURN", "REVERT", "SUICIDE", "SELFDESTRUCT")


def get_required_stack_elements(opcode: str) -> int:
    """How many stack slots the opcode pops (reference:
    instruction_data.py:226)."""
    return OPCODES[opcode][1]


def get_opcode_gas(opcode: str) -> Tuple[int, int]:
    """(min_gas, max_gas) bounds for the opcode (reference:
    instruction_data.py:222)."""
    _, _, _, gas_min, gas_max = OPCODES[opcode]
    return gas_min, gas_max


def calculate_sha3_gas(length: int) -> Tuple[int, int]:
    """SHA3 word gas: 30 + 6 per 32-byte word."""
    gas_val = 30 + 6 * math.ceil(length / 32)
    return gas_val, gas_val


def calculate_native_gas(size: int, contract: str) -> Tuple[int, int]:
    """Istanbul gas schedule for precompiles 1-4 (the reference leaves
    5-9 unpriced too; instruction_data.py calculate_native_gas)."""
    gas_value = 0
    word_num = math.ceil(size / 32)
    if contract == "ecrecover":
        gas_value = 3000
    elif contract == "sha256":
        gas_value = 60 + 12 * word_num
    elif contract == "ripemd160":
        gas_value = 600 + 120 * word_num
    elif contract == "identity":
        gas_value = 15 + 3 * word_num
    return gas_value, gas_value
