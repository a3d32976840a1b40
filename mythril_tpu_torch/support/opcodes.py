"""EVM opcode metadata table (the port's own copy of the JAX package's
support/opcodes.py; the port imports nothing of that package).

One unified table replacing the reference's split between
mythril/support/opcodes.py (byte -> name/pops/pushes) and
mythril/laser/ethereum/instruction_data.py (gas min/max + required
stack elements). Values follow the public Istanbul gas schedule
(Yellow Paper appendix G), the same regime the reference targets.

Each entry: name -> (opcode byte, pops, pushes, gas_min, gas_max).
`ASSERT_FAIL` is the reference's alias for INVALID/0xfe used by the
assert-violation detector (reference: mythril/disassembler/asm.py:12).
"""

from __future__ import annotations

GAS_MEMORY = 3  # linear memory-expansion coefficient
GAS_QUADRATIC_DENOM = 512  # quadratic memory-gas denominator

# name: (byte, pops, pushes, gas_min, gas_max)
OPCODES = {
    "STOP": (0x00, 0, 0, 0, 0),
    "ADD": (0x01, 2, 1, 3, 3),
    "MUL": (0x02, 2, 1, 5, 5),
    "SUB": (0x03, 2, 1, 3, 3),
    "DIV": (0x04, 2, 1, 5, 5),
    "SDIV": (0x05, 2, 1, 5, 5),
    "MOD": (0x06, 2, 1, 5, 5),
    "SMOD": (0x07, 2, 1, 5, 5),
    "ADDMOD": (0x08, 3, 1, 8, 8),
    "MULMOD": (0x09, 3, 1, 8, 8),
    "EXP": (0x0A, 2, 1, 10, 10 + 50 * 32),
    "SIGNEXTEND": (0x0B, 2, 1, 5, 5),
    "LT": (0x10, 2, 1, 3, 3),
    "GT": (0x11, 2, 1, 3, 3),
    "SLT": (0x12, 2, 1, 3, 3),
    "SGT": (0x13, 2, 1, 3, 3),
    "EQ": (0x14, 2, 1, 3, 3),
    "ISZERO": (0x15, 1, 1, 3, 3),
    "AND": (0x16, 2, 1, 3, 3),
    "OR": (0x17, 2, 1, 3, 3),
    "XOR": (0x18, 2, 1, 3, 3),
    "NOT": (0x19, 1, 1, 3, 3),
    "BYTE": (0x1A, 2, 1, 3, 3),
    "SHL": (0x1B, 2, 1, 3, 3),
    "SHR": (0x1C, 2, 1, 3, 3),
    "SAR": (0x1D, 2, 1, 3, 3),
    "SHA3": (0x20, 2, 1, 30, 30 + 6 * 8),
    "ADDRESS": (0x30, 0, 1, 2, 2),
    "BALANCE": (0x31, 1, 1, 700, 700),
    "ORIGIN": (0x32, 0, 1, 2, 2),
    "CALLER": (0x33, 0, 1, 2, 2),
    "CALLVALUE": (0x34, 0, 1, 2, 2),
    "CALLDATALOAD": (0x35, 1, 1, 3, 3),
    "CALLDATASIZE": (0x36, 0, 1, 2, 2),
    "CALLDATACOPY": (0x37, 3, 0, 3, 3 + 3 * 768),
    "CODESIZE": (0x38, 0, 1, 2, 2),
    "CODECOPY": (0x39, 3, 0, 3, 3 + 3 * 768),
    "GASPRICE": (0x3A, 0, 1, 2, 2),
    "EXTCODESIZE": (0x3B, 1, 1, 700, 700),
    "EXTCODECOPY": (0x3C, 4, 0, 700, 700 + 3 * 768),
    "RETURNDATASIZE": (0x3D, 0, 1, 2, 2),
    "RETURNDATACOPY": (0x3E, 3, 0, 3, 3),
    "EXTCODEHASH": (0x3F, 1, 1, 700, 700),
    "BLOCKHASH": (0x40, 1, 1, 20, 20),
    "COINBASE": (0x41, 0, 1, 2, 2),
    "TIMESTAMP": (0x42, 0, 1, 2, 2),
    "NUMBER": (0x43, 0, 1, 2, 2),
    "DIFFICULTY": (0x44, 0, 1, 2, 2),
    "GASLIMIT": (0x45, 0, 1, 2, 2),
    "CHAINID": (0x46, 0, 1, 2, 2),
    "SELFBALANCE": (0x47, 0, 1, 5, 5),
    "BASEFEE": (0x48, 0, 1, 2, 2),
    "POP": (0x50, 1, 0, 2, 2),
    "MLOAD": (0x51, 1, 1, 3, 96),
    "MSTORE": (0x52, 2, 0, 3, 98),
    "MSTORE8": (0x53, 2, 0, 3, 98),
    "SLOAD": (0x54, 1, 1, 800, 800),
    "SSTORE": (0x55, 2, 0, 5000, 25000),
    "JUMP": (0x56, 1, 0, 8, 8),
    "JUMPI": (0x57, 2, 0, 10, 10),
    "PC": (0x58, 0, 1, 2, 2),
    "MSIZE": (0x59, 0, 1, 2, 2),
    "GAS": (0x5A, 0, 1, 2, 2),
    "JUMPDEST": (0x5B, 0, 0, 1, 1),
    "BEGINSUB": (0x5C, 0, 0, 2, 2),
    "JUMPSUB": (0x5E, 1, 0, 10, 10),
    "RETURNSUB": (0x5D, 0, 0, 5, 5),
    "LOG0": (0xA0, 2, 0, 375, 375 + 8 * 32),
    "LOG1": (0xA1, 3, 0, 750, 750 + 8 * 32),
    "LOG2": (0xA2, 4, 0, 1125, 1125 + 8 * 32),
    "LOG3": (0xA3, 5, 0, 1500, 1500 + 8 * 32),
    "LOG4": (0xA4, 6, 0, 1875, 1875 + 8 * 32),
    "CREATE": (0xF0, 3, 1, 32000, 32000),
    "CALL": (0xF1, 7, 1, 700, 700 + 9000 + 25000),
    "CALLCODE": (0xF2, 7, 1, 700, 700 + 9000 + 25000),
    "RETURN": (0xF3, 2, 0, 0, 0),
    "DELEGATECALL": (0xF4, 6, 1, 700, 700 + 9000 + 25000),
    "CREATE2": (0xF5, 4, 1, 32000, 32000),
    "STATICCALL": (0xFA, 6, 1, 700, 700 + 9000 + 25000),
    "REVERT": (0xFD, 2, 0, 0, 0),
    "ASSERT_FAIL": (0xFE, 0, 0, 0, 0),
    # min 0: the reference's SUICIDE handler raises TransactionEndSignal
    # before the StateTransition wrapper accumulates gas, so no minimum
    # cost is ever observed (reference: instructions.py tx-ending
    # handlers); Homestead-era VMTests also price SELFDESTRUCT at 0.
    # max keeps the post-Tangerine 5000 + new-account 25000 upper bound.
    "SUICIDE": (0xFF, 1, 0, 0, 30000 + 5000),
}

for _n in range(32):
    OPCODES["PUSH" + str(_n + 1)] = (0x60 + _n, 0, 1, 3, 3)
for _n in range(16):
    OPCODES["DUP" + str(_n + 1)] = (0x80 + _n, _n + 1, _n + 2, 3, 3)
    OPCODES["SWAP" + str(_n + 1)] = (0x90 + _n, _n + 2, _n + 2, 3, 3)

BYTE_TO_NAME = {v[0]: k for k, v in OPCODES.items()}
NAME_TO_BYTE = {k: v[0] for k, v in OPCODES.items()}


def opcode_name(byte: int) -> str:
    return BYTE_TO_NAME.get(byte, "INVALID")


def get_opcode_gas(opcode_name_: str):
    """(gas_min, gas_max) static bounds for an opcode name
    (reference: mythril/laser/ethereum/instruction_data.py:222)."""
    entry = OPCODES.get(opcode_name_)
    if entry is None:
        return 0, 0
    return entry[3], entry[4]


def get_required_stack_elements(opcode_name_: str) -> int:
    """Stack elements the opcode pops
    (reference: mythril/laser/ethereum/instruction_data.py:226)."""
    entry = OPCODES.get(opcode_name_)
    return entry[1] if entry else 0
