"""Conversion helpers shared by the symbolic interpreter.

Reference parity: mythril/laser/ethereum/util.py — signed/unsigned
conversions, instruction index lookup by byte address, `pop_bitvec`
(Bool -> 0/1 coercion on stack pops) and concrete-int extraction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from mythril_tpu_torch.laser.smt import (
    BitVec,
    Bool,
    Expression,
    If,
    simplify,
    symbol_factory,
)

TT256 = 2**256
TT256M1 = 2**256 - 1
TT255 = 2**255


def safe_decode(hex_encoded_string: str) -> bytes:
    if hex_encoded_string.startswith("0x"):
        return bytes.fromhex(hex_encoded_string[2:])
    return bytes.fromhex(hex_encoded_string)


def to_signed(i: int) -> int:
    return i if i < TT255 else i - TT256


def get_instruction_index(
    instruction_list: List[Dict], address: int
) -> Optional[int]:
    """Index of the first instruction at byte offset >= `address`
    (reference: util.py get_instruction_index)."""
    index = 0
    for instr in instruction_list:
        if instr["address"] >= address:
            return index
        index += 1
    return None


def pop_bitvec(state) -> BitVec:
    """Pop one stack element, coercing Bool/int to a 256-bit word."""
    item = state.stack.pop()
    if isinstance(item, Bool):
        return If(
            item,
            symbol_factory.BitVecVal(1, 256),
            symbol_factory.BitVecVal(0, 256),
        )
    if isinstance(item, int):
        return symbol_factory.BitVecVal(item, 256)
    return simplify(item)


def get_concrete_int(item: Union[int, Expression]) -> int:
    """Concrete value of an expression; TypeError when symbolic
    (callers catch and degrade, as in the reference)."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.symbolic:
            raise TypeError("BitVec is symbolic")
        return item.value
    if isinstance(item, Bool):
        value = item.value
        if value is None:
            raise TypeError("Bool is symbolic")
        return int(value)
    raise TypeError(f"cannot concretize {type(item)}")


def concrete_int_from_bytes(
    concrete_bytes: Union[List[Union[BitVec, int]], bytes], start_index: int
) -> int:
    """Big-endian 32-byte word starting at `start_index`; missing tail
    bytes read as 0."""
    concrete_bytes = [
        byte.value if isinstance(byte, BitVec) and not byte.symbolic else byte
        for byte in concrete_bytes
    ]
    integer_bytes = concrete_bytes[start_index : start_index + 32]
    if any(isinstance(byte, BitVec) for byte in integer_bytes):
        raise TypeError("BitVec in concrete bytes")
    return int.from_bytes(
        bytes(list(integer_bytes) + [0] * (32 - len(integer_bytes))), "big"
    )


def concrete_int_to_bytes(val: Union[int, BitVec]) -> bytes:
    """256-bit word -> 32 big-endian bytes."""
    if isinstance(val, BitVec):
        val = val.value if val.value is not None else 0
    return (val % TT256).to_bytes(32, "big")


def extract_copy(data: bytearray, mem: bytearray, memstart: int, datastart: int, size: int):
    for i in range(size):
        if datastart + i < len(data):
            mem[memstart + i] = data[datastart + i]
        else:
            mem[memstart + i] = 0


def extract32(data: bytearray, i: int) -> int:
    """32-byte big-endian read at offset i, zero-extended past the end."""
    if i >= len(data):
        return 0
    o = data[i : min(len(data), i + 32)]
    o.extend(bytearray(32 - len(o)))
    return int.from_bytes(o, "big")
