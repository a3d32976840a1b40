"""Bytecode helpers: the port's copy of the JAX package's
disassembler/asm.py without its assembler. The instruction list
(`disassemble`, `find_op_code_sequence`) feeds `Disassembly` and the host
engine, which reads an instruction as the reference's dict;
`instruction_list_to_easm` prints it; `to_dense` gives the batched
interpreter its opcode and jumpdest arrays."""

from __future__ import annotations

import re
from typing import Dict, Generator, List

import numpy as np

from mythril_tpu_torch.support.opcodes import BYTE_TO_NAME

regex_push = re.compile(r"^PUSH(\d{1,2})$")


class EvmInstruction:
    """One disassembled instruction (dict-compatible with the reference's
    {'address', 'opcode', 'argument'} records)."""

    __slots__ = ("address", "opcode", "argument")

    def __init__(self, address: int, opcode: str, argument: str = None):
        self.address = address
        self.opcode = opcode
        self.argument = argument

    def to_dict(self) -> Dict:
        result = {"address": self.address, "opcode": self.opcode}
        if self.argument is not None:
            result["argument"] = self.argument
        return result

    def __getitem__(self, key):  # dict-style access, as the host engine reads it
        value = self.to_dict().get(key)
        if value is None and key != "argument":
            raise KeyError(key)
        return value

    def get(self, key, default=None):
        return self.to_dict().get(key, default)

    def __repr__(self):
        return f"<{self.address} {self.opcode} {self.argument or ''}>"



def safe_decode(code: str) -> bytes:
    """'0x...' or bare hex -> bytes."""
    if code.startswith("0x"):
        code = code[2:]
    code = code.strip().replace("\n", "")
    if len(code) % 2:
        code += "0"  # tolerate odd-length hex the way the reference does
    return bytes.fromhex(code)


def find_metadata_length(code: bytes) -> int:
    """Length of trailing solc CBOR metadata (swarm/ipfs hash), or 0.

    solc appends a CBOR blob whose final 2 bytes are its big-endian
    length; we validate by looking for the bzzr/ipfs keys."""
    if len(code) < 4:
        return 0
    meta_len = int.from_bytes(code[-2:], "big") + 2
    if meta_len > len(code):
        return 0
    blob = code[-meta_len:]
    if b"bzzr" in blob or b"ipfs" in blob:
        return meta_len
    return 0


def disassemble(bytecode: bytes) -> List[EvmInstruction]:
    """Bytecode -> instruction list. PUSH arguments are hex strings; a
    trailing PUSH whose operand runs past the end of the code is
    zero-padded and never absorbs the solc metadata after it."""
    instructions = []
    length = len(bytecode) - find_metadata_length(bytecode)
    address = 0
    while address < length:
        op = bytecode[address]
        name = BYTE_TO_NAME.get(op, "INVALID")
        match = regex_push.match(name)
        if match:
            n = int(match.group(1))
            argument = bytecode[address + 1 : min(address + 1 + n, length)]
            argument = argument + b"\x00" * (n - len(argument))
            instructions.append(
                EvmInstruction(address, name, "0x" + argument.hex())
            )
            address += 1 + n
        else:
            instructions.append(EvmInstruction(address, name))
            address += 1
    return instructions


def instruction_list_to_easm(instruction_list: List[EvmInstruction]) -> str:
    """Printable assembly (reference: asm.py instruction_list_to_easm)."""
    result = ""
    for instruction in instruction_list:
        result += "{} {}".format(instruction.address, instruction.opcode)
        if instruction.argument is not None:
            result += " " + instruction.argument
        result += "\n"
    return result


def is_sequence_match(pattern, instruction_list, index) -> bool:
    for i, pattern_slot in enumerate(pattern):
        if index + i >= len(instruction_list):
            return False
        if instruction_list[index + i].opcode not in pattern_slot:
            return False
    return True


def find_op_code_sequence(pattern, instruction_list) -> Generator[int, None, None]:
    """Yield indices where the opcode-set sequence matches
    (reference: asm.py:62)."""
    for i in range(0, len(instruction_list) - len(pattern) + 1):
        if is_sequence_match(pattern, instruction_list, i):
            yield i


def to_dense(bytecode: bytes, max_len: int = None):
    """Bytecode -> (opcode bytes u8[max_len], valid-jumpdest mask).

    The device interpreter fetches raw bytes; PUSH data is read inline.
    The jumpdest mask bakes the invalid-jump-destination check into a
    vectorized lookup."""
    length = len(bytecode) - find_metadata_length(bytecode)
    code = bytecode[:length]
    max_len = max_len or len(code)
    ops = np.zeros(max_len, dtype=np.uint8)
    ops[: len(code)] = np.frombuffer(code, dtype=np.uint8)[:max_len]
    jumpdest = np.zeros(max_len, dtype=bool)
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            jumpdest[i] = True
        i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return ops, jumpdest
