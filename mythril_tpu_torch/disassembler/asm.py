"""Bytecode helpers the batched interpreter needs (the port's copy of
`find_metadata_length` and `to_dense` from the JAX package's
disassembler/asm.py)."""

from __future__ import annotations

import numpy as np


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
