"""Host keccak-256 (EVM variant: original Keccak padding, not NIST SHA3).

The port's own pure-Python copy of the JAX package's support/keccak.py,
without its native ctypes loader. It is the oracle the device keccak
(ops/keccak.py and the CUDA kernel behind ops/keccak_cuda.py) is held
against.
"""

from __future__ import annotations

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1
_RATE = 136  # keccak-256 rate in bytes


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f(state: list) -> list:
    """keccak-f[1600] permutation on 25 little-endian 64-bit lanes."""
    for rnd in range(24):
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        state = [state[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(state[x + 5 * y], _ROT[x][y])
        state = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        state[0] ^= RC[rnd]
    return state


def keccak256(data: bytes) -> bytes:
    """EVM keccak-256 digest of ``data``."""
    state = [0] * 25
    # multi-rate padding: 0x01 ... 0x80 (this is what distinguishes EVM
    # keccak from NIST SHA3's 0x06 domain byte); when only one byte is
    # free the two markers merge into 0x81
    padded = bytearray(data + b"\x01" + b"\x00" * ((-(len(data) + 1)) % _RATE))
    padded[-1] |= 0x80
    padded = bytes(padded)
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def keccak256_int(data: bytes) -> int:
    return int.from_bytes(keccak256(data), "big")
