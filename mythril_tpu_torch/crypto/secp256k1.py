"""secp256k1 public-key recovery for the ecrecover precompile.

Behavioral model: the reference's `ecrecover_to_pub` path
(mythril/laser/ethereum/natives.py:37-66 via py_ecc/ethereum utils).
Standard curve math: y^2 = x^3 + 7 over F_p, Jacobian doubling/addition,
and SEC1 public-key recovery from a recoverable signature.
"""

from __future__ import annotations

from typing import Optional, Tuple

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
A = 0
B = 7
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None is the point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _mul(p: Point, k: int) -> Point:
    result: Point = None
    addend = p
    while k:
        if k & 1:
            result = _add(result, addend)
        addend = _add(addend, addend)
        k >>= 1
    return result


def is_on_curve(x: int, y: int) -> bool:
    return (y * y - x * x * x - B) % P == 0


def ecrecover_to_pub(msg_hash: bytes, v: int, r: int, s: int) -> bytes:
    """Recover the 64-byte uncompressed public key (x||y) or raise
    ValueError for an invalid signature — mirroring the yellow-paper
    validity rules the reference precompile enforces."""
    if v not in (27, 28):
        raise ValueError("invalid v")
    if not (1 <= r < N and 1 <= s < N):
        raise ValueError("invalid r/s")
    x = r
    # recovery ids 0/1 only (x = r, never r + N in the EVM precompile
    # when r + N >= P is out of field anyway)
    alpha = (pow(x, 3, P) + B) % P
    y = pow(alpha, (P + 1) // 4, P)
    if (y * y) % P != alpha:
        raise ValueError("r is not an x-coordinate on the curve")
    if (y % 2) != ((v - 27) % 2):
        y = P - y
    R = (x, y)
    e = int.from_bytes(msg_hash, "big") % N
    r_inv = _inv(r, N)
    # Q = r^-1 (s*R - e*G)
    point = _add(_mul(R, s), _mul((Gx, Gy), (N - e) % N))
    Q = _mul(point, r_inv)
    if Q is None:
        raise ValueError("recovered point at infinity")
    qx, qy = Q
    return qx.to_bytes(32, "big") + qy.to_bytes(32, "big")
