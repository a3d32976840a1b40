"""The nine precompiled contracts, evaluated concretely.

Reference parity: mythril/laser/ethereum/natives.py:37-242 — same
byte-list in / byte-list out contract, same validity rules (invalid
input returns an empty list = precompile failure, symbolic input
raises NativeContractException so the caller substitutes fresh
symbolic return data, reference call.py:240-251). Crypto backends come
from mythril_tpu_torch.crypto instead of py_ecc/blake2b C packages.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List

from mythril_tpu_torch.crypto import bn128
from mythril_tpu_torch.crypto.blake2 import blake2b_compress
from mythril_tpu_torch.crypto.secp256k1 import N as secp256k1n, ecrecover_to_pub
from mythril_tpu_torch.laser.ethereum.state.calldata import BaseCalldata, ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.util import extract_copy, extract32
from mythril_tpu_torch.support.keccak import keccak256

log = logging.getLogger(__name__)


class NativeContractException(Exception):
    """Native call could not be evaluated concretely (symbolic input)."""


def _int_to_32bytes(v: int) -> bytes:
    return v.to_bytes(32, "big")


def ecrecover(data: List[int]) -> List[int]:
    try:
        bytes_data = bytearray(data)
        v = extract32(bytes_data, 32)
        r = extract32(bytes_data, 64)
        s = extract32(bytes_data, 96)
    except TypeError:
        raise NativeContractException

    message = bytes(bytes_data[0:32])
    if r >= secp256k1n or s >= secp256k1n or v < 27 or v > 28:
        return []
    try:
        pub = ecrecover_to_pub(message, v, r, s)
    except Exception as e:
        log.debug("ecrecover failed: %s", e)
        return []
    return [0] * 12 + list(keccak256(pub)[-20:])


def sha256(data: List[int]) -> List[int]:
    try:
        bytes_data = bytes(data)
    except TypeError:
        raise NativeContractException
    return list(hashlib.sha256(bytes_data).digest())


def ripemd160(data: List[int]) -> List[int]:
    try:
        bytes_data = bytes(data)
    except TypeError:
        raise NativeContractException
    digest = hashlib.new("ripemd160", bytes_data).digest()
    return [0] * 12 + list(digest)


def identity(data: List[int]) -> List[int]:
    return data


def mod_exp(data: List[int]) -> List[int]:
    """EIP-198 MODEXP: <len(B)> <len(E)> <len(M)> <B> <E> <M>."""
    bytes_data = bytearray(data)
    baselen = extract32(bytes_data, 0)
    explen = extract32(bytes_data, 32)
    modlen = extract32(bytes_data, 64)
    if baselen == 0:
        return [0] * modlen
    if modlen == 0:
        return []

    base = bytearray(baselen)
    extract_copy(bytes_data, base, 0, 96, baselen)
    exp = bytearray(explen)
    extract_copy(bytes_data, exp, 0, 96 + baselen, explen)
    mod = bytearray(modlen)
    extract_copy(bytes_data, mod, 0, 96 + baselen + explen, modlen)
    mod_int = int.from_bytes(mod, "big")
    if mod_int == 0:
        return [0] * modlen
    o = pow(int.from_bytes(base, "big"), int.from_bytes(exp, "big"), mod_int)
    return list(o.to_bytes(modlen, "big")[-modlen:]) if modlen else []


def _validate_point(x: int, y: int):
    """(x, y) -> G1 point, None for the zero point, False when invalid
    (mirrors pyethereum's validate_point semantics)."""
    if x >= bn128.field_modulus or y >= bn128.field_modulus:
        return False
    if (x, y) == (0, 0):
        return None
    pt = (bn128.FQ(x), bn128.FQ(y))
    if not bn128.is_on_curve(pt, bn128.b):
        return False
    return pt


def ec_add(data: List[int]) -> List[int]:
    bytes_data = bytearray(data)
    x1 = extract32(bytes_data, 0)
    y1 = extract32(bytes_data, 32)
    x2 = extract32(bytes_data, 64)
    y2 = extract32(bytes_data, 96)
    p1 = _validate_point(x1, y1)
    p2 = _validate_point(x2, y2)
    if p1 is False or p2 is False:
        return []
    o = bn128.add(p1, p2)
    if o is None:
        return [0] * 64
    return list(_int_to_32bytes(o[0].n) + _int_to_32bytes(o[1].n))


def ec_mul(data: List[int]) -> List[int]:
    bytes_data = bytearray(data)
    x = extract32(bytes_data, 0)
    y = extract32(bytes_data, 32)
    m = extract32(bytes_data, 64)
    p = _validate_point(x, y)
    if p is False:
        return []
    o = bn128.multiply(p, m)
    if o is None:
        return [0] * 64
    return list(_int_to_32bytes(o[0].n) + _int_to_32bytes(o[1].n))


def ec_pair(data: List[int]) -> List[int]:
    if len(data) % 192:
        return []

    exponent = bn128.FQ12.one()
    bytes_data = bytearray(data)
    for i in range(0, len(bytes_data), 192):
        x1 = extract32(bytes_data, i)
        y1 = extract32(bytes_data, i + 32)
        x2_i = extract32(bytes_data, i + 64)
        x2_r = extract32(bytes_data, i + 96)
        y2_i = extract32(bytes_data, i + 128)
        y2_r = extract32(bytes_data, i + 160)
        p1 = _validate_point(x1, y1)
        if p1 is False:
            return []
        for v in (x2_i, x2_r, y2_i, y2_r):
            if v >= bn128.field_modulus:
                return []
        fq2_x = bn128.FQ2([x2_r, x2_i])
        fq2_y = bn128.FQ2([y2_r, y2_i])
        if (fq2_x, fq2_y) != (bn128.FQ2.zero(), bn128.FQ2.zero()):
            p2 = (fq2_x, fq2_y)
            if not bn128.is_on_curve(p2, bn128.b2):
                return []
            if bn128.multiply(p2, bn128.curve_order) is not None:
                return []
        else:
            p2 = None
        exponent = exponent * bn128.miller_loop(
            bn128.twist(p2), bn128.cast_point_to_fq12(p1)
        )
    result = exponent == bn128.FQ12.one()
    return [0] * 31 + [1 if result else 0]


def blake2b_fcompress(data: List[int]) -> List[int]:
    """EIP-152 F-compression precompile."""
    raw = bytes(data)
    if len(raw) != 213:
        log.debug("invalid blake2b input length %d", len(raw))
        return []
    final_flag = raw[212]
    if final_flag not in (0, 1):
        return []
    rounds = int.from_bytes(raw[0:4], "big")
    h = [int.from_bytes(raw[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(raw[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t = [int.from_bytes(raw[196 + 8 * i : 204 + 8 * i], "little") for i in range(2)]
    return list(blake2b_compress(rounds, h, m, t, bool(final_flag)))


PRECOMPILE_FUNCTIONS = (
    ecrecover,
    sha256,
    ripemd160,
    identity,
    mod_exp,
    ec_add,
    ec_mul,
    ec_pair,
    blake2b_fcompress,
)

PRECOMPILE_COUNT = len(PRECOMPILE_FUNCTIONS)


def native_contracts(address: int, data: BaseCalldata) -> List[int]:
    """Run precompile `address` (1-based) on concrete calldata."""
    if not isinstance(data, ConcreteCalldata):
        raise NativeContractException()
    concrete_data = data.concrete(None)
    try:
        return PRECOMPILE_FUNCTIONS[address - 1](concrete_data)
    except TypeError:
        raise NativeContractException
