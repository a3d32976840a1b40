"""The port's u256 limb arithmetic against the JAX package's, bit for bit.

Words come from a numpy seed plus the EVM quirk values (SDIV(-2^255,-1),
SMOD(-7,3), DIV(x,0), BYTE, SIGNEXTEND, SAR on negatives); every op runs
on the same limbs through `mythril_tpu.ops.u256` (JAX on the CPU) and
`mythril_tpu_torch.ops.u256` (PyTorch on the CPU). Tolerance: exact
equality (integers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mythril_tpu.ops import u256 as ju
from mythril_tpu_torch.ops import u256 as tu

# small tensors: torch's intra-op threads would only contend with the
# other test workers
torch.set_num_threads(1)

M = 1 << 256
MIN_INT = 1 << 255

QUIRK_PAIRS = [
    (MIN_INT, M - 1),  # SDIV(-2^255, -1) == -2^255
    (M - 7, 3),  # SMOD(-7, 3) == -1
    (12345, 0),  # DIV/MOD by zero == 0
    (0, 0),
    (M - 1, M - 1),
    (M - 2, 5),
    (MIN_INT, 1),
    (MIN_INT - 1, M - 3),
    (7, M - 2),
    (1 << 200, 3),
    (31, M - 0x80),  # BYTE(31, .) / SIGNEXTEND(31, .)
    (30, 0x8000),  # SIGNEXTEND of a negative byte
    (0, 0xFF),  # SIGNEXTEND(0, 0xff) == -1
    (4, M - 0x1000),  # SAR on a negative
    (300, M - 5),  # SAR past 256 on a negative -> all ones
    (255, MIN_INT),
    (32, 0x1234),  # BYTE index >= 32 -> 0
]


def _words(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bits = int(rng.integers(0, 257))
        v = int.from_bytes(rng.bytes(32), "big") >> (256 - bits) if bits else 0
        if rng.random() < 0.25:
            v = (M - v) % M  # negatives
        out.append(v)
    return out


A_INTS = [p[0] for p in QUIRK_PAIRS] + _words(1, 47)
B_INTS = [p[1] for p in QUIRK_PAIRS] + _words(2, 47)
C_INTS = [p[1] | 1 for p in QUIRK_PAIRS] + _words(3, 47)
C_INTS[5] = 0  # a zero modulus
# small shift / index amounts beside full words
S_INTS = [int(x) for x in np.random.default_rng(4).integers(0, 300, len(A_INTS))]
S_INTS[:len(QUIRK_PAIRS)] = [p[0] for p in QUIRK_PAIRS]


def _np(ints):
    return np.stack([ju.from_int(v) for v in ints])


A, B, C, S = (_np(x) for x in (A_INTS, B_INTS, C_INTS, S_INTS))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _same(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    if ref.dtype == bool or port.dtype == bool:
        np.testing.assert_array_equal(port.astype(bool), ref.astype(bool))
    else:
        np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64))


BINARY = {
    "add": (tu.add, ju.add),
    "sub": (tu.sub, ju.sub),
    "mul": (tu.mul, ju.mul),
    "mul_wide": (tu.mul_wide, ju.mul_wide),
    "eq": (tu.eq, ju.eq),
    "ult": (tu.ult, ju.ult),
    "ule": (tu.ule, ju.ule),
    "slt": (tu.slt, ju.slt),
    "and": (tu.bit_and, ju.bit_and),
    "or": (tu.bit_or, ju.bit_or),
    "xor": (tu.bit_xor, ju.bit_xor),
    "udiv": (tu.udiv, ju.udiv),
    "urem": (tu.urem, ju.urem),
    "sdiv": (tu.sdiv, ju.sdiv),
    "srem": (tu.srem, ju.srem),
    "exp": (tu.exp, ju.exp),
    "byte": (tu.byte_op, ju.byte_op),
    "signextend": (tu.signextend, ju.signextend),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_matches_jax(name):
    port_fn, jax_fn = BINARY[name]
    lhs = S if name in ("byte", "signextend") else A
    _same(port_fn(_t(lhs), _t(B)), jax_fn(jnp.asarray(lhs), jnp.asarray(B)))


UNARY = {
    "neg": (tu.neg, ju.neg),
    "not": (tu.bit_not, ju.bit_not),
    "is_zero": (tu.is_zero, ju.is_zero),
    "sign_bit": (tu.sign_bit, ju.sign_bit),
    "shift_amount": (tu.shift_amount, ju.shift_amount),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_matches_jax(name):
    port_fn, jax_fn = UNARY[name]
    for words in (A, B, S):
        _same(port_fn(_t(words)), jax_fn(jnp.asarray(words)))


@pytest.mark.parametrize("name", ["shl", "lshr", "ashr"])
def test_shift_matches_jax(name):
    amount = ju.shift_amount(jnp.asarray(S))
    for words in (A, B):
        _same(getattr(tu, name)(_t(words), tu.shift_amount(_t(S))),
              getattr(ju, name)(jnp.asarray(words), amount))


@pytest.mark.parametrize("name", ["addmod", "mulmod"])
def test_modop_matches_jax(name):
    _same(getattr(tu, name)(_t(A), _t(B), _t(C)),
          getattr(ju, name)(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)))


def test_udivmod_wide_numerator_matches_jax():
    wide = ju.mul_wide(jnp.asarray(A), jnp.asarray(B))
    q_ref, r_ref = ju.udivmod(wide, jnp.asarray(C))
    q, r = tu.udivmod(tu.mul_wide(_t(A), _t(B)), _t(C))
    _same(q, q_ref)
    _same(r, r_ref)


def test_fused_division_helpers_equal_the_single_ops():
    a, b, c = _t(A), _t(B), _t(C)
    q, qs, r, rs = tu.divmod_all(a, b)
    for got, want in ((q, tu.udiv(a, b)), (qs, tu.sdiv(a, b)),
                      (r, tu.urem(a, b)), (rs, tu.srem(a, b))):
        _same(got, want)
    am, mm = tu.addmod_mulmod(a, b, c)
    _same(am, tu.addmod(a, b, c))
    _same(mm, tu.mulmod(a, b, c))


def test_quirk_values_match_python_ints():
    def word(v):
        return _t(ju.from_int(v))[None]

    assert tu.to_int(tu.sdiv(word(MIN_INT), word(M - 1))[0]) == MIN_INT
    assert tu.to_int(tu.srem(word(M - 7), word(3))[0]) == M - 1
    assert tu.to_int(tu.udiv(word(12345), word(0))[0]) == 0
    assert tu.to_int(tu.urem(word(12345), word(0))[0]) == 0
    assert tu.to_int(tu.byte_op(word(31), word(0xABCD))[0]) == 0xCD
    assert tu.to_int(tu.byte_op(word(32), word(0xABCD))[0]) == 0
    assert tu.to_int(tu.signextend(word(0), word(0xFF))[0]) == M - 1
    assert tu.to_int(tu.ashr(word(M - 16), torch.tensor([2], dtype=torch.int32))[0]) == M - 4
    assert tu.to_int(tu.ashr(word(M - 16), torch.tensor([400], dtype=torch.int32))[0]) == M - 1
    assert tu.to_int(tu.exp(word(3), word(200))[0]) == pow(3, 200, M)


def test_byte_packing_matches_jax():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    _same(tu.bytes_to_word(torch.from_numpy(raw)), ju.bytes_to_word(jnp.asarray(raw)))
    _same(tu.word_to_bytes(_t(A)), ju.word_to_bytes(jnp.asarray(A)))
    flags = np.array([True, False, True])
    _same(tu.bool_to_word(torch.from_numpy(flags)), ju.bool_to_word(jnp.asarray(flags)))


def test_limbs_round_trip_python_ints():
    for v in A_INTS[:16]:
        assert tu.to_int(_t(tu.from_int(v))) == v
        assert tu.to_int(tu.const(v, (2,))[1]) == v


@pytest.mark.parametrize("limbs", [62, 63, 64, 128])
def test_wide_words_match_python_ints(limbs):
    # above 62 limbs the carries come from the Kogge-Stone scan instead of
    # one packed integer add; the portfolio's plain evaluator runs L = 64
    # and 128 through these same functions
    rng = np.random.default_rng(limbs)
    bits = 16 * limbs
    mod = 1 << bits
    vals = [mod - 1, 1, 0, (1 << (bits - 1)) | 0xFFFF] + [
        int.from_bytes(rng.bytes(2 * limbs), "little") for _ in range(4)]
    dens = [1, mod - 1, 0, 0xFFFF] + [
        int.from_bytes(rng.bytes(2 * limbs), "little") >> int(s)
        for s in rng.integers(0, bits, 4)]
    a = torch.stack([_t(tu.from_int(v, limbs)) for v in vals])
    b = torch.stack([_t(tu.from_int(v, limbs)) for v in dens])
    add, sub, mul = tu.add(a, b), tu.sub(a, b), tu.mul(a, b)
    q, r = tu.udivmod(a, b)
    for i, (x, y) in enumerate(zip(vals, dens)):
        assert tu.to_int(add[i]) == (x + y) % mod
        assert tu.to_int(sub[i]) == (x - y) % mod
        assert tu.to_int(mul[i]) == (x * y) % mod
        assert (tu.to_int(q[i]), tu.to_int(r[i])) == ((x // y, x % y) if y else (0, 0))
        assert bool(tu.ult(a[i], b[i])) == (x < y)
