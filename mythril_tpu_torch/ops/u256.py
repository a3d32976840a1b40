"""256-bit unsigned/signed arithmetic on PyTorch tensors.

A 256-bit EVM word is 16 little-endian limbs of 16 bits each, shape
``[..., 16]``: the JAX package's layout, kept so that the two compare
field by field. The limbs are carried in ``int32`` (PyTorch has no
usable uint32 on the CPU); values stay below 2**16, and every product
of two limbs (up to 0xFFFE0001) is formed in ``int64``.

The functions compute exactly what the JAX package's ops/u256.py
computes, bit for bit, but are written for an eager framework where
each tensor operation is a launch: carries propagate with a bitwise
carry-lookahead over the whole word instead of a Python loop per limb,
and the schoolbook product sums its anti-diagonals in one `index_add_`.
The bit-serial loops of `udivmod` (one iteration per numerator bit) and
`exp` (one per exponent bit) start at, or stop after, the highest bit
set anywhere in the batch: the skipped iterations provably leave the
result unchanged, so the answer is the same and the launch count
follows the data (one host read per call).
"""

from __future__ import annotations

import numpy as np
import torch

from mythril_tpu_torch.support import hostsync

LIMBS = 16  # limbs per 256-bit word
LIMB_BITS = 16
LIMB_MASK = 0xFFFF
BITS = LIMBS * LIMB_BITS  # 256
DTYPE = torch.int32  # limb carrier

# ---------------------------------------------------------------------------
# host <-> tensor conversion helpers (python ints are the spec oracle)
# ---------------------------------------------------------------------------


def from_int(x: int, limbs: int = LIMBS) -> np.ndarray:
    """Python int -> limb vector (numpy uint32[limbs], the JAX layout)."""
    x &= (1 << (limbs * LIMB_BITS)) - 1
    return np.array(
        [(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(limbs)], dtype=np.uint32
    )


def to_int(a) -> int:
    """Limb vector (tensor or numpy) -> python int (host only)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    return sum(int(a[..., i]) << (LIMB_BITS * i) for i in range(a.shape[-1]))


def zeros(shape=(), limbs: int = LIMBS, device=None):
    return torch.zeros(tuple(shape) + (limbs,), dtype=DTYPE, device=device)


def const(x: int, shape=(), limbs: int = LIMBS, device=None):
    w = torch.as_tensor(from_int(x, limbs).astype(np.int32), device=device)
    return w.expand(tuple(shape) + (limbs,))


def _ar(n, device, dtype=torch.int64):
    return torch.arange(n, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# carry machinery
# ---------------------------------------------------------------------------


def _propagate(s):
    """Resolve single-bit carries over limb sums in one pass.

    `s` is int64 [..., n] with every limb <= 0x1FFFE (limb 0 may reach
    0x1FFFF), so each limb's carry-out is 0 or 1: a limb above 0xFFFF
    generates a carry, a limb equal to 0xFFFF propagates one. Up to 62
    limbs the generate and propagate flags are packed into one integer
    per word and added (a + b where a = G|P, b = G): the carry into limb
    i is bit i of (a + b) ^ a ^ b. Wider words take a Kogge-Stone scan
    over the flags. The carry out of the top limb is dropped
    (arithmetic mod 2**(16n))."""
    n = s.shape[-1]
    if n > 62:
        return _propagate_scan(s)
    w = torch.ones((), dtype=torch.int64, device=s.device) << _ar(n, s.device)
    g = ((s > LIMB_MASK).to(torch.int64) * w).sum(-1)
    p = ((s == LIMB_MASK).to(torch.int64) * w).sum(-1)
    a = g | p
    c = (a + g) ^ a ^ g
    cin = (c.unsqueeze(-1) >> _ar(n, s.device)) & 1
    return ((s + cin) & LIMB_MASK).to(DTYPE)


def _propagate_scan(s):
    """`_propagate` for any limb count: the carries from a Kogge-Stone
    scan over (generate, propagate), log2(n) rounds."""
    g = s > LIMB_MASK
    p = s == LIMB_MASK
    n = s.shape[-1]
    d = 1
    while d < n:
        g = g | (p & torch.nn.functional.pad(g[..., :-d], (d, 0)))
        p = p & torch.nn.functional.pad(p[..., :-d], (d, 0))
        d *= 2
    cin = torch.nn.functional.pad(g[..., :-1], (1, 0)).to(torch.int64)
    return ((s + cin) & LIMB_MASK).to(DTYPE)


def _carry(s, rounds: int = 1):
    """Propagate carries over raw limb sums. Drops overflow.

    Each normalisation round moves every limb's bits above 16 one limb
    up; `rounds` is chosen by the caller so that afterwards every limb
    is at most 0x1FFFE (one round for sums below 2**32, two for the
    schoolbook's anti-diagonal sums of n products, below 2**(32 +
    log2 n), for any n up to 2**16 limbs)."""
    s = s.to(torch.int64)
    for _ in range(rounds):
        hi = s >> LIMB_BITS
        s = (s & LIMB_MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
    return _propagate(s)


def add(a, b):
    """(a + b) mod 2**(16*limbs)."""
    return _propagate(a.to(torch.int64) + b)


def sub(a, b):
    """(a - b) mod 2**(16*limbs), two's complement."""
    s = a.to(torch.int64) + (LIMB_MASK - b.to(torch.int64))
    s[..., 0] += 1
    return _propagate(s)


def neg(a):
    return sub(torch.zeros_like(a), a)


def _schoolbook(a, b, out_limbs):
    """Exact product truncated to out_limbs limbs: all partial products
    at once, summed along the anti-diagonals (limb i+j)."""
    n = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(shape + (n,)).reshape(-1, n).to(torch.int64)
    b = b.expand(shape + (n,)).reshape(-1, n).to(torch.int64)
    prod = (a[:, :, None] * b[:, None, :]).reshape(-1, n * n)
    diag = (_ar(n, a.device)[:, None] + _ar(n, a.device)[None, :]).reshape(-1)
    if out_limbs < 2 * n - 1:
        keep = diag < out_limbs
        prod, diag = prod[:, keep], diag[keep]
    acc = torch.zeros((prod.shape[0], out_limbs), dtype=torch.int64,
                      device=a.device)
    acc.index_add_(1, diag, prod)
    return _carry(acc, rounds=2).reshape(shape + (out_limbs,))


def mul(a, b):
    """(a * b) mod 2**256."""
    return _schoolbook(a, b, a.shape[-1])


def mul_wide(a, b):
    """Full 512-bit product of two 256-bit words -> [..., 32] limbs."""
    return _schoolbook(a, b, 2 * a.shape[-1])


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def eq(a, b):
    return torch.all(a == b, dim=-1)


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def ult(a, b):
    """a < b unsigned: decided by the most significant differing limb."""
    n = a.shape[-1]
    a, b = torch.broadcast_tensors(a, b)
    top = ((a != b).to(torch.int64) * _ar(n, a.device).add(1)).amax(-1)
    lt = torch.gather(a < b, -1, (top - 1).clamp(min=0).unsqueeze(-1))
    return lt.squeeze(-1) & (top > 0)


def ule(a, b):
    return ~ult(b, a)


def sign_bit(a):
    """1 if the 256-bit value is negative (bit 255 set), else 0. The
    top limb is below 2**16, so the shift is exact in int32."""
    return (a[..., -1] >> (LIMB_BITS - 1)) & 1


def slt(a, b):
    sa, sb = sign_bit(a), sign_bit(b)
    return torch.where(sa != sb, sa == 1, ult(a, b))


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------


def bit_and(a, b):
    return a & b


def bit_or(a, b):
    return a | b


def bit_xor(a, b):
    return a ^ b


def bit_not(a):
    return a ^ LIMB_MASK


# ---------------------------------------------------------------------------
# shifts (shift amount: int32 per lane, shape == batch dims)
# ---------------------------------------------------------------------------


def _limb_gather(a, idx):
    """a[..., idx] with idx [..., n] possibly out of range -> 0. The
    index is clamped before the gather and the result masked after it
    (torch raises on an out-of-range index where JAX clamps)."""
    n = a.shape[-1]
    v = torch.gather(a, -1, idx.clamp(0, n - 1).to(torch.int64))
    return torch.where((idx < 0) | (idx >= n), torch.zeros_like(v), v)


def shl(a, s):
    """a << s; s >= 256 -> 0."""
    n = a.shape[-1]
    s = s.to(torch.int32)
    ls, bs = s // LIMB_BITS, s % LIMB_BITS
    idx1 = _ar(n, a.device, torch.int32) - ls.unsqueeze(-1)
    v1 = _limb_gather(a, idx1)
    v2 = _limb_gather(a, idx1 - 1)
    bs_ = bs.unsqueeze(-1)
    out = ((v1 << bs_) | torch.where(bs_ == 0, 0, v2 >> (LIMB_BITS - bs_))) & LIMB_MASK
    return torch.where((s >= n * LIMB_BITS).unsqueeze(-1), 0, out)


def lshr(a, s):
    """a >> s logical; s >= 256 -> 0."""
    n = a.shape[-1]
    s = s.to(torch.int32)
    ls, bs = s // LIMB_BITS, s % LIMB_BITS
    idx1 = _ar(n, a.device, torch.int32) + ls.unsqueeze(-1)
    v1 = _limb_gather(a, idx1)
    v2 = _limb_gather(a, idx1 + 1)
    bs_ = bs.unsqueeze(-1)
    out = ((v1 >> bs_) | torch.where(bs_ == 0, 0, v2 << (LIMB_BITS - bs_))) & LIMB_MASK
    return torch.where((s >= n * LIMB_BITS).unsqueeze(-1), 0, out)


def ashr(a, s):
    """a >> s arithmetic; s >= 256 -> 0 or all-ones by sign."""
    n = a.shape[-1]
    neg_ = sign_bit(a) == 1
    s_cl = torch.clamp(s.to(torch.int32), max=n * LIMB_BITS)
    logical = lshr(a, s_cl)
    # bits >= 256 - s get filled with the sign
    fill_from = n * LIMB_BITS - s_cl
    limb_lo = _ar(n, a.device, torch.int32) * LIMB_BITS
    start = torch.clamp(fill_from.unsqueeze(-1) - limb_lo, 0, LIMB_BITS)
    # bits [start, 16) set; 1 << 16 still fits in int32
    fill_mask = (0x10000 - (torch.ones_like(start) << start)) & LIMB_MASK
    return torch.where(neg_.unsqueeze(-1), logical | fill_mask, logical)


def shift_amount(a):
    """Clamp a 256-bit shift amount to one limb (>= 2**16 saturates)."""
    high = torch.any(a[..., 1:] != 0, dim=-1)
    return torch.where(high, LIMB_MASK, a[..., 0])


# ---------------------------------------------------------------------------
# division / modulo (EVM semantics: x/0 == 0, x%0 == 0)
# ---------------------------------------------------------------------------


def _shl1_with_bit(r, bit):
    """r = (r << 1) | bit, over r's limbs."""
    low = torch.cat([bit.unsqueeze(-1), r[..., :-1] >> (LIMB_BITS - 1)], dim=-1)
    return ((r << 1) | low) & LIMB_MASK


def _top_bit(x) -> int:
    """Index of the highest bit set in any word of `x`, or -1 (one host
    read)."""
    n = x.shape[-1]
    per_limb = hostsync.read(x.reshape(-1, n).amax(0)) if x.numel() else [0] * n
    for limb in reversed(range(n)):
        if per_limb[limb]:
            return limb * LIMB_BITS + int(per_limb[limb]).bit_length() - 1
    return -1


def udivmod(num, den):
    """Unsigned long division. num: [..., L] limbs, den: [..., D<=L+1].

    Returns (q [..., L], r [..., D]). Division by zero yields (0, 0).

    Restoring division, one numerator bit per iteration from the top.
    Iterations above the highest numerator bit set anywhere in the batch
    shift only zeros into a zero remainder and set no quotient bit (a
    zero divisor's bits are cleared at the end either way), so the loop
    starts at that bit."""
    nl = num.shape[-1]
    dl = den.shape[-1]
    wl = dl + 1  # remainder working width (r < 2*den after shift)
    shape = torch.broadcast_shapes(num.shape[:-1], den.shape[:-1])
    num = num.expand(shape + (nl,))
    d = torch.nn.functional.pad(den.expand(shape + (dl,)), (0, wl - dl))
    r = torch.zeros(shape + (wl,), dtype=DTYPE, device=num.device)
    dz = is_zero(den)
    top = _top_bit(num)
    qbits = []
    for j in range(top, -1, -1):
        nbit = (num[..., j // LIMB_BITS] >> (j % LIMB_BITS)) & 1
        r = _shl1_with_bit(r, nbit)
        ge = ~ult(r, d)
        r = torch.where(ge.unsqueeze(-1), sub(r, d), r)
        qbits.append(ge)
    # quotient bit j sits at qbits[top - j]; bits above `top` are zero
    q = torch.zeros(shape + (nl * LIMB_BITS,), dtype=DTYPE, device=num.device)
    if qbits:
        q[..., : top + 1] = torch.stack(qbits[::-1], dim=-1).to(DTYPE)
    weights = torch.ones((), dtype=DTYPE, device=num.device) << _ar(
        LIMB_BITS, num.device, DTYPE)
    q = (q.reshape(shape + (nl, LIMB_BITS)) * weights).sum(-1, dtype=DTYPE)
    q = torch.where(dz.unsqueeze(-1), 0, q)
    r = torch.where(dz.unsqueeze(-1), 0, r[..., :dl])
    return q, r


def udiv(a, b):
    return udivmod(a, b)[0]


def urem(a, b):
    return udivmod(a, b)[1]


def _abs(a):
    return torch.where((sign_bit(a) == 1).unsqueeze(-1), neg(a), a)


def sdiv(a, b):
    """EVM SDIV: truncated toward zero; MIN_INT / -1 == MIN_INT."""
    q = udiv(_abs(a), _abs(b))
    flip = sign_bit(a) != sign_bit(b)
    return torch.where(flip.unsqueeze(-1), neg(q), q)


def srem(a, b):
    """EVM SMOD: sign follows the dividend."""
    r = urem(_abs(a), _abs(b))
    return torch.where((sign_bit(a) == 1).unsqueeze(-1), neg(r), r)


def divmod_all(a, b):
    """(DIV, SDIV, MOD, SMOD) of a by b from ONE bit-serial loop: the
    unsigned and the magnitude divisions run as two halves of one
    batch. Equal to (udiv, sdiv, urem, srem) applied one by one."""
    q2, r2 = udivmod(torch.stack([a, _abs(a)]), torch.stack([b, _abs(b)]))
    flip = sign_bit(a) != sign_bit(b)
    qs = torch.where(flip.unsqueeze(-1), neg(q2[1]), q2[1])
    rs = torch.where((sign_bit(a) == 1).unsqueeze(-1), neg(r2[1]), r2[1])
    return q2[0], qs, r2[0], rs


def _widen(a, limbs):
    return torch.nn.functional.pad(a, (0, limbs - a.shape[-1]))


def addmod(a, b, m):
    """(a + b) mod m over the full 257-bit sum."""
    wide = add(_widen(a, LIMBS + 1), _widen(b, LIMBS + 1))
    _, r = udivmod(wide, m)
    return r


def mulmod(a, b, m):
    """(a * b) mod m over the full 512-bit product."""
    wide = mul_wide(a, b)
    _, r = udivmod(wide, m)
    return r


def addmod_mulmod(a, b, m):
    """(ADDMOD, MULMOD) from ONE bit-serial loop: the 257-bit sum is
    zero-extended to the 512-bit product's width (the remainder does not
    change) and both divide as two halves of one batch."""
    wide_sum = _widen(add(_widen(a, LIMBS + 1), _widen(b, LIMBS + 1)), 2 * LIMBS)
    _, r = udivmod(torch.stack([wide_sum, mul_wide(a, b)]), torch.stack([m, m]))
    return r[0], r[1]


def exp(a, e):
    """a ** e mod 2**256 by square-and-multiply, one exponent bit per
    iteration; iterations above the batch's highest exponent bit would
    only square the base, so the loop stops there."""
    result = torch.zeros_like(a)
    result[..., 0] = 1
    base = a
    top = _top_bit(e)
    for i in range(top + 1):
        ebit = (e[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1
        result = torch.where((ebit == 1).unsqueeze(-1), mul(result, base), result)
        if i < top:
            base = mul(base, base)
    return result


# ---------------------------------------------------------------------------
# EVM-specific bit ops
# ---------------------------------------------------------------------------


def byte_op(i, x):
    """EVM BYTE: i-th byte counted from the most-significant end."""
    big = torch.any(i[..., 1:] != 0, dim=-1) | (i[..., 0] >= 32)
    ib = torch.clamp(i[..., 0], max=31)
    b = 31 - ib  # byte index from LSB
    limb = (b // 2).to(torch.int64)
    shift = 8 * (b % 2)
    v = torch.gather(x, -1, limb.unsqueeze(-1)).squeeze(-1)
    out = torch.zeros_like(x)
    out[..., 0] = (v >> shift) & 0xFF
    return torch.where(big.unsqueeze(-1), 0, out)


def signextend(b, x):
    """EVM SIGNEXTEND: extend the sign of the low (b+1) bytes."""
    big = torch.any(b[..., 1:] != 0, dim=-1) | (b[..., 0] >= 31)
    bb = torch.clamp(b[..., 0], max=31)
    t = 8 * bb + 7  # sign bit index
    limb = (t // LIMB_BITS).to(torch.int64)
    bit = t % LIMB_BITS
    v = torch.gather(x, -1, limb.unsqueeze(-1)).squeeze(-1)
    sign = (v >> bit) & 1
    k = _ar(LIMBS, x.device, torch.int32)
    nbits = torch.clamp(t.unsqueeze(-1) + 1 - k * LIMB_BITS, 0, LIMB_BITS)
    mask_low = ((torch.ones_like(nbits) << nbits) - 1) & LIMB_MASK
    ext = torch.where((sign == 1).unsqueeze(-1), x | (mask_low ^ LIMB_MASK),
                      x & mask_low)
    return torch.where(big.unsqueeze(-1), x, ext)


# ---------------------------------------------------------------------------
# byte packing (memory/calldata interop): 32 big-endian bytes <-> limbs
# ---------------------------------------------------------------------------


def bytes_to_word(b):
    """[..., 32] big-endian bytes (any integer dtype) -> [..., 16] limbs."""
    b = b.to(DTYPE)
    be_limbs = (b[..., 0:32:2] << 8) | b[..., 1:32:2]  # big-endian order
    return be_limbs.flip(-1)


def word_to_bytes(w):
    """[..., 16] limbs -> [..., 32] uint8 big-endian bytes."""
    be = w.flip(-1)
    out = torch.stack([(be >> 8) & 0xFF, be & 0xFF], dim=-1)
    return out.reshape(w.shape[:-1] + (32,)).to(torch.uint8)


def bool_to_word(c):
    """bool [...] -> 0/1 word."""
    z = torch.zeros(c.shape + (LIMBS,), dtype=DTYPE, device=c.device)
    z[..., 0] = c.to(DTYPE)
    return z
