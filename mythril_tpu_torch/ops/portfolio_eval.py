"""Evaluate a compiled constraint program for K candidate assignments,
through the hand-written CUDA kernel `portfolio_eval`
(csrc/portfolio.cu).

The port's counterpart of `eval_program` and `score` in the JAX
package's laser/smt/solver/portfolio.py (:517-625): a flat tensor
program over 16-bit limbs (`Program`: opcodes [N], args [N, 3], imms
[N, 2], widths [N], the constant pool [C, L], roots [R] and their mask)
is evaluated node by node for every candidate of X ([V, K, L], 16-bit
limbs), and each candidate gets (solved, soft score): solved when every
root is true, the score the sum of the roots' soft scores (limb 1 of a
bool word, 0..FULL per constraint).

`portfolio_eval(...)` runs the plain PyTorch version (`eval_plain`) on
a CPU tensor and launches the kernel on a CUDA tensor, or raises; it
never moves a CUDA tensor to the plain path. `LAUNCHES` counts kernel
launches.

The plain version computes with the port's u256 limb arithmetic
(ops/u256.py, width-generic, as the JAX evaluator calls its own u256)
and counts bits with a SWAR popcount (PyTorch has no popcount op). It
copies the JAX package's arithmetic exactly, quirks
included: x / 0 and x % 0 are 0; a shift amount with any limb above the
first set saturates to 0xFFFF, so a shift of 16 L bits or more gives 0;
a width-1 node keeps limb 1 (its soft score) unmasked, so `eq` over two
bool nodes compares, and counts the differing bits of, their soft
scores too; the soft-score arithmetic is integer with FULL = 1024.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from mythril_tpu_torch.native import build
from mythril_tpu_torch.ops import u256

LAUNCHES = 0

LIMB_BITS = 16
M16 = 0xFFFF
FULL = 1 << 10
LIMB_COUNTS = (16, 32, 64, 128)

# opcodes (portfolio.OPS)
(CONST, VAR, ADD, SUB, MUL, UDIV, UREM, AND, OR, XOR, NOT, SHL, LSHR, ASHR,
 CONCAT, EXTRACT, ZEXT, SEXT, ITE, EQ, ULT, ULE, SLT, SLE, BAND, BOR, BNOT,
 BXOR, IMPLIES) = range(29)

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("portfolio").portfolio_eval
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i] + [p] * 11 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


# ---------------------------------------------------------------------------
# masks and the ops u256 lacks (the limb arithmetic itself is ops/u256.py's,
# which is width-generic, as the JAX evaluator calls its own u256)
# ---------------------------------------------------------------------------


def width_mask(width: int, L: int) -> List[int]:
    """portfolio.py `width_mask`: limb l of a width-w value."""
    out = []
    for l in range(L):
        bits = min(max(width - LIMB_BITS * l, 0), LIMB_BITS)
        out.append(M16 if bits >= LIMB_BITS else (1 << bits) - 1)
    return out


def node_mask(width: int, L: int) -> List[int]:
    """A node's mask: a width-1 node keeps limb 1, its soft score."""
    out = width_mask(width, L)
    if width == 1:
        out[1] = M16
    return out


def popcount(x):
    """Set bits of each element (values below 2**32): SWAR in int64."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


_K0_OPS = (CONST, ASHR, SEXT, SLT, SLE)
_MASKS = {}


def _node_mask_tensor(width, L, device):
    key = (width, L, device)
    got = _MASKS.get(key)
    if got is None:
        got = _MASKS[key] = torch.tensor(node_mask(width, L), dtype=u256.DTYPE, device=device)
    return got


def _bool_word(hard, soft, K, L, device):
    out = torch.zeros((K, L), dtype=u256.DTYPE, device=device)
    out[:, 0] = hard.to(u256.DTYPE)
    out[:, 1] = soft & M16
    return out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


# int32 operations a candidate spends on one node in the kernel's
# loops, per limb (udiv/urem add DIV_OPS_PER_BIT per numerator bit, mul
# one multiply-add per partial product); a bound's operation count
_OPS_PER_LIMB = {CONST: 2, VAR: 2, ZEXT: 2, NOT: 2, AND: 2, OR: 2, XOR: 2, ITE: 2,
                 ADD: 4, SUB: 4, SEXT: 4, MUL: 3, UDIV: 2, UREM: 2, SHL: 7, LSHR: 7,
                 EXTRACT: 6, CONCAT: 7, ASHR: 12, EQ: 3, ULT: 2, ULE: 2, SLT: 4, SLE: 4}


def div_ops_per_bit(L: int) -> int:
    """One numerator bit of udiv/urem: shift, compare and conditional
    subtract over L + 1 limbs."""
    return 4 * (L + 1) + 3


def node_ops(op: int, L: int) -> int:
    """int32 operations of one node for one candidate, the bit-serial
    division loop left out."""
    ops = _OPS_PER_LIMB.get(op, 0) * L + (6 if op >= BAND else 0)
    if op == MUL:
        ops += L * (L + 1) // 2
    return ops


def _bit_length(x):
    """Bit length of each row's value (int64 [K, L] limbs) as int64 [K]."""
    L = x.shape[-1]
    limb_bits = sum(((x >> j) != 0).to(torch.int64) for j in range(LIMB_BITS))
    weight = torch.arange(L, device=x.device) * LIMB_BITS
    return torch.where(limb_bits > 0, weight + limb_bits, 0).max(-1).values


def eval_values(prog, X, n_nodes=None, count=None):
    """Every node's value for every candidate: a list of int32 [K, L].

    `prog` = (opcodes, args, imms, widths, pool) as host lists or tensors
    (pool [C, L]); X int [V, K, L]. Nodes past `n_nodes` (padding) are
    not evaluated. `count`, a dict, gains the int32 operations the
    kernel does for this evaluation ("ops": `node_ops` per node and
    candidate, plus `div_ops_per_bit` per numerator bit of each udiv and
    urem)."""
    opcodes, args, imms, widths, pool = prog
    opcodes, args, imms, widths = (x.tolist() if torch.is_tensor(x) else list(x)
                                   for x in (opcodes, args, imms, widths))
    X = X.to(u256.DTYPE)
    _, K, L = X.shape
    dev = X.device
    pool = (pool.to(dev, u256.DTYPE) if torch.is_tensor(pool)
            else torch.as_tensor(np.asarray(pool, dtype=np.int32), device=dev))
    n = len(opcodes) if n_nodes is None else n_nodes
    vals: List = []
    zeros = torch.zeros((K, L), dtype=u256.DTYPE, device=dev)
    for i in range(n):
        op = opcodes[i]
        a0, a1, a2 = args[i][:3]
        i0, i1 = imms[i][:2]
        w = widths[i]
        a = vals[a0] if a0 < i else zeros
        b = vals[a1] if a1 < i else zeros
        c = vals[a2] if a2 < i else zeros
        # pool rows, for the ops that read them (an immediate of another
        # op may be a shift amount past the pool)
        k0 = pool[i0].expand(K, L) if op in _K0_OPS else None
        k1 = pool[i1].expand(K, L) if op == ASHR else None
        if op == CONST:
            out = k0.clone()
        elif op == VAR:
            out = X[i0].clone()
        elif op == ADD:
            out = u256.add(a, b)
        elif op == SUB:
            out = u256.sub(a, b)
        elif op == MUL:
            out = u256.mul(a, b)
        elif op in (UDIV, UREM):
            out = u256.udivmod(a, b)[op == UREM]
        elif op == AND:
            out = a & b
        elif op == OR:
            out = a | b
        elif op == XOR:
            out = a ^ b
        elif op == NOT:
            out = a ^ M16
        elif op == SHL:
            out = u256.shl(a, u256.shift_amount(b))
        elif op == LSHR:
            out = u256.lshr(a, u256.shift_amount(b))
        elif op == ASHR:
            sa = u256.shift_amount(b)
            neg = ((a & k0) != 0).any(-1)
            fill = ((u256.lshr(k1, sa) ^ M16) & k1)
            out = u256.lshr(a, sa) | torch.where(neg[:, None], fill, 0)
        elif op == CONCAT:
            out = u256.shl(a, torch.full((K,), i0, device=dev)) | b
        elif op == EXTRACT:
            out = u256.lshr(a, torch.full((K,), i0, device=dev))
        elif op == ZEXT:
            out = a.clone()
        elif op == SEXT:
            out = u256.sub(a ^ k0, k0)
        elif op == ITE:
            out = torch.where((a[:, 0] != 0)[:, None], b, c)
        elif op == EQ:
            diff = popcount(a ^ b).sum(-1)
            aw = max(widths[a0], 1)
            soft = ((aw - torch.clamp(diff, max=aw)) * FULL) // aw
            out = _bool_word((a == b).all(-1), soft, K, L, dev)
        elif op in (ULT, ULE, SLT, SLE):
            x, y = (a, b) if op in (ULT, SLT) else (b, a)
            if op in (SLT, SLE):
                x, y = x ^ k0, y ^ k0
            hard = u256.ult(x, y) if op in (ULT, SLT) else ~u256.ult(x, y)
            out = _bool_word(hard, hard.to(u256.DTYPE) * FULL, K, L, dev)
        elif op == BAND:
            out = _bool_word((a[:, 0] != 0) & (b[:, 0] != 0), torch.minimum(a[:, 1], b[:, 1]),
                             K, L, dev)
        elif op == BOR:
            out = _bool_word((a[:, 0] != 0) | (b[:, 0] != 0), torch.maximum(a[:, 1], b[:, 1]),
                             K, L, dev)
        elif op == BNOT:
            out = _bool_word(a[:, 0] == 0, FULL - a[:, 1], K, L, dev)
        elif op == BXOR:
            hard = (a[:, 0] != 0) != (b[:, 0] != 0)
            out = _bool_word(hard, hard.to(u256.DTYPE) * FULL, K, L, dev)
        elif op == IMPLIES:
            out = _bool_word((a[:, 0] == 0) | (b[:, 0] != 0),
                             torch.maximum(FULL - a[:, 1], b[:, 1]), K, L, dev)
        else:
            out = zeros.clone()
        vals.append(out & _node_mask_tensor(w, L, dev))
        if count is not None:
            ops = node_ops(op, L) * K
            if op in (UDIV, UREM) and not bool((b == 0).all(-1).all()):
                ops += int((_bit_length(a) * (b != 0).any(-1)).sum()) * div_ops_per_bit(L)
            count["ops"] = count.get("ops", 0) + ops
    return vals


def score_values(vals, roots, roots_mask):
    """(solved bool [K], score int32 [K]) over the masked roots."""
    roots = roots.tolist() if torch.is_tensor(roots) else list(roots)
    rmask = roots_mask.tolist() if torch.is_tensor(roots_mask) else list(roots_mask)
    K = vals[0].shape[0] if vals else 0
    dev = vals[0].device if vals else "cpu"
    hard = torch.ones(K, dtype=torch.bool, device=dev)
    soft = torch.zeros(K, dtype=torch.int64, device=dev)
    for r, m in zip(roots, rmask):
        if m:
            hard &= vals[r][:, 0] != 0
            soft += vals[r][:, 1].to(torch.int64)
    return hard, soft.to(torch.int32)


def eval_plain(opcodes, args, imms, widths, pool, roots, roots_mask, X, n_nodes=None,
               count=None):
    """The plain PyTorch version of `portfolio_eval` (`count`: see
    `eval_values`)."""
    vals = eval_values((opcodes, args, imms, widths, pool), X, n_nodes, count)
    return score_values(vals, roots, roots_mask)


def portfolio_eval(opcodes, args, imms, widths, pool, roots, roots_mask, X, n_nodes=None):
    """(solved bool [K], score int32 [K]) of a program for the K
    candidates of X (int32 [V, K, L]). Program arrays are int32 tensors
    on X's device (roots_mask int32 or bool); `n_nodes` (default all)
    bounds the nodes evaluated."""
    operands = [opcodes, args, imms, widths, pool, roots, roots_mask, X]
    if not build.on_cuda(operands, "portfolio_eval"):
        return eval_plain(opcodes, args, imms, widths, pool, roots, roots_mask, X, n_nodes)
    global LAUNCHES
    N = opcodes.shape[0]
    V, K, L = X.shape
    n_nodes = N if n_nodes is None else int(n_nodes)
    if L not in LIMB_COUNTS or pool.shape[-1] != L:
        raise ValueError(f"portfolio_eval takes L in {LIMB_COUNTS} limbs, got X {tuple(X.shape)}, "
                         f"pool {tuple(pool.shape)}")
    if not (args.shape == (N, 3) and imms.shape == (N, 2) and widths.shape == (N,)
            and roots.shape == roots_mask.shape and 0 <= n_nodes <= N):
        raise ValueError("portfolio_eval: program arrays of inconsistent shapes")
    ins = [t.to(torch.int32).contiguous()
           for t in (opcodes, args, imms, widths, pool, roots, roots_mask, X)]
    dev = X.device
    vals = torch.empty(max(n_nodes, 1) * L * K, dtype=torch.int32, device=dev)
    solved = torch.empty(K, dtype=torch.int32, device=dev)
    score = torch.empty(K, dtype=torch.int32, device=dev)
    if K:
        build.launch(_kernel_fn(), X.get_device(), L, n_nodes, roots.shape[0], K,
                     *(t.data_ptr() for t in ins), vals.data_ptr(), solved.data_ptr(),
                     score.data_ptr())
        LAUNCHES += 1
    return solved != 0, score


def program_tensors(prog, device) -> Tuple[torch.Tensor, ...]:
    """(opcodes, args, imms, widths, pool, roots, roots_mask) of a
    `portfolio.Program` as int32 tensors on `device`."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)
                 for a in (prog.opcodes, prog.args, prog.imms, prog.widths, prog.const_pool,
                           prog.roots, prog.roots_mask))
