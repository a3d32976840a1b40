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
launches. The launch takes the plan `eval_plan` makes from the real node
count, L, K and V: blocks of up to 32 candidates, GROUP = 4 threads
sharing each candidate's limbs, with the program, the block's tile of X
and the node values in shared memory, or, where they
do not fit the 227 KB a block may hold, the global variant (node values
in device-memory scratch). A launch the card refuses raises; it never
falls back to the other variant or to the plain version.

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
        fn.argtypes = [i] * 10 + [p] * 11 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def kernel_smem_bytes(n: int, L: int, V: int, C: int, R: int, slots: int) -> int:
    """The kernel's own count of `eval_smem_bytes` (csrc/portfolio.cu
    :eval_layout, which the C entry holds a launch's bytes to); needs the
    built library."""
    fn = build.load("portfolio").portfolio_eval_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
    return fn(L, n, V, C, R, slots)


# ---------------------------------------------------------------------------
# the launch plan (csrc/portfolio.cuh and portfolio.cu:eval_layout lay out
# the same shared regions; chip_smoke.py holds the two counts equal)
# ---------------------------------------------------------------------------

# dynamic shared memory a block may use on an H100 (227 KB), and the rows
# a candidate's node values take beyond the program's nodes: a zero row,
# the search's backup row, the division's remainder and trial rows
SMEM_LIMIT = 232448
SCRATCH_ROWS = 4
NODE_BYTES = 32  # a staged node: 8 ints
GROUP = 4  # threads that share one candidate's evaluation (csrc: kGroup)
SLOT_QUANTUM = 32 // GROUP  # a block's candidates come in whole warps
EVAL_SLOTS = (32, 16, 8)  # portfolio_eval's candidates a block, largest first
# checks only: {"variant": "shared" | "global"} forces the plan's variant
PLAN_OVERRIDE: dict = {}


def slots_for(n: int) -> int:
    """n candidate slots rounded up to whole warps."""
    return -(-max(n, 1) // SLOT_QUANTUM) * SLOT_QUANTUM


def align16(x: int) -> int:
    return (x + 15) // 16 * 16


def program_smem(n: int, C: int, R: int, L: int) -> int:
    """Shared bytes of a staged program: n nodes, the pool [C, L] as
    uint16, R roots."""
    return align16(n * NODE_BYTES) + align16(C * L * 2) + align16(R * 4)


def value_rows_smem(n: int, L: int, slots: int) -> int:
    """Shared bytes of `slots` candidates' value rows (uint16 limbs)."""
    return align16(slots * (n + SCRATCH_ROWS) * L * 2)


def eval_smem_bytes(n: int, L: int, V: int, C: int, R: int, slots: int) -> int:
    """portfolio_eval's shared bytes at `slots` candidates a block: the
    program, the block's tile of X [V, L, slots] and the value rows."""
    return (program_smem(n, C, R, L) + align16(V * L * slots * 2)
            + value_rows_smem(n, L, slots))


def eval_plan(n: int, L: int, K: int, V: int, C: int, R: int, variant=None) -> dict:
    """portfolio_eval's launch: blocks of `slots` candidates, GROUP threads
    each (32 candidates where K allows, so that K = 4096 spreads over the
    card), the shared variant with the largest block of EVAL_SLOTS whose
    bytes fit SMEM_LIMIT, else the global variant (node values in
    device-memory scratch). `variant` ("shared" or "global") forces one;
    a forced shared variant that does not fit raises."""
    variant = variant or PLAN_OVERRIDE.get("variant")
    K = max(K, 1)
    if variant != "global":
        for T in EVAL_SLOTS:
            T = min(T, slots_for(K))
            smem = eval_smem_bytes(n, L, V, C, R, T)
            if smem <= SMEM_LIMIT:
                return dict(variant="shared", slots=T, blocks=-(-K // T), smem=smem)
        if variant == "shared":
            raise ValueError(f"portfolio_eval: a {n}-node program at L={L}, V={V} does not fit "
                             f"{SMEM_LIMIT} B of shared memory")
    T = min(EVAL_SLOTS[0], slots_for(K))
    return dict(variant="global", slots=T, blocks=-(-K // T), smem=0)


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
# loops, per limb (udiv/urem add `div_ops_per_bit` per step of the
# division, `div_steps`; mul one multiply-add per partial product); a
# bound's operation count
_OPS_PER_LIMB = {CONST: 2, VAR: 2, ZEXT: 2, NOT: 2, AND: 2, OR: 2, XOR: 2, ITE: 2,
                 ADD: 4, SUB: 4, SEXT: 4, MUL: 3, UDIV: 2, UREM: 2, SHL: 7, LSHR: 7,
                 EXTRACT: 6, CONCAT: 7, ASHR: 12, EQ: 3, ULT: 2, ULE: 2, SLT: 4, SLE: 4}


def div_ops_per_bit(L: int) -> int:
    """One step of udiv/urem: shift, compare and conditional subtract
    over L + 1 limbs."""
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


def div_steps(a, b):
    """The steps a division a / b needs (int64 [K] of [K, L] limbs): one
    per quotient bit, bitlen(a) - bitlen(b) + 1, from the first numerator
    bit at which the remainder can reach the divisor; none where b = 0
    (x / 0 is 0) or a has fewer bits than b (the quotient is 0, the
    remainder a)."""
    steps = torch.clamp(_bit_length(a) - _bit_length(b) + 1, min=0)
    return torch.where((b != 0).any(-1), steps, 0)


def eval_values(prog, X, n_nodes=None, count=None):
    """Every node's value for every candidate: a list of int32 [K, L].

    `prog` = (opcodes, args, imms, widths, pool) as host lists or tensors
    (pool [C, L]); X int [V, K, L]. Nodes past `n_nodes` (padding) are
    not evaluated. `count`, a dict, gains the int32 operations this
    evaluation needs ("ops": `node_ops` per node and candidate, plus
    `div_ops_per_bit` per step of each udiv and urem, `div_steps` of its
    operands)."""
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
            if op in (UDIV, UREM):
                ops += int(div_steps(a, b).sum()) * div_ops_per_bit(L)
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
    C, R = pool.shape[0], roots.shape[0]
    plan = eval_plan(n_nodes, L, K, V, C, R)
    rows = (n_nodes + SCRATCH_ROWS) * L * plan["blocks"] * plan["slots"]
    if rows >= 1 << 31 or V * K * L >= 1 << 31:
        raise ValueError(f"portfolio_eval: K={K} candidates of a {n_nodes}-node program at "
                         f"L={L} overflow the kernel's int32 indices")
    # the global variant's value rows [n + 4, L, blocks x slots]
    vals = torch.empty(rows if plan["variant"] == "global" else 1, dtype=torch.int32,
                       device=dev)
    solved = torch.empty(K, dtype=torch.int32, device=dev)
    score = torch.empty(K, dtype=torch.int32, device=dev)
    if K:
        build.launch(_kernel_fn(), X.get_device(), L, n_nodes, R, K, N, C, V,
                     int(plan["variant"] == "shared"), plan["slots"], plan["smem"],
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
