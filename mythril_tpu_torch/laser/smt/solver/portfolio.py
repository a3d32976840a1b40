"""The portfolio solver: SMT queries as tensor programs on the card.

The port's copy of the JAX package's laser/smt/solver/portfolio.py. A
lowered constraint set (bit-vector ops only: arrays and UFs are gone
after `preprocess.lower`) compiles to a flat tensor program over 16-bit
limbs (`compile_program`), evaluated on the card for K candidate
assignments at once (ops/portfolio_eval.py) by a diversified stochastic
local search (ops/portfolio_sls.py), both hand-written CUDA kernels
(csrc/portfolio.cu, csrc/portfolio_sls.cu). A found witness is decoded on the host and
re-checked against every source constraint (`validate_witness`), so a
SAT answer is certain; the absence of a witness proves nothing, except
where a complete program's whole variable space was enumerated
(`device_enumerate`): that UNSAT is the device's own.

The host half (`compile_program` and friends, `validate_witness`,
`cube_queries`, the knobs) is the JAX package's code. The device half
keeps its functions and results: enumeration and the impact ranking are
deterministic and equal the JAX package's; the search draws its random
bits from the port's counter-based hash instead of threefry, so it
agrees with the JAX package at the verdict level (every SAT validated,
every UNSAT from enumeration). The device entry points take
`device=None` (the card; `device="cpu"` runs the kernels' plain
versions); the multi-device paths (`n_devices > 1`, a `devices` list of
more than one card) are not ported and raise NotImplementedError.

Signed operations are compiled away with sign-bit constants:
`slt(a,b) = ult(a^s, b^s)`, `sext_w0(x) = (x^s) - s`, `ashr` ORs a
sign-fill mask, so the interpreter needs only unsigned primitives.
"""

from __future__ import annotations

import time
from collections import namedtuple
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.terms import Term
from mythril_tpu_torch.observe import querylog
from mythril_tpu_torch.ops import portfolio_eval as pe
from mythril_tpu_torch.ops import portfolio_sls as ps
from mythril_tpu_torch.support.accel import resolve_device

LIMB_BITS = 16
LIMB_MASK = 0xFFFF

#: Diversified-portfolio knobs — the JAX package's committed defaults
#: (replay-derived from its solver tuning sweeps). The search knobs are
#: arguments of the portfolio_sls kernel, read at each dispatch.
PORTFOLIO_DEFAULTS: Dict[str, float] = {
    # WalkSAT-style noise: the probability a lane accepts a WORSENING
    # move, swept linearly across the candidate axis (lane 0 is a pure
    # hill climber, the last lane a near-random walker)
    "noise_lo": 0.02,
    "noise_hi": 0.40,
    # fraction of lanes restricted to greedy local moves (bit flip /
    # increment / decrement); the rest draw from the full move mix
    # (randomize limb, zero limb, constant injection)
    "greedy_frac": 0.5,
    # Luby restart unit, in search steps: a lane stalled for
    # luby(i) * restart_base steps reseeds with fresh randomness
    "restart_base": 24,
    # fraction of initial candidates polarity-seeded from the
    # program's own constant pool — dispatcher selectors, actor
    # addresses, and banked storage values from the static summary /
    # carries land in the pool via the path conditions, so these lanes
    # start at the constants the query is actually about
    "seeded_frac": 0.25,
    # cube-and-conquer split depth for hard queries: 2^depth cubes
    # pinned on the top-impact variables (soft-score gradient ranking)
    "cube_depth": 3,
    # exhaustive-enumeration cap: a COMPLETE program whose total
    # variable space fits 2^enum_bits is enumerated outright — the
    # only mode where the device owns unsat verdicts
    "enum_bits": 14,
    # chunked enumeration extends the complete range by this many cube
    # bits (2^cube chunks of 2^enum_bits candidates each)
    "enum_cube_bits": 4,
    # candidates per enumeration chunk (2^bits): bounds the [N, L, K]
    # eval footprint
    "enum_chunk_bits": 12,
    # the device-FIRST wave dispatch's step budget (the batched flip
    # funnel); escalation survivors and race queries get the caller's
    # full step budget
    "first_pass_steps": 192,
    # grace window (ms) the check_terms funnel gives an in-flight race
    # to claim a verdict the host just found — the escalation
    # threshold the mtpu_solver_race_margin_seconds histogram tunes
    "race_grace_ms": 150,
}


#: pristine copy of the COMMITTED defaults, for reset_tuned_defaults
#: (the self-tuning flywheel swaps the live dict, tests swap it back)
_FACTORY_DEFAULTS: Dict[str, float] = dict(PORTFOLIO_DEFAULTS)

#: version of the installed tuned-override artifact (0 = committed
#: defaults) — exported as the mtpu_router_tuned_version gauge
_TUNED_VERSION = 0


def install_tuned_defaults(knobs: Dict[str, float], version: int) -> None:
    """Apply a tuned override set as the process defaults. The knobs are
    arguments of the search kernel, read at each dispatch, so the swap
    needs no recompile. (The JAX package also sets a registry gauge here;
    the port has no metrics registry: `tuned_version()` reports it.)"""
    global _TUNED_VERSION
    unknown = set(knobs) - set(PORTFOLIO_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown portfolio knobs: {sorted(unknown)}")
    PORTFOLIO_DEFAULTS.update(knobs)
    _TUNED_VERSION = int(version)


def reset_tuned_defaults() -> None:
    """Back to the committed defaults (test isolation)."""
    global _TUNED_VERSION
    PORTFOLIO_DEFAULTS.clear()
    PORTFOLIO_DEFAULTS.update(_FACTORY_DEFAULTS)
    _TUNED_VERSION = 0


def tuned_version() -> int:
    return _TUNED_VERSION


@contextmanager
def portfolio_overrides(**knobs):
    """Temporarily override PORTFOLIO_DEFAULTS (one trial of a sweep per
    override set). The search knobs are kernel arguments, read at each
    dispatch, so nothing is recompiled on entry or exit."""
    unknown = set(knobs) - set(PORTFOLIO_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown portfolio knobs: {sorted(unknown)}")
    saved = dict(PORTFOLIO_DEFAULTS)
    PORTFOLIO_DEFAULTS.update(knobs)
    try:
        yield
    finally:
        PORTFOLIO_DEFAULTS.clear()
        PORTFOLIO_DEFAULTS.update(saved)


#: One query's device verdict (device_solve_batch): status is
#: "sat" (validated witness in `assignment`), "unsat" (complete
#: enumeration exhausted the space — device-owned), or "unknown"
#: (`loss` names the reason in the querylog taxonomy). `via` records
#: the deciding mode: "sls", "enum", "cube", or None.
DeviceVerdict = namedtuple("DeviceVerdict", "status assignment loss via")

OPS = [
    "const",    # 0: const_pool[imm0]
    "var",      # 1: X[imm0]
    "add", "sub", "mul", "udiv", "urem",            # 2-6
    "bvand", "bvor", "bvxor", "bvnot",              # 7-10
    "shl", "lshr",                                   # 11-12
    "ashr",     # 13: imm0 = signbit const idx, imm1 = allones const idx
    "concat",   # 14: (a << imm0) | b   (imm0 = width(b))
    "extract",  # 15: a >> imm0, masked to node width
    "zext",     # 16: identity (mask handles it)
    "sext",     # 17: (a ^ pool[imm0]) - pool[imm0]
    "ite",      # 18: bool(a) ? b : c
    "eq",       # 19
    "ult",      # 20
    "ule",      # 21
    "slt",      # 22: ult(a^pool[imm0], b^pool[imm0])
    "sle",      # 23: ule(a^pool[imm0], b^pool[imm0])
    "band", "bor", "bnot", "bxor", "implies",        # 24-28
]
OP_INDEX = {name: i for i, name in enumerate(OPS)}

# the term layer names bitwise BV ops without the bv prefix
_OP_ALIASES = {"and": "bvand", "or": "bvor", "xor": "bvxor", "not": "bvnot"}


class Program:
    """A compiled constraint set: flat node arrays + metadata."""

    def __init__(self, opcodes, args, imms, widths, const_pool, var_slots,
                 roots, roots_mask, limbs, n_real_nodes):
        self.opcodes = opcodes          # [N] int32
        self.args = args                # [N, 3] int32 node indices
        self.imms = imms                # [N, 2] int32 immediates
        self.widths = widths            # [N] int32
        self.const_pool = const_pool    # [C, L] uint32 limbs
        self.var_slots = var_slots      # slot -> (name, width)
        self.roots = roots              # [R] int32 node indices
        self.roots_mask = roots_mask    # [R] bool (False = padding)
        self.limbs = limbs
        self.n_real_nodes = n_real_nodes
        #: the constraint terms this program was compiled FROM — the
        #: set every device witness is concretely validated against
        #: before a sat verdict counts (validate_witness)
        self.source: List[Term] = []
        #: REAL constant-pool rows (the pool array is padded to a
        #: bucket): polarity seeding and the constant-injection move
        #: draw only from these
        self.n_consts = 1
        #: False when segmentation dropped constraints outside the
        #: device language: still sound for SAT search (the validation
        #: gate covers the kept subset and callers re-check the full
        #: set), NEVER eligible for enumeration-unsat
        self.complete = True


def _bucket(n: int, lo: int = 64) -> int:
    size = lo
    while size < n:
        size *= 2
    return size


#: widened shape-bucket lattice (coverage widening): 128 limbs
#: = 2048-bit nodes. Wide concat chains (keccak preimages, packed
#: calldata) used to be BUCKET_OVERFLOW losses at the old 64-limb cap.
DEFAULT_MAX_LIMBS = 128


def compile_program(
    lowered: List[Term], max_limbs: int = DEFAULT_MAX_LIMBS
) -> Optional[Program]:
    """Flatten the constraint DAG into tensor-program arrays; None when
    an op falls outside the device language or widths exceed the cap."""
    return compile_program_ex(lowered, max_limbs)[0]


def compile_program_ex(
    lowered: List[Term], max_limbs: int = DEFAULT_MAX_LIMBS
) -> Tuple[Optional[Program], Optional[str]]:
    """`compile_program` with the failure EXPLAINED: (program, None) on
    success, (None, loss_reason) on a bail — the reason strings are the
    flight recorder's taxonomy (observe/querylog.py): QUERY_TRIVIAL
    (nothing to search), BUCKET_OVERFLOW (widths past the limb cap),
    LOWERING_UNSUPPORTED (op outside the device language)."""
    order: List[Term] = []
    index: Dict[int, int] = {}

    for root in lowered:
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if node._id in index:
                continue
            if expanded:
                if node._id not in index:
                    index[node._id] = len(order)
                    order.append(node)
                continue
            stack.append((node, True))
            for a in node.args:
                if isinstance(a, Term) and a._id not in index:
                    stack.append((a, False))

    if not order:
        return None, "QUERY_TRIVIAL"
    max_width = max((t.width or 1) for t in order)
    L = max(16, _bucket((max_width + LIMB_BITS - 1) // LIMB_BITS, 16))
    if L > max_limbs:
        return None, "BUCKET_OVERFLOW"

    n = len(order)
    opcodes = np.zeros(n, dtype=np.int32)
    args = np.zeros((n, 3), dtype=np.int32)
    imms = np.zeros((n, 2), dtype=np.int32)
    widths = np.ones(n, dtype=np.int32)
    const_pool: List[int] = []
    const_index: Dict[int, int] = {}
    var_slots: List[Tuple[str, int]] = []
    var_index: Dict[Tuple[str, int], int] = {}

    def intern_const(value: int) -> int:
        got = const_index.get(value)
        if got is None:
            got = const_index[value] = len(const_pool)
            const_pool.append(value)
        return got

    def var_slot(key: Tuple[str, int]) -> int:
        got = var_index.get(key)
        if got is None:
            got = var_index[key] = len(var_slots)
            var_slots.append(key)
        return got

    for i, t in enumerate(order):
        op = t.op
        w = t.width or 1
        widths[i] = w
        if op == "const":
            opcodes[i] = OP_INDEX["const"]
            imms[i, 0] = intern_const(t.args[0])
        elif op in ("true", "false"):
            opcodes[i] = OP_INDEX["const"]
            imms[i, 0] = intern_const(1 if op == "true" else 0)
        elif op == "var":
            opcodes[i] = OP_INDEX["var"]
            imms[i, 0] = var_slot((t.args[0], w))
        elif op == "bvar":
            opcodes[i] = OP_INDEX["var"]
            imms[i, 0] = var_slot((t.args[0], 1))
        elif op == "extract":
            hi, lo, a = t.args
            opcodes[i] = OP_INDEX["extract"]
            args[i, 0] = index[a._id]
            imms[i, 0] = lo
        elif op == "zext":
            opcodes[i] = OP_INDEX["zext"]
            args[i, 0] = index[t.args[0]._id]
        elif op == "sext":
            a = t.args[0]
            opcodes[i] = OP_INDEX["sext"]
            args[i, 0] = index[a._id]
            imms[i, 0] = intern_const(1 << (a.width - 1))
        elif op == "concat":
            a, b = t.args
            opcodes[i] = OP_INDEX["concat"]
            args[i, 0] = index[a._id]
            args[i, 1] = index[b._id]
            imms[i, 0] = b.width
        elif op in ("slt", "sle"):
            a, b = t.args
            opcodes[i] = OP_INDEX[op]
            args[i, 0] = index[a._id]
            args[i, 1] = index[b._id]
            imms[i, 0] = intern_const(1 << (a.width - 1))
        elif op == "ashr":
            a, sh = t.args
            opcodes[i] = OP_INDEX["ashr"]
            args[i, 0] = index[a._id]
            args[i, 1] = index[sh._id]
            imms[i, 0] = intern_const(1 << (w - 1))
            imms[i, 1] = intern_const((1 << w) - 1)
        elif op == "ite":
            c, a, b = t.args
            opcodes[i] = OP_INDEX["ite"]
            args[i, 0] = index[c._id]
            args[i, 1] = index[a._id]
            args[i, 2] = index[b._id]
        elif op in _OP_ALIASES or op in OP_INDEX:
            opcodes[i] = OP_INDEX[_OP_ALIASES.get(op, op)]
            for k, a in enumerate(t.args[:3]):
                if isinstance(a, Term):
                    args[i, k] = index[a._id]
        else:
            return None, "LOWERING_UNSUPPORTED"

    roots = [index[c._id] for c in lowered]

    n_pad = _bucket(n)
    def pad(arr, shape, fill=0):
        out = np.full(shape, fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    c_pad = _bucket(max(1, len(const_pool)), 16)
    pool = np.zeros((c_pad, L), dtype=np.uint32)
    for k, value in enumerate(const_pool):
        for j in range(L):
            pool[k, j] = (value >> (LIMB_BITS * j)) & LIMB_MASK

    r_pad = _bucket(max(1, len(roots)), 16)
    roots_arr = np.zeros(r_pad, dtype=np.int32)
    roots_arr[: len(roots)] = roots
    roots_mask = np.zeros(r_pad, dtype=bool)
    roots_mask[: len(roots)] = True

    prog = Program(
        pad(opcodes, (n_pad,)),
        pad(args, (n_pad, 3)),
        pad(imms, (n_pad, 2)),
        pad(widths, (n_pad,), fill=1),
        pool,
        var_slots,
        roots_arr,
        roots_mask,
        L,
        n,
    )
    prog.source = list(lowered)
    prog.n_consts = max(1, len(const_pool))
    return prog, None


#: ops the compile loop above can lower (everything it special-cases
#: plus the direct OPS table and the bitwise aliases)
_DEVICE_OPS = (
    set(OPS)
    | set(_OP_ALIASES)
    | {"true", "false", "var", "bvar", "const"}
)


def _constraint_supported(root: Term, max_limbs: int) -> bool:
    """Whole-DAG device-language check for ONE constraint: every op
    lowerable, every node width inside the limb cap."""
    width_cap = max_limbs * LIMB_BITS
    seen = set()
    stack = [root]
    while stack:
        t = stack.pop()
        if t._id in seen:
            continue
        seen.add(t._id)
        if t.op not in _DEVICE_OPS or (t.width or 1) > width_cap:
            return False
        for a in t.args:
            if isinstance(a, Term):
                stack.append(a)
    return True


def compile_program_relaxed(
    lowered: List[Term], max_limbs: int = DEFAULT_MAX_LIMBS
) -> Tuple[Optional[Program], int, Optional[str]]:
    """`compile_program_ex` with SEGMENTATION (coverage
    widening): when the full set will not lower, constraints outside
    the device language (or past the limb cap) are dropped and the
    supported remainder compiles as an INCOMPLETE program — sound for
    SAT search because every witness is validated before it counts
    (and, on the flip path, concretely executed), never eligible for
    enumeration-unsat. Returns (program, n_dropped, loss_reason);
    a non-None program with n_dropped > 0 is the segmented form."""
    prog, loss = compile_program_ex(lowered, max_limbs)
    if prog is not None:
        return prog, 0, None
    kept = [c for c in lowered if _constraint_supported(c, max_limbs)]
    n_dropped = len(lowered) - len(kept)
    if not kept or n_dropped == 0:
        # nothing lowerable, or the bail was not per-constraint (e.g.
        # an empty order): segmentation cannot help
        return None, n_dropped, loss
    prog, seg_loss = compile_program_ex(kept, max_limbs)
    if prog is None:
        return None, n_dropped, seg_loss or loss
    prog.complete = False
    return prog, n_dropped, None


def bucket_key(prog: Program) -> Dict[str, int]:
    """The shape bucket a compiled program lands in: the grouping key
    the JAX package's capture artifacts and solver lab report by."""
    return {
        "nodes": int(prog.opcodes.shape[0]),
        "consts": int(prog.const_pool.shape[0]),
        "roots": int(prog.roots.shape[0]),
        "vars": int(_bucket(max(1, len(prog.var_slots)), 4)),
        "limbs": int(prog.limbs),
    }


# ---------------------------------------------------------------------------
# device interpreter + local search (csrc/portfolio.cu, portfolio_sls.cu)
# ---------------------------------------------------------------------------


def _single_device(n_devices: int, devices=None) -> None:
    if n_devices > 1 or (devices is not None and len(list(devices)) > 1):
        raise NotImplementedError(
            "the portfolio's multi-device paths are not ported; "
            "pass n_devices=1 and at most one device")


def _var_widths(prog: Program) -> np.ndarray:
    return np.array([w for _, w in prog.var_slots], dtype=np.int32)


def _width_mask_np(width: int, L: int) -> np.ndarray:
    return np.array(pe.width_mask(width, L), dtype=np.uint32)


def _score(prog: Program, X: np.ndarray, dev) -> Tuple[np.ndarray, np.ndarray]:
    """(solved bool [K], score int64 [K]) of X (uint32 [V, K, L]) through
    portfolio_eval on `dev`."""
    solved, score = pe.portfolio_eval(
        *pe.program_tensors(prog, dev),
        torch.as_tensor(X.astype(np.int32), device=dev),
        n_nodes=prog.n_real_nodes,
    )
    return solved.cpu().numpy(), score.cpu().numpy().astype(np.int64)


def debug_eval(prog: Program, assignment: Dict[str, int], candidates: int = 2,
               device=None):
    """Evaluate a compiled program under one host assignment; returns
    (solved, soft_score) -- a test/debug window into the interpreter."""
    dev = resolve_device(device)
    K = candidates
    L = prog.limbs
    X = np.zeros((len(prog.var_slots), K, L), dtype=np.uint32)
    for slot, (name, _w) in enumerate(prog.var_slots):
        value = assignment.get(name, 0)
        for j in range(L):
            X[slot, :, j] = (value >> (LIMB_BITS * j)) & LIMB_MASK
    solved, score = _score(prog, X, dev)
    return bool(solved[0]), int(score[0])


def _decode_assignment(
    prog: Program, winner, limbs: Optional[int] = None
) -> Dict[str, int]:
    assignment: Dict[str, int] = {}
    for slot, (name, _w) in enumerate(prog.var_slots):
        value = 0
        for j in range(limbs or prog.limbs):
            value |= int(winner[slot, j]) << (LIMB_BITS * j)
        assignment[name] = value
    return assignment


def stack_programs(progs: List[Program], device) -> List[torch.Tensor]:
    """The `portfolio_sls` operands of Q programs, int32 tensors on
    `device`: every stacked axis padded to the max bucket over the batch
    (constants, roots, a var bucket of 4, limbs) and the node axis to
    the largest real node count (no node past a program's own count is
    evaluated, and the kernel's launch is planned for that axis), then
    each query's real var, constant and node counts. Padding var slots
    are width 1 and never mutated: the search draws only the query's
    real vars, and polarity seeding and the injection move only its real
    constants."""
    N = max(max(p.n_real_nodes for p in progs), 1)
    C = max(p.const_pool.shape[0] for p in progs)
    R = max(p.roots.shape[0] for p in progs)
    V = _bucket(max(len(p.var_slots) for p in progs), 4)
    L = max(p.limbs for p in progs)

    def stack(getter, shape, fill=0):
        arr = np.full((len(progs),) + shape, fill, dtype=np.int32)
        for qi, p in enumerate(progs):
            # const pools narrower than the bucket's limb count keep
            # zero upper limbs (values fit the program's own width cap)
            src = np.asarray(getter(p)).astype(np.int64)
            arr[qi][tuple(slice(0, s) for s in src.shape)] = src
        return torch.as_tensor(arr, device=device)

    def counts(getter):
        return torch.as_tensor([getter(p) for p in progs], dtype=torch.int32, device=device)

    return [
        stack(lambda p: p.opcodes[:N], (N,)),
        stack(lambda p: p.args[:N], (N, 3)),
        stack(lambda p: p.imms[:N], (N, 2)),
        stack(lambda p: p.widths[:N], (N,), fill=1),
        stack(lambda p: p.const_pool, (C, L)),
        stack(lambda p: p.roots, (R,)),
        stack(lambda p: p.roots_mask, (R,)),
        stack(_var_widths, (V,), fill=1),
        counts(lambda p: len(p.var_slots)),
        counts(lambda p: getattr(p, "n_consts", 1)),
        counts(lambda p: p.n_real_nodes),
    ]


def _sls_batch(
    live: List[Tuple[int, Program]],
    candidates: int = 64,
    steps: int = 512,
    seed: int = 7,
    n_devices: int = 1,
    devices=None,
    device=None,
) -> Dict[int, Dict[str, int]]:
    """ONE diversified-SLS dispatch over many compiled programs: every
    stacked axis pads to the max bucket over the batch and the programs
    stack on a leading axis; one portfolio_sls launch runs K
    heterogeneous candidates for all of them (query q keyed by seed + q).
    Returns {live index: raw assignment} for solved entries (decoded,
    NOT yet validated)."""
    _single_device(n_devices, devices)
    out: Dict[int, Dict[str, int]] = {}
    if not live:
        return out
    progs = [p for _, p in live]
    solved, winners, _steps = ps.portfolio_sls(
        *stack_programs(progs, resolve_device(device)),
        seed=seed, steps=steps, K=candidates, knobs=PORTFOLIO_DEFAULTS,
    )
    L = max(p.limbs for p in progs)
    solved = solved.cpu().numpy()
    winners = winners.cpu().numpy()
    for qi, (i, p) in enumerate(live):
        if bool(solved[qi]):
            out[i] = _decode_assignment(p, winners[qi], limbs=L)
    return out


def validate_witness(prog: Program, assignment: Dict[str, int]) -> bool:
    """Host-side concrete validation: the decoded device model must
    satisfy every constraint the program was compiled FROM. A
    corrupted device model (transfer fault, decode bug, an
    interpreter divergence) fails here and is discarded — a device
    SAT never counts unvalidated. For segmented programs this covers
    the kept subset (the full set is re-checked by the caller's
    soundness gate or by concrete execution of the witness)."""
    from mythril_tpu_torch.laser.smt.evalterm import eval_term

    try:
        return all(eval_term(c, assignment) for c in prog.source)
    except Exception:
        return False


# ---------------------------------------------------------------------------
# cube-and-conquer + exhaustive enumeration
# ---------------------------------------------------------------------------


def rank_impact_vars(
    prog: Program, probes: int = 16, seed: int = 11, device=None
) -> List[int]:
    """Variable slots ranked by estimated soft-score GRADIENT: over a
    probe batch of random assignments, the mean |delta soft score| of
    re-randomizing ONE variable -- the same gradient signal the SLS
    accept rule climbs. Hard queries cube on the top of this ranking.
    The probes are numpy draws from `seed`, as in the JAX package, so the
    ranking equals its."""
    V = len(prog.var_slots)
    if V == 0:
        return []
    if V > 64 or prog.n_real_nodes > 512:
        # gradient probing evaluates (V + 1) x probes candidates; past
        # this var count -- or on programs big enough that each eval is
        # itself expensive -- fall back to reference counting
        return _occurrence_rank(prog)
    base, moved = impact_scores(prog, probes, seed, device)
    impact = np.abs(moved - base[None, :]).mean(axis=1)
    return list(np.argsort(-impact, kind="stable"))


def impact_scores(prog: Program, probes: int = 16, seed: int = 11,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """`rank_impact_vars`' probe scores: (base int64 [probes], moved int64
    [V, probes]), the soft scores of a probe batch of random assignments
    and of the same batch with variable v re-randomized. The base batch
    and the V re-randomized ones are stacked along K, [V, (V + 1) probes,
    L], and scored in one portfolio_eval call; the numpy draws come in
    the order of the JAX package's loop (one batch, then one row per
    variable)."""
    V = len(prog.var_slots)
    rng = np.random.RandomState(seed)
    L = prog.limbs
    K = probes

    def rand_rows(n):
        return rng.randint(0, 1 << LIMB_BITS, size=(n, K, L)).astype(
            np.uint32
        )

    X = rand_rows(V)
    # clamp to var widths
    for v, (_n, w) in enumerate(prog.var_slots):
        X[v] &= _width_mask_np(w, L)[None, :]
    batch = np.concatenate([X] * (V + 1), axis=1)
    for v in range(V):
        row = rand_rows(1)[0]
        row &= _width_mask_np(prog.var_slots[v][1], L)[None, :]
        batch[v, (v + 1) * K:(v + 2) * K] = row
    _, scores = _score(prog, batch, resolve_device(device))
    return scores[:K], scores[K:].reshape(V, K)


def _occurrence_rank(prog: Program) -> List[int]:
    """Cheap fallback ranking: how often each var slot is referenced
    (via its var node) by other nodes."""
    opcodes = np.asarray(prog.opcodes)
    arg_idx = np.asarray(prog.args)
    imms = np.asarray(prog.imms)
    var_op = OP_INDEX["var"]
    n = prog.n_real_nodes
    node_slot = np.full(opcodes.shape[0], -1, dtype=np.int64)
    var_nodes = opcodes[:n] == var_op
    node_slot[:n][var_nodes] = imms[:n, 0][var_nodes]
    counts = np.zeros(len(prog.var_slots), dtype=np.int64)
    for k in range(3):
        ref = node_slot[arg_idx[:n, k]]
        for s in ref[ref >= 0]:
            counts[s] += 1
    return list(np.argsort(-counts, kind="stable"))


def cube_queries(
    lowered: List[Term],
    prog: Program,
    depth: Optional[int] = None,
    ranked: Optional[List[int]] = None,
) -> List[List[Term]]:
    """Split a hard query into 2^depth CUBE queries: the top-impact
    variables' low bits pinned to every combination via extra
    equality roots. The cubes PARTITION the original search space —
    any cube witness is an original witness, and the union of the
    cubes' spaces is exactly the original's (the merge direction the
    solverperf roundtrip test pins). Returns [] when the program has
    no rankable variables."""
    if depth is None:
        depth = int(PORTFOLIO_DEFAULTS["cube_depth"])
    if depth <= 0 or not prog.var_slots:
        return []
    if ranked is None:
        ranked = rank_impact_vars(prog)
    # pin bits round-robin over the ranked variables (bit 0 of the
    # top-impact var, bit 0 of the next, ... then bit 1 of the top
    # var, ...) until `depth` bits — so a two-variable query still
    # splits 2^depth ways
    pins: List[Tuple[str, int, int]] = []  # (name, width, bit index)
    bit_round = 0
    while len(pins) < depth:
        took = False
        for slot in ranked:
            if len(pins) >= depth:
                break
            name, w = prog.var_slots[slot]
            if bit_round < w:
                pins.append((name, w, bit_round))
                took = True
        if not took:
            break  # every variable's bits are exhausted
        bit_round += 1
    if not pins:
        return []
    depth = len(pins)
    out: List[List[Term]] = []
    for m in range(1 << depth):
        extra: List[Term] = []
        for b, (name, w, bit_idx) in enumerate(pins):
            bit = (m >> b) & 1
            var = terms.bv_var(name, w)
            if w == 1:
                extra.append(terms.eq(var, terms.bv_const(bit, 1)))
            else:
                extra.append(
                    terms.eq(
                        terms.extract(bit_idx, bit_idx, var),
                        terms.bv_const(bit, 1),
                    )
                )
        out.append(list(lowered) + extra)
    return out


def enum_space_bits(prog: Program) -> int:
    """Total bits across the program's variable slots — the size of
    the exhaustive search space (2^bits assignments)."""
    return sum(w for _, w in prog.var_slots)


def device_enumerate(
    prog: Program,
    enum_bits: Optional[int] = None,
    cube_bits: Optional[int] = None,
    n_devices: int = 1,
    device=None,
) -> Tuple[str, Optional[Dict[str, int]]]:
    """COMPLETE check by exhaustive enumeration: every assignment of a
    small variable space is evaluated on the card, in cube-sized chunks
    (portfolio_eval, K = 2^enum_chunk_bits candidates a launch) -- the
    index space is cut on the top-impact variables' bits (each chunk one
    cube). A found witness is sat; an EXHAUSTED space is a device-owned
    unsat verdict -- the portfolio's only complete mode. Segmented
    (incomplete) programs and spaces past enum_bits + cube_bits return
    ("unknown", None).
    """
    _single_device(n_devices)
    if enum_bits is None:
        enum_bits = int(PORTFOLIO_DEFAULTS["enum_bits"])
    if cube_bits is None:
        cube_bits = int(PORTFOLIO_DEFAULTS["enum_cube_bits"])
    B = enum_space_bits(prog)
    if (
        not prog.var_slots
        or not getattr(prog, "complete", True)
        or B == 0
        or B > enum_bits + cube_bits
    ):
        return "unknown", None
    dev = resolve_device(device)

    # bit layout: top-impact vars take the HIGH bits, so the chunk
    # index enumerates cubes over exactly the variables a split-based
    # solver would branch on first
    ranked = _occurrence_rank(prog)
    offsets: Dict[int, int] = {}
    top = B
    for slot in ranked:
        w = prog.var_slots[slot][1]
        top -= w
        offsets[slot] = top
    # chunk size bucketed to ONE shape class per limb count: tiny
    # spaces pad up (duplicate assignments are harmless), large spaces
    # split into 2^(B - chunk_bits) cube chunks
    chunk_bits = min(B, int(PORTFOLIO_DEFAULTS["enum_chunk_bits"]))
    K = max(1 << chunk_bits, 1024)
    n_chunks = 1 << (B - chunk_bits)
    space = 1 << B
    L = prog.limbs
    V = len(prog.var_slots)

    def chunk_X(ci: int) -> np.ndarray:
        idx = (
            (ci << chunk_bits) + np.arange(K, dtype=np.uint64)
        ) % np.uint64(space)
        X = np.zeros((V, K, L), dtype=np.uint32)
        for v, (_name, w) in enumerate(prog.var_slots):
            vals = (idx >> np.uint64(offsets[v])) & np.uint64(
                (1 << w) - 1
            )
            for j in range((w + LIMB_BITS - 1) // LIMB_BITS):
                X[v, :, j] = (
                    (vals >> np.uint64(LIMB_BITS * j))
                    & np.uint64(LIMB_MASK)
                ).astype(np.uint32)
        return X

    for ci in range(n_chunks):
        solved, _score_k = _score(prog, chunk_X(ci), dev)
        if solved.any():
            k = int(np.argmax(solved))
            return "sat", _decode_assignment(prog, chunk_X(ci)[:, k, :])
    return "unsat", None


def device_solve_batch(
    queries: List[List[Term]],
    candidates: int = 64,
    steps: Optional[int] = None,
    seed: int = 7,
    n_devices: int = 1,
    devices=None,
    cube_depth: Optional[int] = None,
    device=None,
    stats: Optional[Dict[str, int]] = None,
) -> List[DeviceVerdict]:
    """The device-FIRST solving funnel for a batch of independent
    queries: the card attacks the whole batch and returns a TYPED
    verdict per position, so callers escalate only genuine unknowns.

    Stages, all on the card:

    1. compile -- segmented (`compile_program_relaxed`) so partial
       device-language coverage still searches; uncompilable queries
       come back unknown with the compile loss.
    2. enumerate -- complete programs over small variable spaces are
       exhaustively evaluated in cube-sized chunks: sat witnesses AND
       device-owned unsat verdicts.
    3. diversified SLS -- one portfolio_sls launch over everything else.
    4. cube-and-conquer -- SLS survivors split into 2^depth cubes on
       their top-impact (soft-score gradient) variables; the cube fan
       rides a second portfolio_sls launch.

    Every sat is host-validated (`validate_witness`) before it counts;
    a corrupted device model degrades to unknown with WITNESS_INVALID,
    never to a wrong verdict. `stats`, where given, gains the count of
    witnesses that failed validation ("witness_invalid") and the host
    seconds spent compiling programs ("compile_s").
    """
    _single_device(n_devices, devices)
    if not queries:
        return []
    if steps is None:
        steps = int(PORTFOLIO_DEFAULTS["first_pass_steps"])
    if cube_depth is None:
        cube_depth = int(PORTFOLIO_DEFAULTS["cube_depth"])
    stats = {} if stats is None else stats
    stats.setdefault("witness_invalid", 0)
    stats.setdefault("compile_s", 0.0)

    out: List[DeviceVerdict] = [
        DeviceVerdict("unknown", None, querylog.LOSS_SLS_NONCONVERGED, None)
        for _ in queries
    ]
    sls_live: List[Tuple[int, Program]] = []
    for i, q in enumerate(queries):
        t0 = time.perf_counter()
        prog, _dropped, loss = compile_program_relaxed(q)
        stats["compile_s"] += time.perf_counter() - t0
        if prog is None or not prog.var_slots:
            out[i] = DeviceVerdict(
                "unknown",
                None,
                loss or querylog.LOSS_QUERY_TRIVIAL,
                None,
            )
            continue
        # stage 2: complete small spaces enumerate outright -- the
        # device owns unsat here, not just sat
        verdict, asn = device_enumerate(prog, device=device)
        if verdict == "sat":
            if validate_witness(prog, asn):
                out[i] = DeviceVerdict("sat", asn, None, "enum")
            else:
                stats["witness_invalid"] += 1
                out[i] = DeviceVerdict(
                    "unknown", None, querylog.LOSS_WITNESS_INVALID, "enum"
                )
            continue
        if verdict == "unsat":
            out[i] = DeviceVerdict("unsat", None, None, "enum")
            continue
        sls_live.append((i, prog))

    # stage 3: one diversified-SLS dispatch over the remainder
    found = _sls_batch(sls_live, candidates, steps, seed, device=device)
    survivors: List[Tuple[int, Program]] = []
    for i, prog in sls_live:
        asn = found.get(i)
        if asn is None:
            survivors.append((i, prog))
        elif validate_witness(prog, asn):
            out[i] = DeviceVerdict("sat", asn, None, "sls")
        else:
            stats["witness_invalid"] += 1
            out[i] = DeviceVerdict(
                "unknown", None, querylog.LOSS_WITNESS_INVALID, "sls"
            )

    # stage 4: cube-and-conquer the survivors -- 2^depth pinned-bit
    # cubes per query, fanned in ONE more dispatch
    if cube_depth > 0 and survivors:
        cube_live: List[Tuple[int, Program]] = []
        parents: List[int] = []
        for i, prog in survivors:
            ranked = rank_impact_vars(prog, device=device)
            for cq in cube_queries(prog.source, prog, depth=cube_depth, ranked=ranked):
                t0 = time.perf_counter()
                cprog = compile_program(cq)
                stats["compile_s"] += time.perf_counter() - t0
                if cprog is None or not cprog.var_slots:
                    continue
                cprog.complete = prog.complete
                cube_live.append((len(parents), cprog))
                parents.append(i)
        cfound = _sls_batch(cube_live, candidates, steps, seed + 7919, device=device)
        for ci, cprog in cube_live:
            i = parents[ci]
            if out[i].status == "sat":
                continue
            asn = cfound.get(ci)
            if asn is None:
                continue
            if validate_witness(cprog, asn):
                out[i] = DeviceVerdict("sat", asn, None, "cube")
            else:
                stats["witness_invalid"] += 1
    return out


def device_check_batch(
    queries: List[List[Term]],
    candidates: int = 64,
    steps: int = 512,
    seed: int = 7,
    n_devices: int = 1,
    device=None,
) -> List[Optional[Dict[str, int]]]:
    """Solve MANY independent queries in ONE dispatch (the
    assignment-only surface over `device_solve_batch`). Returns one
    Optional assignment per query, position-aligned; None proves
    nothing."""
    verdicts = device_solve_batch(
        queries,
        candidates=candidates,
        steps=steps,
        seed=seed,
        n_devices=n_devices,
        device=device,
    )
    return [v.assignment if v.status == "sat" else None for v in verdicts]


def device_check(
    lowered: List[Term],
    candidates: int = 64,
    steps: int = 512,
    seed: int = 7,
    n_devices: int = 1,
    prog: Optional[Program] = None,
    device=None,
) -> Optional[Dict[str, int]]:
    """Try to find a witness for `lowered` on the card: one search of
    one program (a portfolio_sls launch with Q = 1). Returns a
    {var_name: value} assignment, or None (which proves nothing).
    Callers that already compiled `lowered` pass `prog`."""
    _single_device(n_devices)
    if prog is None:
        prog = compile_program(lowered)
    if prog is None or not prog.var_slots:
        return None
    return _sls_batch([(0, prog)], candidates, steps, seed, device=device).get(0)
