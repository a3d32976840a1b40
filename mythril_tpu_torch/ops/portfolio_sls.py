"""The diversified stochastic local search over Q compiled programs in
one call, through the hand-written CUDA kernel `portfolio_sls`
(csrc/portfolio_sls.cu).

The port's counterpart of `search` in the JAX package's
laser/smt/solver/portfolio.py (:635-812) under `_sls_batch`'s vmap
(:879-1011). Per query, K candidate lanes start from a seeded pool
(random limbs; lane 0 all zero, lane 1 one, a band of lanes from the
program's constant pool cycling per variable), then each step every lane
mutates one variable (a bit flip, a random limb, a zeroed limb, an
increment, a decrement or a pool constant; greedy lanes draw only from
flip, increment and decrement), evaluates the program and accepts the
move when it does not lower the soft score, when it solves, or with the
lane's WalkSAT noise; a lane stalled past its Luby budget restarts. The
search stops when a lane solves or after `steps` steps; the winner is
the first solved lane, else the first lane of the best final score.

Randomness: the JAX package draws from threefry; the port from a
counter-based hash keyed by (seed + query index, step, lane, draw)
(`draws`), computed in the same integers here and in the kernel, and
every noisy accept compares a draw with a per-lane threshold out of
2**32 that the host computes (`thresholds`). So the kernel and this
plain version are bit-equal on the same inputs (solved flags, winners
and steps), while against the JAX package the search agrees only at the
verdict level.

`portfolio_sls(...)` runs the plain version (`sls_plain`) on CPU
tensors and launches the kernel on CUDA tensors, or raises. `LAUNCHES`
counts kernel launches. The launch takes the plan `sls_plan` makes from
the stacked node axis N (`stack_programs` ends it at the largest real
node count), L, K and V: each query's K candidates spread over a
thread-block cluster of 1-8 blocks,
GROUP = 4 threads sharing each candidate's evaluation, with the program,
the candidates and the node values in shared memory, or, where they do
not fit, the global variant.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from mythril_tpu_torch.native import build
from mythril_tpu_torch.ops import portfolio_eval as pe
from mythril_tpu_torch.ops import u256

LAUNCHES = 0

M32 = 0xFFFFFFFF
INIT_STEP = 0xFFFFFFFF  # the step index of the initial pool's draws
INIT_DRAW = 8  # the initial pool's draw of (variable v, limb l): 8 + v L + l
RESTARTED = -(1 << 30)  # a restarted lane's score: its next move is taken
STATE_ROWS = 5  # a candidate's search state in the kernel: score, best, stall, Luby u, v
CTL_BYTES = 32  # a search block's control words: solved flags, argmax, winner
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks a query's cluster may take (8: the portable most)
# candidates a search block may search at once (GROUP threads each), by L
# (csrc/portfolio.cuh: sls_max_slots)
MAX_SLOTS = {16: 64, 32: 64, 64: 32, 128: 32}
# checks only: {"variant": "shared" | "global", "cluster": 1 | 2 | 4 | 8}
# forces the plan's choice
PLAN_OVERRIDE: dict = {}

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("portfolio_sls").portfolio_sls
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] * 7 + [p] * 12 + [ctypes.c_uint32] + [i] * 9 + [p] * 5 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def kernel_smem_bytes(n: int, L: int, V: int, C: int, R: int, slots: int, per_block: int,
                      shared: bool) -> int:
    """The kernel's own count of `sls_smem_bytes` (csrc/portfolio_sls.cu
    :sls_layout, which the C entry holds a launch's bytes to); needs the
    built library."""
    fn = build.load("portfolio_sls").portfolio_sls_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_int
    return fn(L, n, V, C, R, slots, per_block, int(shared))


# ---------------------------------------------------------------------------
# the launch plan (csrc/portfolio_sls.cu:sls_layout lays out the same
# shared regions; chip_smoke.py holds the two counts equal)
# ---------------------------------------------------------------------------


def sls_smem_bytes(n: int, L: int, V: int, C: int, R: int, slots: int, per_block: int,
                   shared: bool) -> int:
    """portfolio_sls's shared bytes for a block of `slots` candidate slots
    (GROUP threads each) and `per_block` candidates: the variable widths,
    the search state, the argmax's scratch and the control words; in the
    shared variant also the staged program, the candidates [V, L,
    per_block] and the slots' value rows (uint16)."""
    al = pe.align16
    common = (al(V * 4) + al(STATE_ROWS * per_block * 4) + al(slots * pe.GROUP * 8)
              + CTL_BYTES)
    if not shared:
        return common
    return (pe.program_smem(n, C, R, L) + common + al(V * L * per_block * 2)
            + pe.value_rows_smem(n, L, slots))


def sls_plan(n: int, L: int, K: int, V: int, C: int, R: int, variant=None,
             cluster=None) -> dict:
    """portfolio_sls's launch for one query of K candidates: a cluster of
    `cluster` blocks, `slots` candidates a block at once (whole warps of
    GROUP threads a slot), each slot searching `per_thread` candidates in
    turn (`per_block` = slots x per_thread; candidate k = rank x
    per_block + j x slots + slot). The fewest candidates a slot first,
    then the smallest cluster, under MAX_SLOTS[L] and SMEM_LIMIT: the
    shared variant where any such shape fits, else the global variant.
    `variant` and `cluster` force the plan's choice (a forced shape that
    does not fit raises)."""
    variant = variant or PLAN_OVERRIDE.get("variant")
    cluster = cluster or PLAN_OVERRIDE.get("cluster")
    sizes = (cluster,) if cluster else CLUSTER_SIZES
    if cluster not in (None,) + CLUSTER_SIZES:
        raise ValueError(f"portfolio_sls: a cluster of {cluster} blocks")
    K = max(K, 1)
    for shared in ((True,) if variant == "shared" else (False,) if variant == "global"
                   else (True, False)):
        for m in range(1, K + 1):
            for cs in sizes:
                per_block = -(-K // cs)
                T = pe.slots_for(-(-per_block // m))
                # a block left without a candidate only where the cluster is forced
                if T > MAX_SLOTS[L] or (not cluster and cs > 1 and (cs - 1) * T * m >= K):
                    continue
                smem = sls_smem_bytes(n, L, V, C, R, T, T * m, shared)
                if smem <= pe.SMEM_LIMIT:
                    return dict(variant="shared" if shared else "global", cluster=cs,
                                slots=T, per_thread=m, per_block=T * m, smem=smem)
    raise ValueError(f"portfolio_sls: no launch fits K={K} candidates of a {n}-node program "
                     f"at L={L}, V={V} (variant {variant}, cluster {cluster})")


# ---------------------------------------------------------------------------
# the counter-based generator (csrc/portfolio_sls.cu computes the same)
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x int64 in [0, 2**32) without overflowing
    int64: c is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_of(key: int, step: int, lanes):
    """The stream of (key, step, lane) for int64 lanes."""
    h = mix32((lanes + 0x9E3779B9) & M32)
    h = mix32(h ^ (step & M32))
    return mix32(h ^ (key & M32))


def draw(h, d):
    """Draw d (an int or int64 tensor) of the streams h."""
    return mix32(h ^ _mul32(torch.as_tensor(d, dtype=torch.int64, device=h.device) + 1,
                            0x85EBCA6B))


def thresholds(K: int, noise_lo: float, noise_hi: float) -> torch.Tensor:
    """The per-lane noise accept thresholds out of 2**32 (int64 [K]):
    WalkSAT noise swept linearly across the lanes (lane 0 a pure hill
    climber, the last a near-random walker)."""
    out = []
    for k in range(K):
        noise = noise_lo + (noise_hi - noise_lo) * (k / max(K - 1, 1))
        out.append(min(max(int(noise * 2.0 ** 32), 0), M32))
    return torch.tensor(out, dtype=torch.int64)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def move_kinds(kind_full, greedy):
    """The move each lane makes: 0 bit flip, 1 random limb, 2 zero limb,
    3 increment, 4 decrement, 5 pool constant; a greedy lane maps its
    draw onto {0, 3, 4}."""
    greedy_kinds = torch.tensor([0, 3, 4], dtype=torch.int64, device=kind_full.device)
    return torch.where(greedy, greedy_kinds[kind_full % 3], kind_full)


def seeded_pool(pool, n_seeded: int, n_consts: int, V: int):
    """The constant-pool band of the initial candidates: lane 2 + s holds,
    for variable v, pool row (s + v) % n_consts (int64 [V, n_seeded, L])."""
    dev = pool.device
    cidx = (torch.arange(n_seeded, device=dev)[None, :]
            + torch.arange(V, device=dev)[:, None]) % n_consts
    return pool[cidx]


def luby_advance(lub_u, lub_v, restart):
    """The O(1) Luby step of the lanes that restart: (u, v) -> (u + 1, 1)
    where (u & -u) == v, else (u, 2 v)."""
    last = (lub_u & -lub_u) == lub_v
    return (torch.where(restart & last, lub_u + 1, lub_u),
            torch.where(restart, torch.where(last, 1, lub_v * 2), lub_v))


def winner(score, solved) -> int:
    """The solved-first argmax: a solved lane beats any soft score; ties
    go to the first lane."""
    return int(torch.argmax(score.to(torch.int64) + solved.to(torch.int64) * (1 << 30)))


def moved_rows(rows, kind, limb, bits, injected, vmask):
    """Each lane's moved variable row (int64 [K, L]): kinds 0-2 change
    limb `limb` (flip bit `bits & 15`, set it to `bits`, zero it), kinds
    3-5 overwrite the whole variable (plus one, minus one, the pool row
    `injected`); then the variable's width mask."""
    K, L = rows.shape
    lanes = torch.arange(K, device=rows.device)
    single = rows.clone()
    cur = rows[lanes, limb]
    single[lanes, limb] = torch.where(
        kind == 0, cur ^ (1 << (bits & 15)), torch.where(kind == 1, bits, 0))
    one = torch.zeros_like(rows)
    one[:, 0] = 1
    stepped = torch.where((kind == 3)[:, None], u256.add(rows, one), u256.sub(rows, one))
    whole = torch.where((kind == 5)[:, None], injected, stepped)
    return torch.where((kind >= 3)[:, None], whole, single) & vmask


def restart_lanes(X, cur, stall, restart, bits, vmask):
    """The Luby restart of the lanes in `restart`: every variable XORed
    with a multiplicative mix of the step's draw `bits` and masked, the
    score set to RESTARTED (so the next move is taken), the stall count
    zeroed. X int64 [V, K, L]; returns (X, cur, stall)."""
    L = X.shape[-1]
    mix_l = _mul32(torch.arange(1, L + 1, dtype=torch.int64, device=X.device), 0x85EBCA6B)
    mix = _mul32(bits, 0x9E3779B9)[:, None] ^ mix_l[None, :]        # [K, L]
    Xf = (X ^ mix[None]) & vmask[:, None, :]
    return (torch.where(restart[None, :, None], Xf, X), torch.where(restart, RESTARTED, cur),
            torch.where(restart, 0, stall))


def _search_one(prog, var_widths, n_vars, n_consts, n_nodes, key, K, steps, thr, n_greedy,
                n_seeded, restart_base, count=None):
    """One query's search: (solved bool, winner int64 [V, L], steps)."""
    opcodes, args, imms, widths, pool, roots, roots_mask = prog
    dev = pool.device
    pool = pool.to(torch.int64)
    C, L = pool.shape
    vw = [int(w) for w in var_widths.tolist()]
    V = len(vw)
    nv, nc = max(int(n_vars), 1), max(int(n_consts), 1)
    lanes = torch.arange(K, dtype=torch.int64, device=dev)
    vmask = torch.tensor([pe.width_mask(w, L) for w in vw], dtype=torch.int64, device=dev)
    caps = torch.tensor([max((w + 15) // 16, 1) for w in vw], dtype=torch.int64, device=dev)
    thr = thr.to(dev)
    host = (opcodes.tolist(), args.tolist(), imms.tolist(), widths.tolist())
    rl = (roots.tolist(), roots_mask.tolist())

    def score(X):
        vals = pe.eval_values(host + (pool,), X, n_nodes, count)
        return pe.score_values(vals, *rl)

    h0 = stream_of(key, INIT_STEP, lanes)
    d = INIT_DRAW + torch.arange(V, device=dev)[:, None] * L + torch.arange(L, device=dev)
    X = draw(h0[None, :, None], d[:, None, :]) & pe.M16          # [V, K, L]
    X[:, 0, :] = 0
    if K > 1:
        X[:, 1, :] = 0
        X[:, 1, 0] = 1
    if n_seeded:
        X[:, 2:2 + n_seeded, :] = seeded_pool(pool, n_seeded, nc, V)
    X &= vmask[:, None, :]
    solved, cur = score(X)
    cur = cur.to(torch.int64)
    best = cur.clone()
    stall = torch.zeros(K, dtype=torch.int64, device=dev)
    lub_u = torch.ones(K, dtype=torch.int64, device=dev)
    lub_v = torch.ones(K, dtype=torch.int64, device=dev)
    greedy = lanes < n_greedy
    it = 0
    done = bool(solved.any())
    while it < steps and not done:
        h = stream_of(key, it, lanes)
        r = [draw(h, j) for j in range(6)]
        v = r[0] % nv
        kind_full = r[1] % 6
        kind = move_kinds(kind_full, greedy)
        limb = (r[2] % L) % caps[v]
        bits = r[3] & pe.M16
        cidx = (r[4] % max(C, 1)) % nc
        Xp = X.clone()
        Xp[v, lanes, :] = moved_rows(X[v, lanes, :], kind, limb, bits, pool[cidx], vmask[v])
        nsolved, nscore = score(Xp)
        nscore = nscore.to(torch.int64)
        accept = (nscore >= cur) | (r[5] < thr) | nsolved
        X = torch.where(accept[None, :, None], Xp, X)
        cur = torch.where(accept, nscore, cur)
        improved = nscore > best
        best = torch.maximum(best, nscore)
        stall = torch.where(improved | nsolved, 0, stall + 1)
        restart = (stall >= lub_v * restart_base) & ~nsolved
        if count is not None:
            count["restarts"] = count.get("restarts", 0) + int(restart.sum())
        X, cur, stall = restart_lanes(X, cur, stall, restart, bits, vmask)
        lub_u, lub_v = luby_advance(lub_u, lub_v, restart)
        it += 1
        done = bool(nsolved.any())
    solved, final = score(X)
    win = winner(final, solved)
    return bool(solved[win]), X[:, win, :], it


def sls_plain(opcodes, args, imms, widths, pool, roots, roots_mask, var_widths, n_vars,
              n_consts, n_nodes, *, seed, steps, K, thr, n_greedy, n_seeded, restart_base,
              count=None):
    """The plain PyTorch version of `portfolio_sls`, query by query
    (`count`: the evaluations' work, see `portfolio_eval.eval_values`,
    and under "restarts" the Luby restarts the lanes took)."""
    Q = opcodes.shape[0]
    V, L = var_widths.shape[1], pool.shape[-1]
    solved = torch.zeros(Q, dtype=torch.bool, device=pool.device)
    winners = torch.zeros((Q, V, L), dtype=torch.int32, device=pool.device)
    taken = torch.zeros(Q, dtype=torch.int32, device=pool.device)
    for q in range(Q):
        prog = tuple(t[q] for t in (opcodes, args, imms, widths, pool, roots, roots_mask))
        s, w, it = _search_one(prog, var_widths[q], int(n_vars[q]), int(n_consts[q]),
                               int(n_nodes[q]), (seed + q) & M32, K, steps, thr, n_greedy,
                               n_seeded, restart_base, count)
        solved[q], winners[q], taken[q] = s, w.to(torch.int32), it
    return solved, winners, taken


def search_args(K: int, knobs: Dict[str, float]) -> dict:
    """The search's lane strategy from the portfolio knobs: greedy and
    seeded lane counts, the Luby unit and the per-lane noise thresholds."""
    return dict(n_greedy=max(1, int(K * float(knobs["greedy_frac"]))),
                n_seeded=max(0, min(K - 2, int(K * float(knobs["seeded_frac"])))),
                restart_base=int(knobs["restart_base"]),
                thr=thresholds(K, float(knobs["noise_lo"]), float(knobs["noise_hi"])))


def portfolio_sls(opcodes, args, imms, widths, pool, roots, roots_mask, var_widths, n_vars,
                  n_consts, n_nodes, *, seed: int, steps: int, K: int, knobs: Dict[str, float]):
    """(solved bool [Q], winners int32 [Q, V, L], steps int32 [Q]) of the
    search over Q stacked programs: opcodes [Q, N], args [Q, N, 3], imms
    [Q, N, 2], widths [Q, N], pool [Q, C, L], roots and roots_mask
    [Q, R], var_widths [Q, V], and per query the real variable, constant
    and node counts (each node count at most N: the launch is planned
    for N nodes); all int32 tensors on one device. `knobs` holds the
    portfolio's noise_lo, noise_hi, greedy_frac, seeded_frac and
    restart_base."""
    strategy = search_args(K, knobs)
    operands = [opcodes, args, imms, widths, pool, roots, roots_mask, var_widths, n_vars,
                n_consts, n_nodes]
    if not build.on_cuda(operands, "portfolio_sls"):
        return sls_plain(*operands, seed=seed, steps=steps, K=K, **strategy)
    n_greedy, n_seeded = strategy["n_greedy"], strategy["n_seeded"]
    restart_base, thr = strategy["restart_base"], strategy["thr"]
    Q, N = opcodes.shape
    C, L = pool.shape[1:]
    R, V = roots.shape[1], var_widths.shape[1]
    if L not in pe.LIMB_COUNTS or K < 1:
        raise ValueError(f"portfolio_sls takes L in {pe.LIMB_COUNTS} and K >= 1, "
                         f"got L {L}, K {K}")
    dev = pool.device
    ins = [t.to(torch.int32).contiguous() for t in operands]
    thr = thr.to(dev)
    solved = torch.zeros(Q, dtype=torch.int32, device=dev)
    winners = torch.zeros((Q, V, L), dtype=torch.int32, device=dev)
    taken = torch.zeros(Q, dtype=torch.int32, device=dev)
    global LAUNCHES
    if Q:
        # the plan takes the node axis N, at least every query's count
        plan = sls_plan(N, L, K, V, C, R)
        G = plan["cluster"] * plan["slots"]
        Kp = plan["cluster"] * plan["per_block"]
        if (N + pe.SCRATCH_ROWS) * L * G >= 1 << 31 or V * L * Kp >= 1 << 31:
            raise ValueError(f"portfolio_sls: K={K} candidates of a {N}-node program at "
                             f"L={L} overflow the kernel's int32 indices")
        # the global variant's scratch: candidates [Q, V, L, cluster x
        # per_block] and each slot's value rows [Q, N + 4, L, cluster x
        # slots]
        on_global = plan["variant"] == "global"
        xs = torch.empty(Q * V * L * Kp if on_global else 1, dtype=torch.int32, device=dev)
        vals = torch.empty(Q * (N + pe.SCRATCH_ROWS) * L * G if on_global else 1,
                           dtype=torch.int32, device=dev)
        build.launch(_kernel_fn(), pool.get_device(), L, Q, K, N, C, R, V,
                     *(t.data_ptr() for t in ins), thr.data_ptr(), seed & M32, steps,
                     n_greedy, n_seeded, restart_base, int(not on_global),
                     plan["cluster"], plan["slots"], plan["per_thread"], plan["smem"],
                     xs.data_ptr(), vals.data_ptr(), solved.data_ptr(), winners.data_ptr(),
                     taken.data_ptr())
        LAUNCHES += 1
    return solved != 0, winners, taken
