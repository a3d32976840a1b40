"""The portfolio kernels' host-side launch plans, and rank_impact_vars'
one-call batch.

- `sls_plan` (ops/portfolio_sls.py) spreads a query's K candidates over a
  cluster of blocks: for every K from 1 to 600 at every L, the kernel's
  numbering of the cluster's slots (csrc/portfolio_sls.cu: lane = rank x
  per_block + j x slots + slot) covers each lane exactly once, within
  the block size and the shared-memory limit.
- Both plans take the shared-memory variant up to the 227 KB a block may
  hold and the global variant past it; the frontier's 143-node L = 16
  programs take the shared one.
- `rank_impact_vars` scores its base probes and its V re-randomized
  batches in one portfolio_eval call (`impact_scores`); the scores equal
  the JAX package's loop of one evaluation per variable, run here
  through the same evaluator.

CPU only: the plans are plain Python, and the evaluator is the kernel's
plain version (the kernels are held to it on the card by chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from mythril_tpu_torch.laser.smt import terms as T
from mythril_tpu_torch.laser.smt.solver import portfolio as pp
from mythril_tpu_torch.ops import portfolio_eval as pe
from mythril_tpu_torch.ops import portfolio_sls as ps

torch.set_num_threads(1)

# the frontier's largest program (PERF.md: 143 real nodes, L = 16) as
# stack_programs pads it: a var bucket of 64, pool and roots of 64 and 16
FRONTIER = dict(n=143, L=16, V=64, C=64, R=16)


def slot_lanes(plan, K):
    """The lanes of a query's cluster as portfolio_sls numbers them:
    (rank, slot, j) -> rank x per_block + j x slots + slot, None past K."""
    T, m = plan["slots"], plan["per_thread"]
    return {(r, t, j): (k if k < K else None)
            for r in range(plan["cluster"]) for t in range(T) for j in range(m)
            for k in (r * T * m + j * T + t,)}


@pytest.mark.parametrize("L", pe.LIMB_COUNTS)
def test_sls_plan_covers_every_lane_once(L):
    for K in range(1, 601):
        plan = ps.sls_plan(FRONTIER["n"], L, K, FRONTIER["V"], FRONTIER["C"], FRONTIER["R"])
        lanes = [k for k in slot_lanes(plan, K).values() if k is not None]
        assert sorted(lanes) == list(range(K)), (L, K, plan)
        assert plan["cluster"] in ps.CLUSTER_SIZES
        assert 1 <= plan["slots"] <= ps.MAX_SLOTS[L]
        # a block's threads (GROUP a slot) come in whole warps
        assert plan["slots"] * pe.GROUP % 32 == 0
        assert plan["per_block"] == plan["slots"] * plan["per_thread"]
        # no block of the cluster is left without a candidate
        assert (plan["cluster"] - 1) * plan["per_block"] < K
        assert plan["smem"] <= pe.SMEM_LIMIT


@pytest.mark.parametrize("L", pe.LIMB_COUNTS)
def test_sls_plan_forced_cluster_sizes_cover_every_lane(L):
    for cluster in ps.CLUSTER_SIZES:
        for K in (64, 320, 512):
            plan = ps.sls_plan(40, L, K, 4, 16, 16, cluster=cluster)
            lanes = [k for k in slot_lanes(plan, K).values() if k is not None]
            assert plan["cluster"] == cluster and sorted(lanes) == list(range(K))


def _last_shared(plan_at):
    """The largest node count at which `plan_at(n)` takes the shared
    variant (the plans take it for every smaller count too)."""
    lo, hi = 1, 1 << 16
    assert plan_at(lo)["variant"] == "shared" and plan_at(hi)["variant"] == "global"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if plan_at(mid)["variant"] == "shared":
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("L", pe.LIMB_COUNTS)
def test_eval_plan_takes_shared_memory_up_to_the_limit(L):
    K, V, C, R = 4096, 8, 16, 16
    n = _last_shared(lambda n: pe.eval_plan(n, L, K, V, C, R))
    below, above = pe.eval_plan(n, L, K, V, C, R), pe.eval_plan(n + 1, L, K, V, C, R)
    assert below["variant"] == "shared" and below["smem"] <= pe.SMEM_LIMIT
    # one node more: even the smallest block's bytes exceed the limit
    smallest = min(pe.EVAL_SLOTS)
    assert pe.eval_smem_bytes(n + 1, L, V, C, R, smallest) > pe.SMEM_LIMIT
    assert above["variant"] == "global" and above["smem"] == 0
    assert above["slots"] * above["blocks"] >= K
    with pytest.raises(ValueError):
        pe.eval_plan(n + 1, L, K, V, C, R, variant="shared")


@pytest.mark.parametrize("L", pe.LIMB_COUNTS)
def test_sls_plan_takes_shared_memory_up_to_the_limit(L):
    K, V, C, R = 64, 8, 16, 16
    n = _last_shared(lambda n: ps.sls_plan(n, L, K, V, C, R))
    below, above = ps.sls_plan(n, L, K, V, C, R), ps.sls_plan(n + 1, L, K, V, C, R)
    assert below["variant"] == "shared" and below["smem"] <= pe.SMEM_LIMIT
    # one node more: one warp of slots a block, each searching its share
    # of the largest cluster's candidates, the least the shared variant
    # could take, exceeds the limit
    per_block = pe.slots_for(-(-K // max(ps.CLUSTER_SIZES)))
    assert ps.sls_smem_bytes(n + 1, L, V, C, R, pe.SLOT_QUANTUM, per_block, True) \
        > pe.SMEM_LIMIT
    assert above["variant"] == "global"
    assert above["cluster"] * above["per_block"] >= K
    with pytest.raises(ValueError):
        ps.sls_plan(n + 1, L, K, V, C, R, variant="shared")


def test_frontier_program_takes_the_shared_variant():
    f = FRONTIER
    for K in (64, 320, 512):
        plan = ps.sls_plan(f["n"], f["L"], K, f["V"], f["C"], f["R"])
        assert plan["variant"] == "shared", (K, plan)
    # device_enumerate's chunk, and rank_impact_vars' batch over 36 vars
    for K, V in ((4096, 4), ((36 + 1) * 16, 36)):
        plan = pe.eval_plan(f["n"], f["L"], K, V, f["C"], f["R"])
        assert plan["variant"] == "shared" and plan["slots"] == 32, (K, plan)


def test_forced_global_variant_is_taken():
    f = FRONTIER
    assert ps.sls_plan(f["n"], 16, 64, 64, 64, 16, variant="global")["variant"] == "global"
    assert pe.eval_plan(f["n"], 16, 4096, 4, 64, 16, variant="global")["variant"] == "global"


def _rank_programs():
    x, y, z = (T.bv_var(f"plan_{n}", 32) for n in "xyz")
    s = T.bv_var("plan_s", 16)
    c = lambda v: T.bv_const(v, 32)  # noqa: E731
    return [
        pp.compile_program([T.eq(T.add(T.mul(x, c(3)), y), c(0x1234567)), T.ult(z, c(9))]),
        pp.compile_program([T.ult(T.udiv(y, c(7)), T.urem(z, c(1000003))),
                            T.eq(T.extract(7, 0, x), T.bv_const(0x5A, 8))]),
        pp.compile_program([T.bor(T.slt(x, z), T.eq(T.zext(s, 16), y)),
                            T.eq(T.bvxor(x, y), z)]),
    ]


@pytest.mark.parametrize("i", range(3))
def test_batched_impact_scores_equal_one_evaluation_per_variable(i):
    prog = _rank_programs()[i]
    V, L, K = len(prog.var_slots), prog.limbs, 16
    base, moved = pp.impact_scores(prog, probes=K, seed=11, device="cpu")
    # the JAX package's loop: the base batch, then one evaluation per
    # variable with that variable's row redrawn
    rng = np.random.RandomState(11)
    X = rng.randint(0, 1 << 16, size=(V, K, L)).astype(np.uint32)
    for v, (_n, w) in enumerate(prog.var_slots):
        X[v] &= np.array(pe.width_mask(w, L), dtype=np.uint32)[None, :]
    _, want_base = pp._score(prog, X, "cpu")
    assert base.tolist() == want_base.tolist()
    for v in range(V):
        X2 = X.copy()
        row = rng.randint(0, 1 << 16, size=(1, K, L)).astype(np.uint32)[0]
        X2[v] = row & np.array(pe.width_mask(prog.var_slots[v][1], L), dtype=np.uint32)[None]
        _, want = pp._score(prog, X2, "cpu")
        assert moved[v].tolist() == want.tolist(), v
    impact = np.abs(moved - base[None, :]).mean(axis=1)
    assert pp.rank_impact_vars(prog, device="cpu") == list(np.argsort(-impact, kind="stable"))


def _limbs(value, L):
    return [(value >> (16 * l)) & 0xFFFF for l in range(L)]


@pytest.mark.parametrize("L", (16, 32))
def test_div_steps_count_the_quotient_bits(L):
    # a division needs one step per quotient bit from the numerator's bit
    # at which the remainder can first reach the divisor; none for x / 0
    # or a numerator shorter than the divisor
    rng = np.random.default_rng(L)
    top = 16 * L
    pairs = [(0, 0), (5, 0), (0, 7), (3, 1000), (1000, 3), (1 << (top - 1), 1),
             ((1 << 256) - 1, 1 << 224), (1 << 224, 1 << 224), ((1 << 224) - 1, 1 << 224)]
    for _ in range(64):
        x_bits, y_bits = int(rng.integers(1, top + 1)), int(rng.integers(0, top + 1))
        pairs.append((int.from_bytes(rng.bytes(top // 8), "little") >> (top - x_bits),
                      int.from_bytes(rng.bytes(top // 8), "little") >> (top - y_bits)))
    a = torch.tensor([_limbs(x, L) for x, _ in pairs], dtype=torch.int64)
    b = torch.tensor([_limbs(y, L) for _, y in pairs], dtype=torch.int64)
    want = [max(0, x.bit_length() - y.bit_length() + 1) if y else 0 for x, y in pairs]
    assert pe.div_steps(a, b).tolist() == want


def test_eval_count_charges_the_selector_division_its_steps():
    # the dispatcher's selector, a 256-bit word over 2**224: at most 32
    # quotient bits, so at most 32 division steps a candidate, not 256
    x = T.bv_var("plan_word", 256)
    prog = pp.compile_program([T.eq(T.udiv(x, T.bv_const(1 << 224, 256)),
                                    T.bv_const(0x12345678, 256))])
    n, L, K = prog.n_real_nodes, prog.limbs, 64
    ops = [int(o) for o in prog.opcodes[:n]]
    assert ops.count(pe.UDIV) == 1
    rng = np.random.default_rng(5)
    words = [int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 64))
             for _ in range(K)]
    X = torch.tensor([[_limbs(w, L) for w in words]], dtype=torch.int64)
    count = {}
    pe.eval_plain(*pe.program_tensors(prog, "cpu"), X, n_nodes=n, count=count)
    steps = [max(0, w.bit_length() - 225 + 1) for w in words]
    assert max(steps) <= 32
    assert count["ops"] == (sum(pe.node_ops(o, L) for o in ops) * K
                            + sum(steps) * pe.div_ops_per_bit(L))
