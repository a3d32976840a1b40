"""The flip frontier: from one symbolic wave to the next generation.

Step 3 of the main path, the port's counterpart of what the JAX
explorer (laser/batch/explore.py there) does between two waves:

1. `harvest`: every lane's branch journal marks its (pc, taken)
   directions covered, per contract (the explorer's coverage harvest);
2. `collect_candidates`: per lane, the explorer's candidate rule
   (`explore.lane_flip_candidate`): the first symbolic decision whose
   other direction no lane of the contract has covered or attempted
   becomes a flip candidate, its path condition with the last decision
   inverted, decoded from the arena (`ArenaView.path_condition`); a
   prefix with an opaque decision is recorded as opaque instead;
3. `lower_flips` (the explorer's): each path condition through
   `preprocess.lower`;
4. `solve_frontier`: the lowered queries in one `device_solve_batch`
   dispatch at the explorer's settings (64 candidates, 192 first-pass
   steps, cube depth 3): enumeration, the SLS and the cube fan on the
   card, every SAT validated;
5. `next_wave`: a lane whose query was solved runs its witness as
   calldata (the explorer's `witness_bytes`), every other lane a fresh
   draw of `seeds.selector_seeds` with the next generation's seed, through
   `reseed_wave_inplace` and `sym_run`.

This is the flip phase of `chip_smoke.py` and the frontier parity
tools: a wave's frontier solved on its own, generation after
generation. The whole exploration loop (mutation top-up, carries,
poison seeding, steering, completeness gates, the pipelined schedule)
is `laser/batch/explore.py`'s `DeviceCorpusExplorer`.

`canonical_digest` gives a term list a digest that does not depend on
the term interner's creation ids, so the port's decode can be held to
the JAX package's (flip_frontier_pinned.json, regenerated by
`PYTHONPATH=. python tests/test_torch_arena.py --pin`).
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mythril_tpu_torch.laser import symbolic_wave as wave
from mythril_tpu_torch.laser.batch import seeds
from mythril_tpu_torch.laser.batch.explore import (
    lane_flip_candidate,
    lower_flips,
    witness_bytes,
)
from mythril_tpu_torch.laser.batch import symbolic as sym
from mythril_tpu_torch.laser.smt.solver import portfolio
from mythril_tpu_torch.laser.smt.solver.preprocess import lower

PINNED = Path(__file__).with_name("flip_frontier_pinned.json")

# the explorer's settings (DeviceCorpusExplorer defaults and its
# device-first funnel: portfolio_candidates, first_pass_steps, cube_depth)
LANES_PER_CONTRACT = 32
GENERATIONS = 4
CANDIDATES = 64
FIRST_PASS_STEPS = 192
CUBE_DEPTH = 3
SEED = 7

_COMMUTATIVE = frozenset({"add", "mul", "and", "or", "xor", "eq", "bxor", "band", "bor"})


class Track:
    """One contract's frontier bookkeeping: the (pc, direction) targets
    some lane covered, and those a candidate was collected for."""

    __slots__ = ("covered", "attempted")

    def __init__(self):
        self.covered: set = set()
        self.attempted: set = set()


def lanes_by_contract(code_ids) -> Dict[int, List[int]]:
    """{contract: its lanes in lane order}, contracts in ascending order."""
    out: Dict[int, List[int]] = {}
    for lane, c in enumerate(np.asarray(code_ids).tolist()):
        out.setdefault(int(c), []).append(lane)
    return dict(sorted(out.items()))


def harvest(view, tracks: Dict[int, Track], by_contract) -> Dict[str, int]:
    """Mark every journal direction of every lane covered. Returns the
    journal's decisions by condition: symbolic (an arena term), opaque,
    concrete."""
    census = {"symbolic": 0, "opaque": 0, "concrete": 0}
    for c, lanes in by_contract.items():
        track = tracks.setdefault(c, Track())
        for lane in lanes:
            for pc, taken, tid in view.journal(lane):
                track.covered.add((pc, taken))
                census["symbolic" if tid > 0 else "opaque" if tid < 0 else "concrete"] += 1
    return census


def collect_candidates(view, tracks: Dict[int, Track], by_contract):
    """(candidates, tried, opaque): candidates are (lane, journal index,
    path condition, target) in contract-major lane order, at most one
    per lane, by the explorer's rule (`explore.lane_flip_candidate`);
    `tried` counts the targets attempted, `opaque` those whose prefix
    held an opaque decision."""
    out = []
    tried = opaque = 0
    for c, lanes in by_contract.items():
        track = tracks.setdefault(c, Track())
        for lane in lanes:
            found, counts = lane_flip_candidate(view, lane, track.covered, track.attempted)
            tried += counts["tried"]
            opaque += len(counts["opaque"])
            if found is not None:
                out.append((lane,) + found)
    return out, tried, opaque


def solve_frontier(view, tracks: Dict[int, Track], by_contract, device=None,
                   candidates: int = CANDIDATES, steps: int = FIRST_PASS_STEPS,
                   cube_depth: int = CUBE_DEPTH, seed: int = SEED) -> dict:
    """Harvest, collect, lower and solve one wave's frontier. Returns a
    dict: `candidates` [(lane, k, conditions, target)], `kept` (indices
    of the lowered ones), `verdicts` (one DeviceVerdict per kept query),
    `witnesses` {lane: calldata}, counts (`decisions` of the journals by
    condition, `tried`, `opaque`,
    `lower_failed`, `compile_losses`, `verdicts_by_via`,
    `witness_invalid`) and times in ms (`decode_ms`, `lower_compile_ms`,
    `solve_ms`)."""
    t0 = time.perf_counter()
    census = harvest(view, tracks, by_contract)
    cands, tried, opaque = collect_candidates(view, tracks, by_contract)
    t1 = time.perf_counter()
    lowered, kept = lower_flips([conds for _, _, conds, _ in cands])
    t2 = time.perf_counter()
    stats: Dict[str, float] = {}
    verdicts = portfolio.device_solve_batch(
        lowered, candidates=candidates, steps=steps, cube_depth=cube_depth, seed=seed,
        device=device, stats=stats) if lowered else []
    t3 = time.perf_counter()
    compile_s = stats.get("compile_s", 0.0)
    losses = Counter(v.loss for v in verdicts
                     if v.status == "unknown" and v.loss in _COMPILE_LOSSES)
    by_via = Counter(v.via if v.status != "unknown" else "unknown" for v in verdicts)
    witnesses = {}
    for i, v in zip(kept, verdicts):
        if v.status == "sat":
            witnesses[cands[i][0]] = witness_bytes(v.assignment)
    return {
        "candidates": cands, "kept": kept, "verdicts": verdicts, "witnesses": witnesses,
        "decisions": census, "tried": tried, "opaque": opaque, "lower_failed": len(cands) - len(kept),
        "compile_losses": dict(losses), "verdicts_by_via": dict(by_via),
        "witness_invalid": int(stats.get("witness_invalid", 0)),
        "decode_ms": (t1 - t0) * 1e3,
        "lower_compile_ms": ((t2 - t1) + compile_s) * 1e3,
        "solve_ms": ((t3 - t2) - compile_s) * 1e3,
    }


_COMPILE_LOSSES = ("LOWERING_UNSUPPORTED", "BUCKET_OVERFLOW", "QUERY_TRIVIAL")


def generation_calldata(codes, code_ids, lanes_per_stripe: int, generation: int,
                        witnesses: Dict[int, bytes]) -> List[bytes]:
    """Next-generation calldata: stripe k draws `selector_seeds` from
    random.Random(generation * stripes + k); a lane with a witness runs
    the witness instead."""
    code_ids = np.asarray(code_ids)
    stripes = len(code_ids) // lanes_per_stripe
    out: List[bytes] = []
    for k in range(stripes):
        c = int(code_ids[k * lanes_per_stripe])
        out += seeds.selector_seeds(codes[c].hex(), lanes_per_stripe, wave.CALLDATA_LEN,
                                    random.Random(generation * stripes + k))
    for lane, data in witnesses.items():
        out[lane] = data
    return out


def wave_seed(code_ids, calldata: Sequence[bytes]):
    """The `reseed_wave_inplace` delta of a wave in the explorer's
    first-wave environment: these calldata, no value, balance or
    storage."""
    n = len(calldata)
    width = max(len(d) for d in calldata)
    cd = np.zeros((n, width), np.uint8)
    for i, data in enumerate(calldata):
        cd[i, :len(data)] = np.frombuffer(data, np.uint8)
    sizes = np.array([len(d) for d in calldata], np.int32)
    words = np.zeros((n, sym.W), np.uint32)
    slab = np.zeros((n, 1, sym.W), np.uint32)
    return (np.asarray(code_ids, np.int32), cd, sizes, words, words, slab, slab,
            np.zeros(n, np.int32), np.zeros(n, bool))


def next_wave(symb, table, code_ids, calldata, max_steps: int = wave.PIN_SETTINGS["max_steps"]):
    """Reseed the spent wave `symb` in place with `calldata` and run it:
    (SymBatch, steps)."""
    symb = sym.reseed_wave_inplace(symb, *wave_seed(code_ids, calldata))
    out, steps, _ = sym.sym_run_inplace(symb, table, max_steps=max_steps)
    return out, steps


def realized(view, by_contract, targets: Dict[int, List[Tuple[int, bool]]]) -> int:
    """How many of `targets` ({contract: [(pc, direction)]}) appear in the
    journals of the contract's lanes of `view`."""
    hit = 0
    for c, want in targets.items():
        seen = {(pc, taken) for lane in by_contract.get(c, ())
                for pc, taken, _ in view.journal(lane)}
        hit += sum(1 for t in want if t in seen)
    return hit


# ---------------------------------------------------------------------------
# canonical digests of decoded and lowered queries
# ---------------------------------------------------------------------------


def _node_digest(t, memo: Dict[int, str]) -> str:
    """A Merkle digest of a term DAG by structure: op, sort and payloads,
    with the children of commutative ops (whose order the interner's
    creation ids decide) sorted."""
    stack = [(t, False)]
    while stack:
        cur, ready = stack.pop()
        if id(cur) in memo:
            continue
        kids = [a for a in cur.args if hasattr(a, "op")]
        if not ready:
            stack.append((cur, True))
            stack.extend((a, False) for a in kids if id(a) not in memo)
            continue
        parts = [memo[id(a)] if hasattr(a, "op") else repr(a) for a in cur.args]
        if cur.op in _COMMUTATIVE:
            parts = sorted(parts)
        sort = cur.sort
        head = f"{cur.op}|{sort.kind}|{sort.width}|{sort.range_width}"
        memo[id(cur)] = hashlib.sha256("\n".join([head] + parts).encode()).hexdigest()
    return memo[id(t)]


def canonical_digest(constraints) -> str:
    """sha256 of a list of terms (or of Bool/BitVec wrappers) as the
    sorted digests of its members: equal for the JAX package's and the
    port's decode of one query whatever their creation ids."""
    memo: Dict[int, str] = {}
    raws = [getattr(c, "raw", c) for c in constraints]
    return hashlib.sha256(
        "\n".join(sorted(_node_digest(r, memo) for r in raws)).encode()).hexdigest()


def candidate_digests(cands, lowered_of) -> List[dict]:
    """Per candidate: lane, journal index, target, and the canonical
    digests of its path condition and its lowered query (`lowered_of(i)`,
    None where it did not lower)."""
    out = []
    for i, (lane, k, conds, target) in enumerate(cands):
        low = lowered_of(i)
        out.append({"lane": lane, "k": k, "target": [target[0], target[1]],
                    "path": canonical_digest(conds),
                    "lowered": None if low is None else canonical_digest(low)})
    return out


def load_pinned() -> dict:
    """The JAX package's decode of the pinned wave's frontier: settings,
    tried/opaque counts and per-candidate digests."""
    return json.loads(PINNED.read_text())


def pinned_wave_frontier(view, code_ids, lower_fn=lower) -> dict:
    """A wave's first frontier in the pinned file's form (everything but
    its settings): tried and opaque counts, per-candidate digests. The
    view may be the JAX package's, with its `lower` as `lower_fn`."""
    tracks: Dict[int, Track] = {}
    by_contract = lanes_by_contract(code_ids)
    harvest(view, tracks, by_contract)
    cands, tried, opaque = collect_candidates(view, tracks, by_contract)
    lowered, kept = lower_flips([conds for _, _, conds, _ in cands], lower_fn=lower_fn)
    where = dict(zip(kept, lowered))
    return {"tried": tried, "opaque": opaque,
            "candidates": candidate_digests(cands, where.get)}


def describe(result: dict) -> str:
    """One line of a solved frontier's counts."""
    return (f"journal decisions {result['decisions']}, "
            f"candidates {len(result['candidates'])} (tried {result['tried']}, opaque "
            f"{result['opaque']}, lower failed {result['lower_failed']}), compile losses "
            f"{result['compile_losses']}, verdicts {result['verdicts_by_via']}, "
            f"witness invalid {result['witness_invalid']}")


def frontier_queries(result: dict, limit: Optional[int] = None) -> list:
    """The compiled programs of a solved frontier's lowered queries, at
    most `limit` (for holding the kernels against their plain versions on
    real programs)."""
    out = []
    for i in result["kept"]:
        if limit is not None and len(out) >= limit:
            break
        conds = result["candidates"][i][2]
        lowered, _ = lower([c.raw for c in conds])
        prog, _, _ = portfolio.compile_program_relaxed(lowered)
        if prog is not None and prog.var_slots:
            out.append(prog)
    return out


def run_generations(stripes: int, lanes_per_stripe: int, generations: int = GENERATIONS,
                    device=None, log=None, max_steps: int = wave.PIN_SETTINGS["max_steps"],
                    **solve_kwargs) -> List[dict]:
    """`generations` waves of the explorer's geometry (`make_wave` with
    `stripes` x `lanes_per_stripe` lanes over the vendored contracts):
    each runs `sym_run`, is read back by `ArenaView`, has its frontier
    solved, and seeds the next. Returns per generation the solved
    frontier's dict plus `steps`, `wave_ms`, `view_ms`, `next_wave_ms`
    and `realized` (of this generation's witnesses, the targets the next
    generation's journals reach; None for the last)."""
    from mythril_tpu_torch.laser.batch.arena import ArenaView

    codes = wave.load_contracts()
    symb, table = wave.make_wave(stripes, lanes_per_stripe, device=device)
    code_ids = symb.base.code_id.cpu().numpy()
    by_contract = lanes_by_contract(code_ids)
    tracks: Dict[int, Track] = {}
    t0 = time.perf_counter()
    out, steps, _ = sym.sym_run_inplace(symb, table, max_steps=max_steps)
    wave_ms = (time.perf_counter() - t0) * 1e3
    history: List[dict] = []
    prev_targets = None
    for g in range(generations):
        t0 = time.perf_counter()
        view = ArenaView(out)
        view_ms = (time.perf_counter() - t0) * 1e3
        if prev_targets is not None:
            history[-1]["realized"] = realized(view, by_contract, prev_targets)
        res = solve_frontier(view, tracks, by_contract, device=device, **solve_kwargs)
        res.update(generation=g, steps=steps, wave_ms=wave_ms, view_ms=view_ms,
                   realized=None, next_wave_ms=None)
        prev_targets = {}
        for i, v in zip(res["kept"], res["verdicts"]):
            if v.status == "sat":
                lane, _, _, target = res["candidates"][i]
                prev_targets.setdefault(int(code_ids[lane]), []).append(target)
        history.append(res)
        if log is not None:
            log(g, res)
        if g + 1 == generations:
            break
        calldata = generation_calldata(codes, code_ids, lanes_per_stripe, g + 1,
                                       res["witnesses"])
        t0 = time.perf_counter()
        out, steps = next_wave(out, table, code_ids, calldata, max_steps=max_steps)
        res["next_wave_ms"] = wave_ms = (time.perf_counter() - t0) * 1e3
    return history
