"""Word-level preprocessing: lower full terms to the blaster fragment.

Passes (all sound, run before bit-blasting):
  1. equality propagation — toplevel `x == const` facts substitute
     through the whole constraint set (the workhorse: most EVM path
     constraints pin calldata selectors / callvalue to constants);
  2. signed div/rem lowering — sdiv/srem rewritten to udiv/urem with
     conditional negation;
  3. UF elimination (Ackermann) — each application becomes a fresh
     variable plus pairwise functional-consistency implications
     (keccak modeling rides on this, reference:
     mythril/laser/ethereum/keccak_function_manager.py);
  4. array elimination — selects pushed through store chains / ites to
     base arrays, then each base select becomes a fresh variable plus
     pairwise read-consistency implications.

Returns the lowered constraints plus a `Recon` describing how to
rebuild a full model (array tables, UF tables, propagated bindings)
from the CNF assignment.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.terms import Term


# ---------------------------------------------------------------------------
# generic bottom-up rewriter
# ---------------------------------------------------------------------------

_BIN = {
    "add": terms.add, "sub": terms.sub, "mul": terms.mul,
    "udiv": terms.udiv, "sdiv": terms.sdiv, "urem": terms.urem,
    "srem": terms.srem, "and": terms.bvand, "or": terms.bvor,
    "xor": terms.bvxor, "shl": terms.shl, "lshr": terms.lshr,
    "ashr": terms.ashr, "concat": terms.concat, "eq": terms.eq,
    "ult": terms.ult, "ule": terms.ule, "slt": terms.slt,
    "sle": terms.sle, "bxor": terms.bxor,
}


def rebuild(op: str, args: tuple, old: Term) -> Term:
    if op in _BIN:
        return _BIN[op](args[0], args[1])
    if op == "not":
        return terms.bvnot(args[0])
    if op == "bnot":
        return terms.bnot(args[0])
    if op == "band":
        return terms.band(*args)
    if op == "bor":
        return terms.bor(*args)
    if op == "ite":
        return terms.ite(args[0], args[1], args[2])
    if op == "extract":
        return terms.extract(args[0], args[1], args[2])
    if op == "zext":
        return terms.zext(args[0], args[1])
    if op == "sext":
        return terms.sext(args[0], args[1])
    if op == "select":
        return terms.select(args[0], args[1])
    if op == "store":
        return terms.store(args[0], args[1], args[2])
    if op == "K":
        return terms.const_array(args[0], old.sort.width)
    if op == "uf":
        return terms.apply_uf(args[0], old.width, args[1:])
    # leaves rebuild to themselves
    return old


def transform(t: Term, leaf_fn, memo: Dict[int, Term]) -> Term:
    """Bottom-up rebuild; leaf_fn may replace leaf terms (vars)."""
    got = memo.get(t._id)
    if got is not None:
        return got
    stack = [(t, False)]
    while stack:
        cur, ready = stack.pop()
        if cur._id in memo:
            continue
        if not ready:
            stack.append((cur, True))
            for a in terms.children(cur):
                if a._id not in memo:
                    stack.append((a, False))
            continue
        if cur.op in ("var", "bvar", "avar", "const", "true", "false"):
            memo[cur._id] = leaf_fn(cur)
            continue
        new_args = tuple(
            memo[a._id] if isinstance(a, Term) else a for a in cur.args
        )
        if all(n is o for n, o in zip(new_args, cur.args)):
            memo[cur._id] = cur
        else:
            memo[cur._id] = rebuild(cur.op, new_args, cur)
    return memo[t._id]


def substitute(t: Term, mapping: Dict[Term, Term], memo: Optional[Dict] = None) -> Term:
    if memo is None:
        memo = {}
    return transform(t, lambda leaf: mapping.get(leaf, leaf), memo)


# ---------------------------------------------------------------------------
# pass 1: equality propagation
# ---------------------------------------------------------------------------


def propagate_equalities(
    constraints: List[Term], max_rounds: int = 8
) -> Tuple[List[Term], Dict[str, Term]]:
    """Extract toplevel `var == const` / bvar facts and substitute.

    Returns (residual constraints, bindings name->const term)."""
    bindings: Dict[str, Term] = {}
    cur = list(constraints)
    for _ in range(max_rounds):
        mapping: Dict[Term, Term] = {}
        residual: List[Term] = []
        for c in cur:
            m = _as_binding(c)
            if m is not None:
                var, val = m
                if var not in mapping and var.args[0] not in bindings:
                    mapping[var] = val
                    bindings[var.args[0]] = val
                    continue
            residual.append(c)
        if not mapping:
            return cur, bindings
        memo: Dict[int, Term] = {}
        cur = [substitute(c, mapping, memo) for c in residual]
        # substituting can expose falsity immediately
        if any(c is terms.FALSE for c in cur):
            return [terms.FALSE], bindings
        cur = [c for c in cur if c is not terms.TRUE]
    return cur, bindings


def _as_binding(c: Term):
    if c.op == "eq":
        a, b = c.args
        if a.op == "const" and b.op == "var":
            return b, a
        if b.op == "const" and a.op == "var":
            return a, b
    if c.op == "bvar":
        return c, terms.TRUE
    if c.op == "bnot" and c.args[0].op == "bvar":
        return c.args[0], terms.FALSE
    return None


# ---------------------------------------------------------------------------
# pass 2: signed division lowering
# ---------------------------------------------------------------------------


def lower_signed(constraints: List[Term]) -> List[Term]:
    memo: Dict[int, Term] = {}

    def walk(t: Term) -> Term:
        got = memo.get(t._id)
        if got is not None:
            return got
        new_args = tuple(walk(a) if isinstance(a, Term) else a for a in t.args)
        out = rebuild(t.op, new_args, t) if new_args != t.args else t
        if out.op in ("sdiv", "srem"):
            a, b = out.args
            w = out.width
            zero = terms.bv_const(0, w)
            na = terms.slt(a, zero)
            nb = terms.slt(b, zero)
            abs_a = terms.ite(na, terms.sub(zero, a), a)
            abs_b = terms.ite(nb, terms.sub(zero, b), b)
            if out.op == "sdiv":
                q = terms.udiv(abs_a, abs_b)
                out = terms.ite(terms.bxor(na, nb), terms.sub(zero, q), q)
            else:
                r = terms.urem(abs_a, abs_b)
                out = terms.ite(na, terms.sub(zero, r), r)
        memo[t._id] = out
        return out

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    try:
        return [walk(c) for c in constraints]
    finally:
        sys.setrecursionlimit(old)


# ---------------------------------------------------------------------------
# passes 3+4: UF and array elimination
# ---------------------------------------------------------------------------


class Recon:
    """Everything needed to turn a CNF model into a full model."""

    def __init__(self):
        self.bindings: Dict[str, Term] = {}  # propagated equalities
        self.uf_apps: Dict[str, List[Tuple[Tuple[Term, ...], str]]] = {}
        self.sel_apps: Dict[str, List[Tuple[Term, str]]] = {}


# Context-free select pushing is memoized globally: store chains are
# shared wholesale across the engine's queries (every path prefix keeps
# selecting from the same storage/balance chains), and the rewrite up
# to the base array does not depend on the query. Base-array selects
# stay as `select(avar, idx)` leaves for the per-query Ackermann logic.
_chain_cache: Dict[Tuple[int, int], Term] = {}
_CHAIN_CACHE_MAX = 1 << 18


def _push_chain(arr: Term, idx: Term) -> Term:
    key = (arr._id, idx._id)
    got = _chain_cache.get(key)
    if got is not None:
        return got
    if arr.op == "store":
        base, i, v = arr.args
        same = terms.eq(i, idx)
        if same is terms.TRUE:
            out = v
        elif same is terms.FALSE:
            out = _push_chain(base, idx)
        else:
            out = terms.ite(same, v, _push_chain(base, idx))
    elif arr.op == "K":
        out = arr.args[0]
    elif arr.op == "ite":
        out = terms.ite(
            arr.args[0], _push_chain(arr.args[1], idx), _push_chain(arr.args[2], idx)
        )
    elif arr.op == "avar":
        out = terms.select(arr, idx)
    else:
        raise NotImplementedError(f"select base: {arr.op}")
    if len(_chain_cache) >= _CHAIN_CACHE_MAX:
        _chain_cache.clear()
    _chain_cache[key] = out
    return out


# The elimination rewrite is context-free once fresh names are
# CONTENT-keyed (a stable structural digest of the select index / UF
# argument tuple) instead of query-positional: the rewrite of a
# constraint no longer depends on which query it appears in, so it is
# memoized process-wide. Path-prefix constraints — re-submitted by
# every feasibility query along a walk — are eliminated exactly once
# per run instead of once per query (measured ~30% of a budget-bound
# contract's host wall before the cache). Per query, only the pairwise
# read-/functional-consistency axioms and the Recon tables are
# assembled, restricted to the apps that query actually references.
#
# Determinism: digests are stable across runs and machines, and every
# per-query assembly below iterates apps in sorted-by-fresh-name
# order, so CNF variable order — and therefore models and report
# bytes — cannot drift with hash seeds or thread interleaving. (The
# sprint being conflict-budgeted, solver.py, is the other half of
# run-stability.)

_ELIM_MEMO_MAX = 1 << 18

_elim_memo: Dict[int, Term] = {}       # original node id -> rewritten
_fresh_of_memo: Dict[int, frozenset] = {}  # rewritten id -> fresh names
_digest_memo: Dict[int, str] = {}
_sel_by_id: Dict[Tuple[str, int], str] = {}  # (array, idx id) -> fresh
_uf_by_id: Dict[tuple, str] = {}
_sel_info: Dict[str, Tuple[str, int, Term]] = {}  # fresh -> (arr, rw, idx)
_uf_info: Dict[str, Tuple[str, int, Tuple[Term, ...]]] = {}
_pair_axioms: Dict[Tuple[str, str], Term] = {}


def _elim_bound() -> None:
    """Bound cache growth. Content-keyed names make a full clear safe:
    re-derived names are bit-identical, so dropping every cache at once
    (registries included) only costs recomputation, never stability."""
    if len(_elim_memo) > _ELIM_MEMO_MAX or len(_sel_info) + len(_uf_info) > _ELIM_MEMO_MAX:
        _elim_memo.clear()
        _fresh_of_memo.clear()
        _digest_memo.clear()
        _pair_axioms.clear()
        _sel_by_id.clear()
        _uf_by_id.clear()
        _sel_info.clear()
        _uf_info.clear()


def _feed(h, data: bytes) -> None:
    """Length-prefix every hashed field so the digest input is
    injectively framed: separator-joined reprs could (however
    improbably) collide across different arg tuples, and a digest
    collision silently merges two select/UF apps into one fresh
    variable — an unsat-side soundness break."""
    h.update(len(data).to_bytes(4, "little"))
    h.update(data)


def _digest(t: Term) -> str:
    """Stable structural digest (iterative post-order, memoized).

    128 bits: fresh names derived from colliding digests would merge
    two different select indices into one variable — a silent
    soundness break on the unsat side — so the width is chosen to put
    the birthday bound far below any realistic app count."""
    got = _digest_memo.get(t._id)
    if got is not None:
        return got
    stack = [(t, False)]
    while stack:
        cur, ready = stack.pop()
        if cur._id in _digest_memo:
            continue
        if not ready:
            stack.append((cur, True))
            for a in cur.args:
                if isinstance(a, Term) and a._id not in _digest_memo:
                    stack.append((a, False))
            continue
        h = hashlib.blake2b(digest_size=16)
        _feed(h, cur.op.encode())
        _feed(
            h,
            repr(
                (cur.sort.kind, cur.sort.width, cur.sort.range_width)
            ).encode(),
        )
        for a in cur.args:
            if isinstance(a, Term):
                _feed(h, _digest_memo[a._id].encode())
            else:
                _feed(h, repr(a).encode())
        _digest_memo[cur._id] = h.hexdigest()
    return _digest_memo[t._id]


def _fresh_select(arr: Term, idx: Term) -> Term:
    name = arr.args[0]
    key = (name, idx._id)
    fresh = _sel_by_id.get(key)
    if fresh is None:
        fresh = f"sel!{name}!{_digest(idx)}"
        _sel_by_id[key] = fresh
        _sel_info.setdefault(fresh, (name, arr.sort.range_width, idx))
    return terms.bv_var(fresh, arr.sort.range_width)


def _fresh_uf(t: Term) -> Term:
    name = t.args[0]
    args = tuple(t.args[1:])
    key = (name, t.width, tuple(a._id for a in args))
    fresh = _uf_by_id.get(key)
    if fresh is None:
        # the uf term's own digest covers name, width and arg digests
        fresh = f"uf!{name}!{_digest(t)}"
        _uf_by_id[key] = fresh
        _uf_info.setdefault(fresh, (name, t.width, args))
    return terms.bv_var(fresh, t.width)


def _rewrite(t: Term) -> Term:
    got = _elim_memo.get(t._id)
    if got is not None:
        return got
    new_args = tuple(
        _rewrite(a) if isinstance(a, Term) else a for a in t.args
    )
    out = rebuild(t.op, new_args, t) if new_args != t.args else t
    if out.op == "select":
        arr, idx = out.args
        if arr.op == "avar":
            out = _fresh_select(arr, idx)
        else:
            out = _rewrite(_push_chain(arr, idx))
    elif out.op == "uf":
        out = _fresh_uf(out)
    _elim_memo[t._id] = out
    return out


def _fresh_of(t: Term) -> frozenset:
    """Fresh (sel!/uf!) var names appearing in a rewritten term."""
    got = _fresh_of_memo.get(t._id)
    if got is not None:
        return got
    stack = [(t, False)]
    while stack:
        cur, ready = stack.pop()
        if cur._id in _fresh_of_memo:
            continue
        if not ready:
            stack.append((cur, True))
            for a in cur.args:
                if isinstance(a, Term) and a._id not in _fresh_of_memo:
                    stack.append((a, False))
            continue
        if cur.op == "var" and cur.args[0].startswith(("sel!", "uf!")):
            _fresh_of_memo[cur._id] = frozenset((cur.args[0],))
            continue
        acc: frozenset = frozenset()
        for a in cur.args:
            if isinstance(a, Term):
                child = _fresh_of_memo[a._id]
                if child:
                    acc = acc | child
        _fresh_of_memo[cur._id] = acc
    return _fresh_of_memo[t._id]


def eliminate_uf_and_arrays(constraints: List[Term], recon: Recon) -> List[Term]:
    """Replace uf apps and base-array selects by fresh vars + axioms."""
    _elim_bound()
    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    try:
        lowered = [_rewrite(c) for c in constraints]
    finally:
        sys.setrecursionlimit(old)

    # the apps THIS query references: fresh vars of the rewritten
    # constraints, closed under "appears in a used app's index/args"
    # (a nested select's fresh var lives only inside the outer app's
    # index term, which re-enters the CNF through the axioms below)
    used: set = set()
    frontier: set = set()
    for c in lowered:
        frontier |= _fresh_of(c)
    while frontier:
        used |= frontier
        nxt: set = set()
        for f in frontier:
            info = _sel_info.get(f)
            if info is not None:
                nxt |= _fresh_of(info[2])
            else:
                uinfo = _uf_info.get(f)
                if uinfo is not None:
                    for a in uinfo[2]:
                        nxt |= _fresh_of(a)
        frontier = nxt - used
    if not used:
        return lowered

    side: List[Term] = []
    for f in sorted(used):
        info = _sel_info.get(f)
        if info is not None:
            recon.sel_apps.setdefault(info[0], []).append((info[2], f))
        else:
            uinfo = _uf_info.get(f)
            if uinfo is None:
                # a var that merely MATCHES the fresh-name pattern but
                # was never minted by this process — e.g. a replayed
                # capture artifact (myth solverlab) whose lowered set
                # carries another run's sel!/uf! vars WITH their
                # consistency axioms already materialized. An opaque
                # var needs no apps and no new axioms.
                continue
            name, _w, args = uinfo
            recon.uf_apps.setdefault(name, []).append((args, f))
    # pairwise read consistency per array (sorted app order: run-stable)
    for arr_name in sorted(recon.sel_apps):
        apps = recon.sel_apps[arr_name]
        rw = _sel_info[apps[0][1]][1]
        for i in range(1, len(apps)):
            idx_i, f_i = apps[i]
            for j in range(i):
                idx_j, f_j = apps[j]
                akey = (f_j, f_i)
                ax = _pair_axioms.get(akey)
                if ax is None:
                    ax = terms.implies(
                        terms.eq(idx_j, idx_i),
                        terms.eq(terms.bv_var(f_j, rw), terms.bv_var(f_i, rw)),
                    )
                    _pair_axioms[akey] = ax
                side.append(ax)
    # pairwise functional consistency per UF
    for uf_name in sorted(recon.uf_apps):
        apps = recon.uf_apps[uf_name]
        for i in range(1, len(apps)):
            args_i, f_i = apps[i]
            w = _uf_info[f_i][1]
            for j in range(i):
                args_j, f_j = apps[j]
                if len(args_j) != len(args_i):
                    continue
                akey = (f_j, f_i)
                ax = _pair_axioms.get(akey)
                if ax is None:
                    same = terms.band(
                        *[terms.eq(x, y) for x, y in zip(args_j, args_i)]
                    )
                    ax = terms.implies(
                        same,
                        terms.eq(terms.bv_var(f_j, w), terms.bv_var(f_i, w)),
                    )
                    _pair_axioms[akey] = ax
                side.append(ax)
    return lowered + side


# ---------------------------------------------------------------------------
# the full pipeline
# ---------------------------------------------------------------------------


def lower(constraints: List[Term]) -> Tuple[List[Term], Recon]:
    recon = Recon()
    cur = [c for c in constraints if c is not terms.TRUE]
    if any(c is terms.FALSE for c in cur):
        return [terms.FALSE], recon
    # split conjunctions for better equality extraction
    flat: List[Term] = []
    for c in cur:
        if c.op == "band":
            flat.extend(c.args)
        else:
            flat.append(c)
    cur, bindings = propagate_equalities(flat)
    recon.bindings = bindings
    cur = lower_signed(cur)
    cur = eliminate_uf_and_arrays(cur, recon)
    # a second propagation round: elimination may expose new equalities
    cur2, bindings2 = propagate_equalities(cur, max_rounds=4)
    recon.bindings.update(bindings2)
    return cur2, recon
