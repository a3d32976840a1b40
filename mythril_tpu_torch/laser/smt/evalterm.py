"""Concrete evaluation of terms under an assignment.

Role-equivalent of z3's model evaluation (`model.eval(expr)` in the
reference, e.g. mythril/analysis/solver.py:176-202): given concrete
values for every free variable, compute the value of any term. Also the
fitness oracle for the local-search solver and the checker that every
model the solver emits actually satisfies the constraints (the
reference trusts z3; we verify ourselves).

Assignment layout:
  bv/bool vars : name -> int (bools as 0/1)
  arrays       : name -> (default:int, {index:int -> value:int})
  UFs          : name -> {args tuple -> int}   (missing entry -> 0)
"""

from __future__ import annotations

from typing import Dict, Iterable

from mythril_tpu_torch.laser.smt.terms import Term, _mask, _signed


def _scalar_children(t: Term):
    """Child terms to evaluate as scalars; array-sorted children are
    expanded into their own scalar dependencies (store indices/values,
    K defaults, ite conditions)."""
    for a in t.args:
        if not isinstance(a, Term):
            continue
        if a.sort.kind != "array":
            yield a
            continue
        stack = [a]
        while stack:
            arr = stack.pop()
            if arr.op == "store":
                yield arr.args[1]
                yield arr.args[2]
                stack.append(arr.args[0])
            elif arr.op == "K":
                yield arr.args[0]
            elif arr.op == "ite":
                yield arr.args[0]
                stack.append(arr.args[1])
                stack.append(arr.args[2])
            # avar: no scalar deps


def _eval_into(t: Term, memo: Dict[int, int], assignment: Dict) -> int:
    stack = [(t, False)]
    while stack:
        cur, ready = stack.pop()
        if cur._id in memo:
            continue
        if not ready:
            stack.append((cur, True))
            for a in _scalar_children(cur):
                if a._id not in memo:
                    stack.append((a, False))
            continue
        memo[cur._id] = _eval_node(cur, memo, assignment)
    return memo[t._id]


def eval_term(t: Term, assignment: Dict) -> int:
    """Iterative post-order evaluation (terms can be ~10^5 nodes deep)."""
    return _eval_into(t, {}, assignment)


def eval_many(terms: Iterable[Term], assignment: Dict) -> list:
    memo: Dict[int, int] = {}
    return [_eval_into(t, memo, assignment) for t in terms]


def _eval_node(t: Term, memo: Dict[int, int], asn: Dict) -> int:
    op = t.op
    A = t.args

    def v(i):
        return memo[A[i]._id]

    if op == "const":
        return A[0]
    if op == "true":
        return 1
    if op == "false":
        return 0
    if op in ("var", "bvar"):
        return asn.get(A[0], 0)
    if op == "avar":
        # an array leaf evaluated directly has no scalar value; selects
        # handle arrays below. Encountering it here is a usage bug.
        raise TypeError(f"cannot scalar-evaluate array {A[0]}")

    w = t.width
    m = _mask(w) if t.sort.kind == "bv" else 1

    if op == "add":
        return (v(0) + v(1)) & m
    if op == "sub":
        return (v(0) - v(1)) & m
    if op == "mul":
        return (v(0) * v(1)) & m
    if op == "udiv":
        d = v(1)
        return (v(0) // d) & m if d else 0
    if op == "sdiv":
        d = v(1)
        if d == 0:
            return 0
        x, y = _signed(v(0), w), _signed(d, w)
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        return q & m
    if op == "urem":
        d = v(1)
        return v(0) % d if d else 0
    if op == "srem":
        d = v(1)
        if d == 0:
            return 0
        x, y = _signed(v(0), w), _signed(d, w)
        r = abs(x) % abs(y)
        if x < 0:
            r = -r
        return r & m
    if op == "and":
        return v(0) & v(1)
    if op == "or":
        return v(0) | v(1)
    if op == "xor":
        return v(0) ^ v(1)
    if op == "not":
        return ~v(0) & m
    if op == "shl":
        s = v(1)
        return (v(0) << s) & m if s < w else 0
    if op == "lshr":
        s = v(1)
        return v(0) >> s if s < w else 0
    if op == "ashr":
        s = min(v(1), w)
        return (_signed(v(0), w) >> s) & m
    if op == "concat":
        return (v(0) << A[1].width) | v(1)
    if op == "extract":
        hi, lo = A[0], A[1]
        return (memo[A[2]._id] >> lo) & _mask(hi - lo + 1)
    if op == "zext":
        return memo[A[0]._id]
    if op == "sext":
        src = A[0]
        return _signed(memo[src._id], src.width) & m
    if op == "ite":
        return v(1) if v(0) else v(2)
    if op == "eq":
        a, b = A
        if a.sort.kind == "array":
            da, ta = _eval_array(a, memo, asn)
            db, tb = _eval_array(b, memo, asn)
            na = {k: x for k, x in ta.items() if x != da}
            nb = {k: x for k, x in tb.items() if x != db}
            return int(da == db and na == nb)
        return int(v(0) == v(1))
    if op == "ult":
        return int(v(0) < v(1))
    if op == "ule":
        return int(v(0) <= v(1))
    if op == "slt":
        return int(_signed(v(0), A[0].width) < _signed(v(1), A[1].width))
    if op == "sle":
        return int(_signed(v(0), A[0].width) <= _signed(v(1), A[1].width))
    if op == "band":
        return int(all(memo[a._id] for a in A))
    if op == "bor":
        return int(any(memo[a._id] for a in A))
    if op == "bnot":
        return 1 - v(0)
    if op == "bxor":
        return v(0) ^ v(1)
    if op == "select":
        default, table = _eval_array(A[0], memo, asn)
        return table.get(v(1), default)
    if op == "uf":
        table = asn.get(A[0], {})
        key = tuple(memo[a._id] for a in A[1:])
        return table.get(key, 0) & m
    raise NotImplementedError(f"eval: {op}")


def _eval_array(t: Term, memo: Dict, asn: Dict):
    """Array term -> (default, {idx: val}); walks store chains."""
    writes = []
    cur = t
    while cur.op == "store":
        writes.append((memo[cur.args[1]._id], memo[cur.args[2]._id]))
        cur = cur.args[0]
    if cur.op == "K":
        default, base = memo[cur.args[0]._id], {}
    elif cur.op == "avar":
        default, base = asn.get(cur.args[0], (0, {}))
    elif cur.op == "ite":
        branch = cur.args[1] if memo[cur.args[0]._id] else cur.args[2]
        default, base = _eval_array(branch, memo, asn)
    else:
        raise NotImplementedError(f"array eval: {cur.op}")
    table = dict(base)
    for idx, val in reversed(writes):
        table[idx] = val
    return default, table
