"""The term DAG: mythril_tpu's own SMT expression representation.

The reference delegates expression representation to z3's C++ AST
(reference: mythril/laser/smt/expression.py wraps z3.ExprRef). This
image has no z3, and the framework's north star is an on-device
constraint pipeline anyway — so terms are first-class here: immutable,
hash-consed nodes with eager constant folding, designed so a constraint
set can be (a) evaluated concretely in bulk (numpy/jax local search),
(b) bit-blasted to CNF for the native CDCL solver, and (c) pretty-
printed for reports.

Sorts:
  BV(w)        fixed-width bit-vector, value range [0, 2**w)
  Bool
  Array(dw,rw) total map BV(dw) -> BV(rw)

Every node is a `Term` with `op`, `args` (child Terms or Python
ints/strs for leaf payloads), and `sort`. Construction goes through
the smart constructors below, which intern nodes in a global table so
syntactic equality is pointer equality (fast dict keys — the
reference leans on z3 AST hashing the same way for its model cache,
mythril/support/model.py:15).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# sorts
# ---------------------------------------------------------------------------


class Sort:
    __slots__ = ("kind", "width", "range_width")

    def __init__(self, kind: str, width: int = 0, range_width: int = 0):
        self.kind = kind  # "bv" | "bool" | "array"
        self.width = width
        self.range_width = range_width

    def __eq__(self, other):
        return (
            isinstance(other, Sort)
            and self.kind == other.kind
            and self.width == other.width
            and self.range_width == other.range_width
        )

    def __hash__(self):
        return hash((self.kind, self.width, self.range_width))

    def __repr__(self):
        if self.kind == "bv":
            return f"BV({self.width})"
        if self.kind == "bool":
            return "Bool"
        return f"Array({self.width}->{self.range_width})"


BOOL = Sort("bool")
_BV_CACHE: Dict[int, Sort] = {}
_ARR_CACHE: Dict[Tuple[int, int], Sort] = {}


def BV(width: int) -> Sort:
    s = _BV_CACHE.get(width)
    if s is None:
        s = _BV_CACHE[width] = Sort("bv", width)
    return s


def ARRAY(dw: int, rw: int) -> Sort:
    s = _ARR_CACHE.get((dw, rw))
    if s is None:
        s = _ARR_CACHE[(dw, rw)] = Sort("array", dw, rw)
    return s


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

Payload = Union["Term", int, str, Tuple[int, ...]]


class Term:
    __slots__ = ("op", "args", "sort", "_hash", "_id", "__weakref__")

    _next_id = 0

    def __init__(self, op: str, args: Tuple[Payload, ...], sort: Sort):
        self.op = op
        self.args = args
        self.sort = sort
        self._hash = hash((op, args, sort))
        self._id = Term._next_id
        Term._next_id += 1

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        # interning makes pointer equality authoritative
        return self is other

    # -- convenience ------------------------------------------------------
    @property
    def width(self) -> int:
        return self.sort.width

    @property
    def is_const(self) -> bool:
        return self.op in ("const", "true", "false")

    @property
    def value(self) -> Optional[int]:
        if self.op == "const":
            return self.args[0]
        if self.op == "true":
            return 1
        if self.op == "false":
            return 0
        return None

    def __repr__(self):
        return to_str(self, max_depth=6)


# Weak interning: entries die with their Term, so transient
# simplification intermediates are collectible instead of pinning
# memory for the whole analysis run. A key tuple holds strong refs to
# child terms, but the key itself is dropped when its value is
# collected, releasing the children transitively.
_TABLE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _mk(op: str, args: Tuple[Payload, ...], sort: Sort) -> Term:
    key = (op, args, sort)
    t = _TABLE.get(key)
    if t is None:
        t = Term(op, args, sort)
        _TABLE[key] = t
    return t


def table_size() -> int:
    return len(_TABLE)


# ---------------------------------------------------------------------------
# leaf constructors
# ---------------------------------------------------------------------------

TRUE = _mk("true", (), BOOL)
FALSE = _mk("false", (), BOOL)


def bv_const(value: int, width: int) -> Term:
    return _mk("const", (value & ((1 << width) - 1),), BV(width))


def bv_var(name: str, width: int) -> Term:
    return _mk("var", (name,), BV(width))


def bool_const(v: bool) -> Term:
    return TRUE if v else FALSE


def bool_var(name: str) -> Term:
    return _mk("bvar", (name,), BOOL)


def array_var(name: str, dw: int, rw: int) -> Term:
    return _mk("avar", (name,), ARRAY(dw, rw))


def const_array(value: Term, dw: int) -> Term:
    """K(dw, value): the constant array (reference: laser/smt/array.py K)."""
    return _mk("K", (value,), ARRAY(dw, value.width))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mask(w: int) -> int:
    return (1 << w) - 1


def _signed(v: int, w: int) -> int:
    return v - (1 << w) if v >> (w - 1) else v


def is_bv(t: Term) -> bool:
    return t.sort.kind == "bv"


# ---------------------------------------------------------------------------
# bit-vector arithmetic
# ---------------------------------------------------------------------------


def add(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value + b.value, w)
    if a.is_const and a.value == 0:
        return b
    if b.is_const and b.value == 0:
        return a
    # canonical order for commutative ops: const first, then by id
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("add", (a, b), BV(w))


def sub(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value - b.value, w)
    if b.is_const and b.value == 0:
        return a
    if a is b:
        return bv_const(0, w)
    return _mk("sub", (a, b), BV(w))


def mul(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value * b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return bv_const(0, w)
            if x.value == 1:
                return y
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("mul", (a, b), BV(w))


def udiv(a: Term, b: Term) -> Term:
    w = a.width
    if b.is_const:
        if b.value == 0:
            return bv_const(0, w)  # EVM semantics: x / 0 == 0
        if b.value == 1:
            return a
        if a.is_const:
            return bv_const(a.value // b.value, w)
    return _mk("udiv", (a, b), BV(w))


def sdiv(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        if b.value == 0:
            return bv_const(0, w)
        x, y = _signed(a.value, w), _signed(b.value, w)
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        return bv_const(q, w)
    return _mk("sdiv", (a, b), BV(w))


def urem(a: Term, b: Term) -> Term:
    w = a.width
    if b.is_const:
        if b.value == 0:
            return bv_const(0, w)
        if b.value == 1:
            return bv_const(0, w)
        if a.is_const:
            return bv_const(a.value % b.value, w)
    return _mk("urem", (a, b), BV(w))


def srem(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        if b.value == 0:
            return bv_const(0, w)
        x, y = _signed(a.value, w), _signed(b.value, w)
        r = abs(x) % abs(y)
        if x < 0:
            r = -r
        return bv_const(r, w)
    return _mk("srem", (a, b), BV(w))


def bvand(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value & b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return bv_const(0, w)
            if x.value == _mask(w):
                return y
    if a is b:
        return a
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("and", (a, b), BV(w))


def bvor(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value | b.value, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return y
            if x.value == _mask(w):
                return bv_const(_mask(w), w)
    if a is b:
        return a
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("or", (a, b), BV(w))


def bvxor(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        return bv_const(a.value ^ b.value, w)
    if a is b:
        return bv_const(0, w)
    for x, y in ((a, b), (b, a)):
        if x.is_const and x.value == 0:
            return y
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("xor", (a, b), BV(w))


def bvnot(a: Term) -> Term:
    w = a.width
    if a.is_const:
        return bv_const(~a.value, w)
    if a.op == "not":
        return a.args[0]
    return _mk("not", (a,), BV(w))


def shl(a: Term, b: Term) -> Term:
    w = a.width
    if b.is_const:
        if b.value == 0:
            return a
        if b.value >= w:
            return bv_const(0, w)
        if a.is_const:
            return bv_const(a.value << b.value, w)
    return _mk("shl", (a, b), BV(w))


def lshr(a: Term, b: Term) -> Term:
    w = a.width
    if b.is_const:
        if b.value == 0:
            return a
        if b.value >= w:
            return bv_const(0, w)
        if a.is_const:
            return bv_const(a.value >> b.value, w)
    return _mk("lshr", (a, b), BV(w))


def ashr(a: Term, b: Term) -> Term:
    w = a.width
    if a.is_const and b.is_const:
        sh = min(b.value, w)
        return bv_const(_signed(a.value, w) >> sh, w)
    if b.is_const and b.value == 0:
        return a
    return _mk("ashr", (a, b), BV(w))


def concat(a: Term, b: Term) -> Term:
    """a is the high part (z3 Concat convention)."""
    w = a.width + b.width
    if a.is_const and b.is_const:
        return bv_const((a.value << b.width) | b.value, w)
    # Concat(Extract(hi, k, x), Extract(k-1, lo, x)) == Extract(hi, lo, x)
    if (
        a.op == "extract"
        and b.op == "extract"
        and a.args[2] is b.args[2]
        and a.args[1] == b.args[0] + 1
    ):
        return extract(a.args[0], b.args[1], a.args[2])
    return _mk("concat", (a, b), BV(w))


def extract(hi: int, lo: int, a: Term) -> Term:
    w = hi - lo + 1
    if w == a.width:
        return a
    if a.is_const:
        return bv_const(a.value >> lo, w)
    if a.op == "extract":
        # extract(hi,lo, extract(h1,l1,x)) == extract(l1+hi, l1+lo, x)
        return extract(a.args[1] + hi, a.args[1] + lo, a.args[2])
    if a.op == "concat":
        hi_part, lo_part = a.args
        if hi < lo_part.width:
            return extract(hi, lo, lo_part)
        if lo >= lo_part.width:
            return extract(hi - lo_part.width, lo - lo_part.width, hi_part)
    if a.op == "zext":
        src = a.args[0]
        if hi < src.width:
            return extract(hi, lo, src)
        if lo >= src.width:
            return bv_const(0, w)
    return _mk("extract", (hi, lo, a), BV(w))


def zext(a: Term, extra: int) -> Term:
    if extra == 0:
        return a
    w = a.width + extra
    if a.is_const:
        return bv_const(a.value, w)
    return _mk("zext", (a, extra), BV(w))


def sext(a: Term, extra: int) -> Term:
    if extra == 0:
        return a
    w = a.width + extra
    if a.is_const:
        return bv_const(_signed(a.value, a.width), w)
    return _mk("sext", (a, extra), BV(w))


def ite(c: Term, a: Term, b: Term) -> Term:
    if c is TRUE:
        return a
    if c is FALSE:
        return b
    if a is b:
        return a
    if a.sort == BOOL:
        if a is TRUE and b is FALSE:
            return c
        if a is FALSE and b is TRUE:
            return bnot(c)
    return _mk("ite", (c, a, b), a.sort)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------


def eq(a: Term, b: Term) -> Term:
    if a is b:
        return TRUE
    if a.is_const and b.is_const:
        return bool_const(a.value == b.value)
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("eq", (a, b), BOOL)


def ult(a: Term, b: Term) -> Term:
    if a.is_const and b.is_const:
        return bool_const(a.value < b.value)
    if a is b:
        return FALSE
    if b.is_const and b.value == 0:
        return FALSE
    if a.is_const and a.value == _mask(a.width):
        return FALSE
    return _mk("ult", (a, b), BOOL)


def ule(a: Term, b: Term) -> Term:
    if a.is_const and b.is_const:
        return bool_const(a.value <= b.value)
    if a is b:
        return TRUE
    if a.is_const and a.value == 0:
        return TRUE
    if b.is_const and b.value == _mask(b.width):
        return TRUE
    return _mk("ule", (a, b), BOOL)


def slt(a: Term, b: Term) -> Term:
    if a.is_const and b.is_const:
        return bool_const(_signed(a.value, a.width) < _signed(b.value, b.width))
    if a is b:
        return FALSE
    return _mk("slt", (a, b), BOOL)


def sle(a: Term, b: Term) -> Term:
    if a.is_const and b.is_const:
        return bool_const(_signed(a.value, a.width) <= _signed(b.value, b.width))
    if a is b:
        return TRUE
    return _mk("sle", (a, b), BOOL)


# ---------------------------------------------------------------------------
# boolean connectives
# ---------------------------------------------------------------------------


def band(*args: Term) -> Term:
    flat = []
    for t in args:
        if t is FALSE:
            return FALSE
        if t is TRUE:
            continue
        if t.op == "band":
            flat.extend(t.args)
        else:
            flat.append(t)
    seen, uniq = set(), []
    for t in flat:
        if t._id in seen:
            continue
        seen.add(t._id)
        uniq.append(t)
    for t in uniq:
        if t.op == "bnot" and t.args[0]._id in seen:
            return FALSE
    if not uniq:
        return TRUE
    if len(uniq) == 1:
        return uniq[0]
    uniq.sort(key=lambda t: t._id)
    return _mk("band", tuple(uniq), BOOL)


def bor(*args: Term) -> Term:
    flat = []
    for t in args:
        if t is TRUE:
            return TRUE
        if t is FALSE:
            continue
        if t.op == "bor":
            flat.extend(t.args)
        else:
            flat.append(t)
    seen, uniq = set(), []
    for t in flat:
        if t._id in seen:
            continue
        seen.add(t._id)
        uniq.append(t)
    for t in uniq:
        if t.op == "bnot" and t.args[0]._id in seen:
            return TRUE
    if not uniq:
        return FALSE
    if len(uniq) == 1:
        return uniq[0]
    uniq.sort(key=lambda t: t._id)
    return _mk("bor", tuple(uniq), BOOL)


def bnot(a: Term) -> Term:
    if a is TRUE:
        return FALSE
    if a is FALSE:
        return TRUE
    if a.op == "bnot":
        return a.args[0]
    # push negation through comparisons: not(a < b) == b <= a
    if a.op == "ult":
        return ule(a.args[1], a.args[0])
    if a.op == "ule":
        return ult(a.args[1], a.args[0])
    if a.op == "slt":
        return sle(a.args[1], a.args[0])
    if a.op == "sle":
        return slt(a.args[1], a.args[0])
    return _mk("bnot", (a,), BOOL)


def bxor(a: Term, b: Term) -> Term:
    if a.is_const:
        return bnot(b) if a is TRUE else b
    if b.is_const:
        return bnot(a) if b is TRUE else a
    if a is b:
        return FALSE
    if _order(a) > _order(b):
        a, b = b, a
    return _mk("bxor", (a, b), BOOL)


def implies(a: Term, b: Term) -> Term:
    return bor(bnot(a), b)


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------


def select(arr: Term, idx: Term) -> Term:
    rw = arr.sort.range_width
    if arr.op == "K":
        return arr.args[0]
    if arr.op == "store":
        base, i, v = arr.args
        same = eq(i, idx)
        if same is TRUE:
            return v
        if same is FALSE:
            return select(base, idx)
        # symbolic aliasing: keep the select; bit-blaster expands the chain
    return _mk("select", (arr, idx), BV(rw))


def store(arr: Term, idx: Term, val: Term) -> Term:
    # store-over-store on the same (syntactic) index collapses
    if arr.op == "store" and arr.args[1] is idx:
        arr = arr.args[0]
    return _mk("store", (arr, idx, val), arr.sort)


# ---------------------------------------------------------------------------
# uninterpreted functions
# ---------------------------------------------------------------------------


def apply_uf(name: str, ret_width: int, args: Tuple[Term, ...]) -> Term:
    return _mk("uf", (name,) + tuple(args), BV(ret_width))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def _order(t: Term) -> Tuple[int, int]:
    """Sort key: constants first, then stable by creation id."""
    return (0 if t.is_const else 1, t._id)


def children(t: Term):
    """Child terms only (skips int/str payloads)."""
    for a in t.args:
        if isinstance(a, Term):
            yield a


def free_vars(t: Term, out: Optional[dict] = None) -> Dict[str, Term]:
    """name -> leaf term, over bv/bool/array variables and UF apps."""
    if out is None:
        out = {}
    stack = [t]
    seen = set()
    while stack:
        cur = stack.pop()
        if cur._id in seen:
            continue
        seen.add(cur._id)
        if cur.op in ("var", "bvar", "avar"):
            out[cur.args[0]] = cur
        for c in children(cur):
            stack.append(c)
    return out


def dependence_symbols(t: Term) -> set:
    """Names that couple constraints for independence partitioning:
    free variables PLUS uninterpreted-function names — two constraints
    over the same UF must be solved together or functional consistency
    (f(x)=f(y) when x=y) is lost across buckets."""
    out = set()
    stack = [t]
    seen = set()
    while stack:
        cur = stack.pop()
        if cur._id in seen:
            continue
        seen.add(cur._id)
        if cur.op in ("var", "bvar", "avar"):
            out.add(cur.args[0])
        elif cur.op == "uf":
            out.add("uf!" + cur.args[0])
        for c in children(cur):
            stack.append(c)
    return out


def to_str(t: Term, max_depth: int = 20) -> str:
    if max_depth <= 0:
        return "..."
    op = t.op
    if op == "const":
        return f"{t.args[0]:#x}" if t.width > 8 else str(t.args[0])
    if op in ("var", "bvar", "avar"):
        return t.args[0]
    if op == "true":
        return "True"
    if op == "false":
        return "False"
    if op == "extract":
        return f"Extract({t.args[0]},{t.args[1]},{to_str(t.args[2], max_depth-1)})"
    if op == "zext":
        return f"ZeroExt({t.args[1]},{to_str(t.args[0], max_depth-1)})"
    if op == "sext":
        return f"SignExt({t.args[1]},{to_str(t.args[0], max_depth-1)})"
    if op == "uf":
        inner = ",".join(to_str(a, max_depth - 1) for a in t.args[1:])
        return f"{t.args[0]}({inner})"
    parts = ",".join(
        to_str(a, max_depth - 1) if isinstance(a, Term) else str(a) for a in t.args
    )
    return f"{op}({parts})"
