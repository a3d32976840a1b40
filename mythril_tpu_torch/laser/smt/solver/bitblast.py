"""Bit-blasting: word-level terms -> CNF for the native CDCL solver.

The port's copy of the JAX package's laser/smt/solver/bitblast.py. The
reference never does this itself — z3 bit-blasts internally. Here it is
explicit: every BV term becomes a list of SAT literals (LSB first),
every Bool term a single literal, gates are Tseitin-encoded with
structural sharing via a per-blast cache.

Literal encoding is DIMACS: ±(var). SAT var 1 is reserved as the
constant TRUE (unit clause [1]), so constants are literals 1 / -1 and
every gate can short-circuit on them without special cases downstream.

Expects *lowered* terms: no arrays, no UFs, no sdiv/srem (see
preprocess.py which rewrites those to udiv/urem + ite).

Two implementations share this contract:

- `PyBlaster` — the pure-Python encoder, the plain version (the
  reference semantics);
- `NativeBlaster` — the term DAG walk stays here, but every word-level
  circuit (adder/multiplier/divider/comparator/shifter) is ONE FFI
  call into native/host/blast.cpp, which owns the variable counter,
  the gate cache, and the flat clause store.

The native encoder produces a bit-for-bit identical clause stream
(same var numbering, same clause order) — identical CNF means
identical CDCL behavior, models and witnesses. tests/test_torch_blast.py
holds the two, and the JAX package's native blaster, to stream equality.
The solver's session uses `NativeBlaster`, built from the port's sources
at first use (`native.build.load_host`; a failed build raises). The JAX
package's `Blaster()` factory and its MYTHRIL_TPU_NATIVE_BLAST=0 switch
to PyBlaster are not kept: nothing in the port selects PyBlaster, which
the tests build by name.
"""

from __future__ import annotations

import ctypes
from array import array
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.terms import Term
from mythril_tpu_torch.native import build

TRUE_LIT = 1
FALSE_LIT = -1


class PyBlaster:
    def __init__(self):
        self.nvars = 1  # var 1 = constant TRUE
        # definitional clause store, flat 0-separated DIMACS stream —
        # one bulk FFI call loads it into the native solver
        self.flat = array("i", [TRUE_LIT, 0])
        self.bv_cache: Dict[int, List[int]] = {}
        self.bool_cache: Dict[int, int] = {}
        self.gate_cache: Dict[Tuple, int] = {}
        self.var_bits: Dict[Tuple[str, int], List[int]] = {}  # (name, width) -> sat vars
        self.bool_vars: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def new_var(self) -> int:
        self.nvars += 1
        return self.nvars

    def _emit(self, *lits: int) -> None:
        """Append one clause of non-constant literals to the store."""
        self.flat.extend(lits)
        self.flat.append(0)

    def add(self, *lits: int) -> None:
        # drop clauses satisfied by the constant; strip false constant lits
        out = []
        for l in lits:
            if l == TRUE_LIT:
                return
            if l == FALSE_LIT:
                continue
            out.append(l)
        self.flat.extend(out)
        self.flat.append(0)

    # ---- gates ---------------------------------------------------------
    def g_and(self, *ins: int) -> int:
        lits = []
        for l in ins:
            if l == FALSE_LIT:
                return FALSE_LIT
            if l == TRUE_LIT:
                continue
            lits.append(l)
        if not lits:
            return TRUE_LIT
        lits = sorted(set(lits))
        if len(lits) == 1:
            return lits[0]
        for l in lits:
            if -l in lits:
                return FALSE_LIT
        key = ("and",) + tuple(lits)
        o = self.gate_cache.get(key)
        if o is None:
            o = self.new_var()
            for l in lits:
                self._emit(-o, l)
            self._emit(o, *[-l for l in lits])
            self.gate_cache[key] = o
        return o

    def g_or(self, *ins: int) -> int:
        return -self.g_and(*[-l for l in ins])

    def g_xor(self, a: int, b: int) -> int:
        if a == FALSE_LIT:
            return b
        if b == FALSE_LIT:
            return a
        if a == TRUE_LIT:
            return -b
        if b == TRUE_LIT:
            return -a
        if a == b:
            return FALSE_LIT
        if a == -b:
            return TRUE_LIT
        if abs(b) < abs(a):
            a, b = b, a
        key = ("xor", a, b)
        o = self.gate_cache.get(key)
        if o is None:
            o = self.new_var()
            self._emit(-o, a, b); self._emit(-o, -a, -b); self._emit(o, -a, b); self._emit(o, a, -b)
            self.gate_cache[key] = o
        return o

    def g_ite(self, c: int, a: int, b: int) -> int:
        """c ? a : b"""
        if c == TRUE_LIT:
            return a
        if c == FALSE_LIT:
            return b
        if a == b:
            return a
        if a == TRUE_LIT and b == FALSE_LIT:
            return c
        if a == FALSE_LIT and b == TRUE_LIT:
            return -c
        if a == TRUE_LIT:  # o = c | b
            return self.g_or(c, b)
        if a == FALSE_LIT:  # o = ~c & b
            return self.g_and(-c, b)
        if b == TRUE_LIT:  # o = ~c | a
            return self.g_or(-c, a)
        if b == FALSE_LIT:  # o = c & a
            return self.g_and(c, a)
        key = ("ite", c, a, b)
        o = self.gate_cache.get(key)
        if o is None:
            o = self.new_var()
            self._emit(-o, -c, a); self._emit(o, -c, -a); self._emit(-o, c, b); self._emit(o, c, -b)
            self.gate_cache[key] = o
        return o

    def g_maj(self, a: int, b: int, c: int) -> int:
        """Majority (full-adder carry)."""
        consts = [l for l in (a, b, c) if l in (TRUE_LIT, FALSE_LIT)]
        if len(consts) >= 2:
            if consts.count(TRUE_LIT) >= 2:
                return TRUE_LIT
            if consts.count(FALSE_LIT) >= 2:
                return FALSE_LIT
            # one TRUE and one FALSE constant cancel: the majority is
            # whatever the remaining input is
            return next(l for l in (a, b, c) if l not in (TRUE_LIT, FALSE_LIT))
        if a == TRUE_LIT:
            return self.g_or(b, c)
        if a == FALSE_LIT:
            return self.g_and(b, c)
        if b == TRUE_LIT:
            return self.g_or(a, c)
        if b == FALSE_LIT:
            return self.g_and(a, c)
        if c == TRUE_LIT:
            return self.g_or(a, b)
        if c == FALSE_LIT:
            return self.g_and(a, b)
        key = ("maj",) + tuple(sorted((a, b, c), key=abs))
        o = self.gate_cache.get(key)
        if o is None:
            o = self.new_var()
            for cl in ((-o, a, b), (-o, a, c), (-o, b, c),
                       (o, -a, -b), (o, -a, -c), (o, -b, -c)):
                self._emit(*cl)
            self.gate_cache[key] = o
        return o

    # ---- word-level building blocks -----------------------------------
    def const_bits(self, value: int, width: int) -> List[int]:
        return [TRUE_LIT if (value >> i) & 1 else FALSE_LIT for i in range(width)]

    def adder(self, a: List[int], b: List[int], cin: int = FALSE_LIT) -> Tuple[List[int], int]:
        out = []
        c = cin
        for i in range(len(a)):
            s = self.g_xor(self.g_xor(a[i], b[i]), c)
            c = self.g_maj(a[i], b[i], c)
            out.append(s)
        return out, c

    def negate(self, a: List[int]) -> List[int]:
        out, _ = self.adder([-l for l in a], self.const_bits(1, len(a)))
        return out

    def mul_bits(self, a: List[int], b: List[int], out_width: int) -> List[int]:
        """Shift-add multiplier producing out_width low bits."""
        acc = self.const_bits(0, out_width)
        for i in range(min(len(b), out_width)):
            if b[i] == FALSE_LIT:
                continue
            row = [FALSE_LIT] * i + [
                self.g_and(b[i], a[j]) for j in range(min(len(a), out_width - i))
            ]
            row += [FALSE_LIT] * (out_width - len(row))
            acc, _ = self.adder(acc, row)
        return acc

    def eq_bits(self, a: List[int], b: List[int]) -> int:
        return self.g_and(*[-self.g_xor(x, y) for x, y in zip(a, b)])

    def ult_bits(self, a: List[int], b: List[int]) -> int:
        # LSB-up ripple: lt = (~a&b) | (a==b & lt_prev)
        lt = FALSE_LIT
        for x, y in zip(a, b):
            lt = self.g_ite(self.g_xor(x, y), self.g_and(-x, y), lt)
        return lt

    def shift_bits(self, a: List[int], sh: List[int], kind: str) -> List[int]:
        """Barrel shifter; kind in {shl, lshr, ashr}."""
        w = len(a)
        nstages = max(1, (w - 1).bit_length())
        fill = a[-1] if kind == "ashr" else FALSE_LIT
        cur = list(a)
        for s in range(nstages):
            k = 1 << s
            bit = sh[s] if s < len(sh) else FALSE_LIT
            if bit == FALSE_LIT:
                continue
            shifted = [FALSE_LIT] * w
            for i in range(w):
                if kind == "shl":
                    shifted[i] = cur[i - k] if i - k >= 0 else FALSE_LIT
                else:
                    shifted[i] = cur[i + k] if i + k < w else fill
            cur = [self.g_ite(bit, shifted[i], cur[i]) for i in range(w)]
        # any set bit at position >= nstages means shift >= w
        big = self.g_or(*sh[nstages:]) if len(sh) > nstages else FALSE_LIT
        if big != FALSE_LIT:
            cur = [self.g_ite(big, fill, cur[i]) for i in range(w)]
        return cur

    # ------------------------------------------------------------------
    def blast_bv(self, t: Term) -> List[int]:
        cached = self.bv_cache.get(t._id)
        if cached is not None:
            return cached
        bits = self._blast_bv(t)
        assert len(bits) == t.width, f"{t.op}: {len(bits)} != {t.width}"
        self.bv_cache[t._id] = bits
        return bits

    def _blast_bv(self, t: Term) -> List[int]:
        op = t.op
        w = t.width
        if op == "const":
            return self.const_bits(t.args[0], w)
        if op == "var":
            # keyed by (name, width): a persistent session may see the
            # same name at several widths across queries
            key = (t.args[0], w)
            bits = self.var_bits.get(key)
            if bits is None:
                bits = [self.new_var() for _ in range(w)]
                self.var_bits[key] = bits
            return bits
        if op in ("add", "sub", "mul", "udiv", "urem", "and", "or", "xor",
                  "shl", "lshr", "ashr"):
            a = self.blast_bv(t.args[0])
            b = self.blast_bv(t.args[1])
            if op == "add":
                return self.adder(a, b)[0]
            if op == "sub":
                return self.adder(a, [-l for l in b], TRUE_LIT)[0]
            if op == "mul":
                return self.mul_bits(a, b, w)
            if op in ("udiv", "urem"):
                return self._divmod(t, a, b, op)
            if op == "and":
                return [self.g_and(x, y) for x, y in zip(a, b)]
            if op == "or":
                return [self.g_or(x, y) for x, y in zip(a, b)]
            if op == "xor":
                return [self.g_xor(x, y) for x, y in zip(a, b)]
            return self.shift_bits(a, b, op)
        if op == "not":
            return [-l for l in self.blast_bv(t.args[0])]
        if op == "concat":
            hi, lo = t.args
            return self.blast_bv(lo) + self.blast_bv(hi)
        if op == "extract":
            hi, lo, src = t.args
            return self.blast_bv(src)[lo : hi + 1]
        if op == "zext":
            return self.blast_bv(t.args[0]) + self.const_bits(0, t.args[1])
        if op == "sext":
            bits = self.blast_bv(t.args[0])
            return bits + [bits[-1]] * t.args[1]
        if op == "ite":
            c = self.blast_bool(t.args[0])
            a = self.blast_bv(t.args[1])
            b = self.blast_bv(t.args[2])
            return [self.g_ite(c, x, y) for x, y in zip(a, b)]
        raise NotImplementedError(f"blast bv: {op}")

    def _divmod(self, t: Term, a: List[int], b: List[int], op: str) -> List[int]:
        """q,r fresh with the division relation (EVM: x/0 = x%0 = 0)."""
        w = t.width
        key = ("divmod", t.args[0]._id, t.args[1]._id)
        qr = self.gate_cache.get(key)
        if qr is None:
            q = [self.new_var() for _ in range(w)]
            r = [self.new_var() for _ in range(w)]
            b_zero = self.eq_bits(b, self.const_bits(0, w))
            # b == 0 -> q == 0 and r == 0
            for l in q + r:
                self.add(-b_zero, -l)
            # b != 0 -> a == q*b + r (in 2w bits, exact) and r < b
            prod = self.mul_bits(q + self.const_bits(0, w), b + self.const_bits(0, w), 2 * w)
            total, carry = self.adder(prod, r + self.const_bits(0, w))
            a_ext = a + self.const_bits(0, w)
            rel = self.eq_bits(total, a_ext)
            r_lt_b = self.ult_bits(r, b)
            self.add(b_zero, rel)
            self.add(b_zero, r_lt_b)
            qr = (q, r)
            self.gate_cache[key] = qr
        return qr[0] if op == "udiv" else qr[1]

    # ------------------------------------------------------------------
    def blast_bool(self, t: Term) -> int:
        cached = self.bool_cache.get(t._id)
        if cached is not None:
            return cached
        lit = self._blast_bool(t)
        self.bool_cache[t._id] = lit
        return lit

    def _blast_bool(self, t: Term) -> int:
        op = t.op
        if op == "true":
            return TRUE_LIT
        if op == "false":
            return FALSE_LIT
        if op == "bvar":
            name = t.args[0]
            v = self.bool_vars.get(name)
            if v is None:
                v = self.bool_vars[name] = self.new_var()
            return v
        if op == "band":
            return self.g_and(*[self.blast_bool(a) for a in t.args])
        if op == "bor":
            return self.g_or(*[self.blast_bool(a) for a in t.args])
        if op == "bnot":
            return -self.blast_bool(t.args[0])
        if op == "bxor":
            return self.g_xor(self.blast_bool(t.args[0]), self.blast_bool(t.args[1]))
        if op == "ite":  # bool-sorted ite
            return self.g_ite(
                self.blast_bool(t.args[0]),
                self.blast_bool(t.args[1]),
                self.blast_bool(t.args[2]),
            )
        if op in ("eq", "ult", "ule", "slt", "sle"):
            a = self.blast_bv(t.args[0])
            b = self.blast_bv(t.args[1])
            if op == "eq":
                return self.eq_bits(a, b)
            if op == "ult":
                return self.ult_bits(a, b)
            if op == "ule":
                return -self.ult_bits(b, a)
            # signed: flip MSBs and compare unsigned
            af = a[:-1] + [-a[-1]]
            bf = b[:-1] + [-b[-1]]
            if op == "slt":
                return self.ult_bits(af, bf)
            return -self.ult_bits(bf, af)
        raise NotImplementedError(f"blast bool: {op}")


# ---------------------------------------------------------------------------
# native-backed implementation
# ---------------------------------------------------------------------------

_blib = None


def _load_blast_lib():
    """The host library with the blaster's entries declared (built at
    first use; raises where it cannot be built or loaded)."""
    global _blib
    if _blib is None:
        lib = build.load_host()
        P = ctypes.POINTER(ctypes.c_int32)
        lib.bl_new.restype = ctypes.c_void_p
        lib.bl_free.argtypes = [ctypes.c_void_p]
        lib.bl_nvars.argtypes = [ctypes.c_void_p]
        lib.bl_nvars.restype = ctypes.c_int32
        lib.bl_flat_len.argtypes = [ctypes.c_void_p]
        lib.bl_flat_len.restype = ctypes.c_longlong
        lib.bl_flat_ptr.argtypes = [ctypes.c_void_p]
        lib.bl_flat_ptr.restype = P
        lib.bl_new_vars.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.bl_new_vars.restype = ctypes.c_int32
        lib.bl_add_clause.argtypes = [ctypes.c_void_p, P, ctypes.c_int32]
        for name in ("bl_and", "bl_or"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, P, ctypes.c_int32]
            fn.restype = ctypes.c_int32
        lib.bl_xor.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        lib.bl_xor.restype = ctypes.c_int32
        for name in ("bl_ite", "bl_maj"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
            ]
            fn.restype = ctypes.c_int32
        lib.bl_adder.argtypes = [
            ctypes.c_void_p, P, P, ctypes.c_int32, ctypes.c_int32, P,
        ]
        lib.bl_adder.restype = ctypes.c_int32
        lib.bl_mul.argtypes = [
            ctypes.c_void_p, P, ctypes.c_int32, P, ctypes.c_int32,
            ctypes.c_int32, P,
        ]
        for name in ("bl_eq", "bl_ult"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, P, P, ctypes.c_int32]
            fn.restype = ctypes.c_int32
        lib.bl_shift.argtypes = [
            ctypes.c_void_p, P, ctypes.c_int32, P, ctypes.c_int32,
            ctypes.c_int32, P,
        ]
        lib.bl_divmod.argtypes = [ctypes.c_void_p, P, P, ctypes.c_int32, P, P]
        lib.bl_ite_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, P, P, ctypes.c_int32, P,
        ]
        for name in ("bl_and_bits", "bl_or_bits", "bl_xor_bits"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, P, P,
                                           ctypes.c_int32, P]
        _blib = lib
    return _blib


def _ia(bits: List[int]):
    return (ctypes.c_int32 * len(bits))(*bits)


class NativeFlat:
    """View over the native blaster's clause store. Quacks enough like
    `array('i')` for the solver sessions: `len()` in literals, and a
    zero-copy (pointer, count) window for the CDCL bulk-load FFI."""

    def __init__(self, blaster: "NativeBlaster"):
        self._bl = blaster

    def __len__(self) -> int:
        return int(self._bl._lib.bl_flat_len(self._bl._h))

    def window(self, offset: int = 0):
        """(POINTER(c_int), count) over flat[offset:]. The pointer is
        fetched per call — the store reallocates as it grows."""
        total = len(self)
        base = self._bl._lib.bl_flat_ptr(self._bl._h)
        ptr = ctypes.cast(
            ctypes.addressof(base.contents) + 4 * offset,
            ctypes.POINTER(ctypes.c_int),
        )
        return ptr, total - offset


class NativeBlaster:
    """Term walk in Python, circuits in C++ (one FFI call per term)."""

    def __init__(self):
        lib = _load_blast_lib()
        self._lib = lib
        self._h = lib.bl_new()
        self.flat = NativeFlat(self)
        self.bv_cache: Dict[int, List[int]] = {}
        self.bool_cache: Dict[int, int] = {}
        self.gate_cache: Dict[Tuple, Tuple] = {}  # divmod (q, r) by term ids
        self.var_bits: Dict[Tuple[str, int], List[int]] = {}
        self.bool_vars: Dict[str, int] = {}

    def __del__(self):
        try:
            if self._h is not None:
                self._lib.bl_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def nvars(self) -> int:
        return int(self._lib.bl_nvars(self._h))

    def new_var(self) -> int:
        return int(self._lib.bl_new_vars(self._h, 1))

    def add(self, *lits: int) -> None:
        self._lib.bl_add_clause(self._h, _ia(list(lits)), len(lits))

    # ---- scalar gates (term-level bool ops) --------------------------
    def g_and(self, *ins: int) -> int:
        return int(self._lib.bl_and(self._h, _ia(list(ins)), len(ins)))

    def g_or(self, *ins: int) -> int:
        return int(self._lib.bl_or(self._h, _ia(list(ins)), len(ins)))

    def g_xor(self, a: int, b: int) -> int:
        return int(self._lib.bl_xor(self._h, a, b))

    def g_ite(self, c: int, a: int, b: int) -> int:
        return int(self._lib.bl_ite(self._h, c, a, b))

    def g_maj(self, a: int, b: int, c: int) -> int:
        return int(self._lib.bl_maj(self._h, a, b, c))

    # ---- word helpers ------------------------------------------------
    def const_bits(self, value: int, width: int) -> List[int]:
        return [TRUE_LIT if (value >> i) & 1 else FALSE_LIT for i in range(width)]

    def adder(self, a: List[int], b: List[int], cin: int = FALSE_LIT) -> Tuple[List[int], int]:
        w = len(a)
        out = (ctypes.c_int32 * w)()
        carry = self._lib.bl_adder(self._h, _ia(a), _ia(b), w, cin, out)
        return list(out), int(carry)

    def negate(self, a: List[int]) -> List[int]:
        out, _ = self.adder([-l for l in a], self.const_bits(1, len(a)))
        return out

    def mul_bits(self, a: List[int], b: List[int], out_width: int) -> List[int]:
        out = (ctypes.c_int32 * out_width)()
        self._lib.bl_mul(self._h, _ia(a), len(a), _ia(b), len(b), out_width, out)
        return list(out)

    def eq_bits(self, a: List[int], b: List[int]) -> int:
        w = min(len(a), len(b))
        return int(self._lib.bl_eq(self._h, _ia(a), _ia(b), w))

    def ult_bits(self, a: List[int], b: List[int]) -> int:
        w = min(len(a), len(b))
        return int(self._lib.bl_ult(self._h, _ia(a), _ia(b), w))

    def shift_bits(self, a: List[int], sh: List[int], kind: str) -> List[int]:
        w = len(a)
        out = (ctypes.c_int32 * w)()
        self._lib.bl_shift(
            self._h, _ia(a), w, _ia(sh), len(sh),
            {"shl": 0, "lshr": 1, "ashr": 2}[kind], out)
        return list(out)

    # ---- term walk (mirrors PyBlaster exactly) -----------------------
    def blast_bv(self, t: Term) -> List[int]:
        cached = self.bv_cache.get(t._id)
        if cached is not None:
            return cached
        bits = self._blast_bv(t)
        assert len(bits) == t.width, f"{t.op}: {len(bits)} != {t.width}"
        self.bv_cache[t._id] = bits
        return bits

    def _blast_bv(self, t: Term) -> List[int]:
        op = t.op
        w = t.width
        lib, h = self._lib, self._h
        if op == "const":
            return self.const_bits(t.args[0], w)
        if op == "var":
            key = (t.args[0], w)
            bits = self.var_bits.get(key)
            if bits is None:
                first = int(lib.bl_new_vars(h, w))
                bits = list(range(first, first + w))
                self.var_bits[key] = bits
            return bits
        if op in ("add", "sub", "mul", "udiv", "urem", "and", "or", "xor",
                  "shl", "lshr", "ashr"):
            a = self.blast_bv(t.args[0])
            b = self.blast_bv(t.args[1])
            if op == "add":
                return self.adder(a, b)[0]
            if op == "sub":
                return self.adder(a, [-l for l in b], TRUE_LIT)[0]
            if op == "mul":
                return self.mul_bits(a, b, w)
            if op in ("udiv", "urem"):
                key = ("divmod", t.args[0]._id, t.args[1]._id)
                qr = self.gate_cache.get(key)
                if qr is None:
                    q = (ctypes.c_int32 * w)()
                    r = (ctypes.c_int32 * w)()
                    lib.bl_divmod(h, _ia(a), _ia(b), w, q, r)
                    qr = (list(q), list(r))
                    self.gate_cache[key] = qr
                return qr[0] if op == "udiv" else qr[1]
            if op in ("and", "or", "xor"):
                out = (ctypes.c_int32 * w)()
                fn = {"and": lib.bl_and_bits, "or": lib.bl_or_bits,
                      "xor": lib.bl_xor_bits}[op]
                fn(h, _ia(a), _ia(b), w, out)
                return list(out)
            return self.shift_bits(a, b, op)
        if op == "not":
            return [-l for l in self.blast_bv(t.args[0])]
        if op == "concat":
            hi, lo = t.args
            return self.blast_bv(lo) + self.blast_bv(hi)
        if op == "extract":
            hi, lo, src = t.args
            return self.blast_bv(src)[lo : hi + 1]
        if op == "zext":
            return self.blast_bv(t.args[0]) + self.const_bits(0, t.args[1])
        if op == "sext":
            bits = self.blast_bv(t.args[0])
            return bits + [bits[-1]] * t.args[1]
        if op == "ite":
            c = self.blast_bool(t.args[0])
            a = self.blast_bv(t.args[1])
            b = self.blast_bv(t.args[2])
            out = (ctypes.c_int32 * w)()
            lib.bl_ite_bits(h, c, _ia(a), _ia(b), w, out)
            return list(out)
        raise NotImplementedError(f"blast bv: {op}")

    def blast_bool(self, t: Term) -> int:
        cached = self.bool_cache.get(t._id)
        if cached is not None:
            return cached
        lit = self._blast_bool(t)
        self.bool_cache[t._id] = lit
        return lit

    def _blast_bool(self, t: Term) -> int:
        op = t.op
        if op == "true":
            return TRUE_LIT
        if op == "false":
            return FALSE_LIT
        if op == "bvar":
            name = t.args[0]
            v = self.bool_vars.get(name)
            if v is None:
                v = self.bool_vars[name] = self.new_var()
            return v
        if op == "band":
            return self.g_and(*[self.blast_bool(a) for a in t.args])
        if op == "bor":
            return self.g_or(*[self.blast_bool(a) for a in t.args])
        if op == "bnot":
            return -self.blast_bool(t.args[0])
        if op == "bxor":
            return self.g_xor(self.blast_bool(t.args[0]), self.blast_bool(t.args[1]))
        if op == "ite":
            return self.g_ite(
                self.blast_bool(t.args[0]),
                self.blast_bool(t.args[1]),
                self.blast_bool(t.args[2]),
            )
        if op in ("eq", "ult", "ule", "slt", "sle"):
            a = self.blast_bv(t.args[0])
            b = self.blast_bv(t.args[1])
            if op == "eq":
                return self.eq_bits(a, b)
            if op == "ult":
                return self.ult_bits(a, b)
            if op == "ule":
                return -self.ult_bits(b, a)
            af = a[:-1] + [-a[-1]]
            bf = b[:-1] + [-b[-1]]
            if op == "slt":
                return self.ult_bits(af, bf)
            return -self.ult_bits(bf, af)
        raise NotImplementedError(f"blast bool: {op}")

