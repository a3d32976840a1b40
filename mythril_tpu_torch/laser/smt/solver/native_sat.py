"""ctypes binding to the native CDCL solver (native/host/cdcl.cpp).

The port's copy of the JAX package's laser/smt/solver/native_sat.py.
The reference's equivalent boundary is the z3 python binding
(reference: mythril/laser/smt/solver/solver.py → z3.Solver.check).
Here the boundary carries only CNF: word-level reasoning stays in
Python, the native side does pure SAT. The library is the port's own,
built by g++ from its sources at first use (`native.build.load_host`);
a failed build raises.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional

from mythril_tpu_torch.native import build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load_host()
        lib.cdcl_new.restype = ctypes.c_void_p
        lib.cdcl_delete.argtypes = [ctypes.c_void_p]
        lib.cdcl_new_var.argtypes = [ctypes.c_void_p]
        lib.cdcl_new_var.restype = ctypes.c_int
        lib.cdcl_add_clause.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.cdcl_add_clause.restype = ctypes.c_int
        lib.cdcl_solve.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.cdcl_solve.restype = ctypes.c_int
        lib.cdcl_value.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cdcl_value.restype = ctypes.c_int
        lib.cdcl_conflicts.argtypes = [ctypes.c_void_p]
        lib.cdcl_conflicts.restype = ctypes.c_int64
        lib.cdcl_ensure_vars.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cdcl_add_clauses_flat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_longlong,
        ]
        lib.cdcl_add_clauses_flat.restype = ctypes.c_int
        lib.cdcl_solve_assuming.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.cdcl_solve_assuming.restype = ctypes.c_int
        lib.cdcl_model_bits.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
        ]
        _lib = lib
    return _lib


SAT, UNSAT, UNKNOWN = 1, -1, 0

_CHUNK = 20_000  # conflicts between wall-clock checks
_SPRINT_CHUNK = 2_500  # finer valve granularity for conflict-budget mode


def solve_flat(
    nvars: int,
    flat_clauses,
    units: List[int],
    timeout_ms: Optional[int] = None,
):
    """Solve a CNF given as one flat 0-separated literal stream (an
    `array('i')` — loaded into the native solver with a single
    zero-copy FFI call) plus per-query unit assertions. Returns
    (status, bits) with bits a bytearray indexed by var-1 on SAT."""
    lib = _load()
    s = lib.cdcl_new()
    try:
        lib.cdcl_ensure_vars(s, nvars)
        n = len(flat_clauses)
        if n:
            if hasattr(flat_clauses, "window"):
                # native blast store: a (pointer, count) view, no copy
                ptr, cnt = flat_clauses.window(0)
                ok = lib.cdcl_add_clauses_flat(s, ptr, cnt)
            else:
                buf = (ctypes.c_int * n).from_buffer(flat_clauses)
                ok = lib.cdcl_add_clauses_flat(s, buf, n)
                del buf  # release the buffer export so the store can grow
            if not ok:
                return UNSAT, None
        if units:
            unit_stream = []
            for u in units:
                unit_stream += [u, 0]
            arr = (ctypes.c_int * len(unit_stream))(*unit_stream)
            if not lib.cdcl_add_clauses_flat(s, arr, len(unit_stream)):
                return UNSAT, None

        deadline = (
            None if timeout_ms is None else time.monotonic() + timeout_ms / 1000.0
        )
        budget = _CHUNK
        while True:
            r = lib.cdcl_solve(s, budget)
            if r == SAT:
                out = (ctypes.c_ubyte * nvars)()
                lib.cdcl_model_bits(s, out, nvars)
                return SAT, bytearray(out)
            if r == UNSAT:
                return UNSAT, None
            if deadline is not None and time.monotonic() >= deadline:
                return UNKNOWN, None
            budget += _CHUNK
    finally:
        lib.cdcl_delete(s)


class SolverSession:
    """A persistent native solver fed clause deltas.

    Pairs with the persistent Blaster: the flat definitional store only
    ever grows, so each query loads `flat[loaded_upto:]` and solves
    under its root literals as assumptions — learned clauses (implied
    by the definitional clauses alone) accumulate across queries.
    """

    def __init__(self):
        self._lib = _load()
        self._s = self._lib.cdcl_new()
        self.loaded_lits = 0
        self.loaded_vars = 0
        self.poisoned = False
        #: a watchdog abandoned this session mid-call: the native
        #: object may still be in use by the zombie thread, so close()
        #: must LEAK it rather than free memory out from under C++
        self.abandoned = False

    def close(self):
        if self._s is not None and not self.abandoned:
            self._lib.cdcl_delete(self._s)
        self._s = None

    def abandon(self):
        """Mark the session wedged: unusable, and never freed (the
        hung native call may still hold the pointer)."""
        self.poisoned = True
        self.abandoned = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def solve(self, nvars: int, flat_clauses, units: List[int],
              timeout_ms: Optional[int] = None,
              conflict_budget: Optional[int] = None):
        """Watchdog-guarded entry: `_solve_inner` runs in a worker
        thread bounded by the call's own wall budget plus a grace
        (support/resilience.py). A chunk that wedges inside the native
        solver — past every between-chunk deadline check — raises
        WatchdogTimeout with the session abandoned; solver.py rebuilds
        the clause session and retries the query once before degrading
        to UNKNOWN. The `solver.cdcl` injection site fires inside the
        guarded region so the fault suite can simulate the wedge."""
        from mythril_tpu_torch.support import resilience

        budget_s = resilience.solver_watchdog_budget_s(timeout_ms)

        def _work():
            resilience.inject("solver.cdcl")
            return self._solve_inner(
                nvars, flat_clauses, units, timeout_ms, conflict_budget
            )

        if budget_s is None:
            return _work()
        try:
            return resilience.call_with_watchdog(
                _work, budget_s, label="native-cdcl"
            )
        except Exception as why:
            from mythril_tpu_torch.exceptions import WatchdogTimeout

            if isinstance(why, WatchdogTimeout):
                self.abandon()
            raise

    def _solve_inner(self, nvars: int, flat_clauses, units: List[int],
                     timeout_ms: Optional[int] = None,
                     conflict_budget: Optional[int] = None):
        """Load the store delta and solve under `units` as assumptions.
        Returns (status, bits) like solve_flat.

        With `conflict_budget` the query gets at most that many CDCL
        conflicts and then returns UNKNOWN — a machine-independent
        bound (the same CNF + session state always produces the same
        verdict), unlike the wall-clock deadline whose outcome shifts
        with load. The sprint pass uses this so that run-to-run report
        byte-stability does not depend on scheduler timing. A
        `timeout_ms` passed alongside still acts as a safety valve
        (checked between conflict chunks): determinism then holds for
        every query the wall budget can cover at all — a query that
        trips the valve would have ended as a marathon timeout anyway."""
        if self.poisoned:
            # a failed definitional load signals an internal blaster bug,
            # never real unsatisfiability: degrade to unknown so paths
            # aren't silently pruned
            return UNKNOWN, None
        lib, s = self._lib, self._s
        if nvars > self.loaded_vars:
            lib.cdcl_ensure_vars(s, nvars)
            self.loaded_vars = nvars
        n = len(flat_clauses)
        if n > self.loaded_lits:
            if hasattr(flat_clauses, "window"):
                # native blast store: load the delta straight out of the
                # C++ vector (pointer fetched per call — it reallocates)
                ptr, cnt = flat_clauses.window(self.loaded_lits)
                ok = lib.cdcl_add_clauses_flat(s, ptr, cnt)
            else:
                delta = flat_clauses[self.loaded_lits:]
                buf = (ctypes.c_int * len(delta)).from_buffer(delta)
                ok = lib.cdcl_add_clauses_flat(s, buf, len(delta))
                del buf
            self.loaded_lits = n
            if not ok:
                self.poisoned = True  # definitional store unsat: broken
                return UNKNOWN, None

        arr = (ctypes.c_int * len(units))(*units)
        deadline = (
            None if timeout_ms is None else time.monotonic() + timeout_ms / 1000.0
        )
        end_conflicts = (
            None
            if conflict_budget is None
            else lib.cdcl_conflicts(s) + conflict_budget
        )
        chunk = _SPRINT_CHUNK if conflict_budget is not None else _CHUNK
        while True:
            budget = lib.cdcl_conflicts(s) + chunk
            if end_conflicts is not None:
                budget = min(budget, end_conflicts)
            r = lib.cdcl_solve_assuming(s, budget, arr, len(units))
            if r == SAT:
                out = (ctypes.c_ubyte * nvars)()
                lib.cdcl_model_bits(s, out, nvars)
                return SAT, bytearray(out)
            if r == UNSAT:
                return UNSAT, None
            if end_conflicts is not None and lib.cdcl_conflicts(s) >= end_conflicts:
                return UNKNOWN, None
            if deadline is not None and time.monotonic() >= deadline:
                return UNKNOWN, None
