"""THE solver entry point: cached `get_model`.

The port's copy of the JAX package's support/model.py.

Reference parity: mythril/support/model.py:15-48 — every feasibility
check and issue query in the engine funnels through here; results are
memoized (the reference uses an lru_cache of 2**23 over z3 ASTs; here
the key is the tuple of interned term ids, which is exact because
terms are hash-consed), and the per-query timeout is clamped to the
remaining execution time.
"""

from __future__ import annotations

import contextvars
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, Tuple

from mythril_tpu_torch.exceptions import SolverTimeOutException, UnsatError
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.laser.smt import Bool
from mythril_tpu_torch.laser.smt.model import Model
from mythril_tpu_torch.laser.smt.solver import Optimize, sat, unknown, unsat
from mythril_tpu_torch.support.support_args import args

_CACHE_MAX = 2**20
_cache: "OrderedDict[Tuple, Tuple[str, Model]]" = OrderedDict()


#: where a get_model call that names no device races and escapes (None:
#: the card); set for the host walk by `solver_device`
_DEVICE = contextvars.ContextVar("solver_device", default=None)
_UNSET = object()


def clear_cache() -> None:
    _cache.clear()


@contextmanager
def solver_device(device):
    """Run the block's get_model calls that name no device on `device`.
    The host walk's engine and detection modules call get_model as the
    JAX package does, without a device; SymExecWrapper and fire_lasers
    wrap them in their wrapper's device, so `--device cpu` keeps every
    race of the walk on the CPU and the default races on the card."""
    token = _DEVICE.set(device)
    try:
        yield
    finally:
        _DEVICE.reset(token)


def get_model(
    constraints,
    minimize=(),
    maximize=(),
    enforce_execution_time: bool = True,
    solver_timeout: int = None,
    device=_UNSET,
) -> Model:
    """Return a model for `constraints` or raise UnsatError.

    minimize/maximize are BitVec objectives (used by
    analysis/solver.get_transaction_sequence to shrink witnesses).
    `solver_timeout` is in ms (default `args.solver_timeout`). `device`
    is where a race or the --parallel-solving escape searches (None: the
    card; unset: the enclosing `solver_device`, else the card); the memo
    key leaves it out, since a verdict does not depend on it.
    """
    from mythril_tpu_torch.laser.smt.bool import Bool as BoolType

    norm = []
    for c in constraints:
        if isinstance(c, bool):
            from mythril_tpu_torch.laser.smt import symbol_factory

            c = symbol_factory.Bool(c)
        norm.append(c)

    if device is _UNSET:
        device = _DEVICE.get()
    timeout = solver_timeout or args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, time_handler.time_remaining() - 500)
        if timeout <= 0:
            raise SolverTimeOutException("Execution time budget exhausted")

    key = (
        tuple(c.raw._id for c in norm),
        tuple(m.raw._id for m in minimize),
        tuple(m.raw._id for m in maximize),
    )
    hit = _cache.get(key)
    if hit is not None:
        from mythril_tpu_torch.observe.solverstats import ORIGIN_MEMO, record_query

        _cache.move_to_end(key)
        status, model = hit
        # attribution: the memo pre-empted a solve — the table's
        # "memo" row is how many engine queries never reached a solver
        record_query(ORIGIN_MEMO, str(status))
        if status == sat:
            return model
        if status == unsat:
            raise UnsatError("unsat (cached)")
        raise SolverTimeOutException("timeout (cached)")

    s = Optimize(timeout=timeout, device=device)
    for c in norm:
        s.add(c)
    for e in minimize:
        s.minimize(e)
    for e in maximize:
        s.maximize(e)
    from mythril_tpu_torch.observe.querylog import query_context
    from mythril_tpu_torch.support.phase_profile import PhaseProfile

    with PhaseProfile().measure("solve"):
        # flight-recorder origin: a bare get_model solve is a memo
        # miss (engine feasibility checks); module/flip-frontier
        # callers already tagged the context and keep their tag
        with query_context("memo-miss", only_if_root=True):
            result = s.check()
    if result == sat:
        model = s.model()
        _store(key, (sat, model))
        return model
    if result == unsat:
        _store(key, (unsat, None))
        raise UnsatError("unsat")
    # unknown: do NOT cache timeouts permanently under a longer budget —
    # but the reference caches too (lru over identical args); keep parity
    _store(key, (unknown, None))
    raise SolverTimeOutException("solver timeout")


def _store(key, value) -> None:
    _cache[key] = value
    if len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
