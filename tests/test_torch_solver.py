"""The port's host solver stack against the JAX package's.

`mythril_tpu_torch.laser.smt.solver` (lower, the bit-blaster, the native
CDCL over the port's own g++ build, `check_terms`, `Solver`, `Optimize`,
`IndependenceSolver`) and `support/model.py:get_model` run here on the
CPU beside the JAX package's on the same queries, built in the same order
in both term layers (each query's variables are fresh, so both packages
create its terms in the same order). Under `deterministic_solving` a
verdict and its model are a pure function of the query and the solver
session's history, so with both sessions reset before each case:

- every case of tests/laser/smt/test_solver.py (arrays, store/select,
  ite, the EVM shapes, random systems, the memo cache and unsat,
  `IndependenceSolver`) gives equal verdicts and equal models (every
  user variable's value and every array's read table);
- `Optimize` gives equal objective values, minimizing and maximizing;
- `_race_cone` picks the same indices;
- the sprint's and the deterministic marathon's budgets are those of
  tests/laser/smt/test_determinism.py:91, call for call.

The race: with the CDCL stubbed to UNKNOWN, `check_terms(...,
device="cpu")` races the plain portfolio (`portfolio.device_check` on
CPU tensors), and its witness counts only after the soundness gate; a
wrong witness is refused; a `device_check` that raises is counted as a
race error and recorded in the DegradationLog while the CDCL decides.

chip_smoke.py's solver phase holds the card's verdicts to the JAX
package's `check_terms` on the same corpus (chip_smoke.solver_corpus:
the solving queries, the EVM shapes, generation 0's flip queries of the
JAX wave, and the --parallel-solving escape's query), pinned in
tests/test_torch_solver_chip_pinned.json by

    PYTHONPATH=. python tests/test_torch_solver.py --pin-chip
"""

import itertools
import random
import time
from types import SimpleNamespace

import pytest
import torch

import mythril_tpu.laser.smt as jax_smt
import mythril_tpu_torch.laser.smt as port_smt
from mythril_tpu import exceptions as jax_exceptions
from mythril_tpu.laser.smt.solver import native_sat as jax_native
from mythril_tpu.laser.smt.solver import solver as jax_solver
from mythril_tpu.support import model as jax_model
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch import exceptions as port_exceptions
from mythril_tpu_torch.laser.smt.solver import native_sat as port_native
from mythril_tpu_torch.laser.smt.solver import portfolio as port_portfolio
from mythril_tpu_torch.laser.smt.solver import solver as port_solver
from mythril_tpu_torch.laser.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.resilience import DegradationLog
from mythril_tpu_torch.support.support_args import args as port_args

torch.set_num_threads(1)

_FRESH = itertools.count()

PACKAGES = {
    "port": SimpleNamespace(smt=port_smt, solver=port_solver, model=port_model,
                            native=port_native, exc=port_exceptions, args=port_args),
    "jax": SimpleNamespace(smt=jax_smt, solver=jax_solver, model=jax_model,
                           native=jax_native, exc=jax_exceptions, args=jax_args),
}


@pytest.fixture
def deterministic(monkeypatch):
    """Both packages in reproducible mode with fresh solver sessions and
    memo caches; the port's race off (deterministic mode forgoes it)."""
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.args, "deterministic_solving", True)
        pkg.solver.reset_blast_session()
        pkg.model.clear_cache()
    yield
    for pkg in PACKAGES.values():
        pkg.solver.reset_blast_session()


def run_both(case):
    """case(pkg, tag) -> JSON-able result, for each package with the same
    fresh tag."""
    tag = f"ts{next(_FRESH)}"
    return {name: case(pkg, tag) for name, pkg in PACKAGES.items()}


def model_of(status, solver, names):
    """(status, {name: value}) with arrays' tables as sorted items."""
    if status != "sat":
        return [status, None]
    asn = solver.model().assignment
    out = {}
    for n in names:
        v = asn.get(n)
        out[n] = [v[0], sorted(v[1].items())] if isinstance(v, tuple) else v
    return [status, out]


def check(pkg, names, *constraints, timeout=15000):
    s = pkg.smt.Solver(timeout=timeout)
    s.add(*constraints)
    return model_of(s.check(), s, names)


# ---------------------------------------------------------------------------
# the cases of tests/laser/smt/test_solver.py, on either package
# ---------------------------------------------------------------------------


def case_trivial(pkg, tag):
    sf = pkg.smt.symbol_factory
    x = sf.BitVecSym(f"{tag}x", 256)
    return [check(pkg, [f"{tag}x"], x == 5), check(pkg, [], x == 5, x == 6),
            check(pkg, [], sf.Bool(False)), check(pkg, [])]


def case_model_values(pkg, tag):
    sf = pkg.smt.symbol_factory
    x, y = sf.BitVecSym(f"{tag}x", 256), sf.BitVecSym(f"{tag}y", 256)
    return check(pkg, [f"{tag}x", f"{tag}y"], x == 5, y == x + 10)


def case_inequality_chain(pkg, tag):
    S = pkg.smt
    x = S.symbol_factory.BitVecSym(f"{tag}x", 16)
    return [check(pkg, [f"{tag}x"], S.UGT(x, 100), S.ULT(x, 103), x != 101),
            check(pkg, [], S.UGT(x, 100), S.ULT(x, 101))]


def case_addition_overflow(pkg, tag):
    S = pkg.smt
    a, b = S.symbol_factory.BitVecSym(f"{tag}a", 8), S.symbol_factory.BitVecSym(f"{tag}b", 8)
    return check(pkg, [f"{tag}a", f"{tag}b"], S.ULT(a + b, a), S.UGT(b, 0))


def case_evm_overflow_256(pkg, tag):
    S = pkg.smt
    a, b = S.symbol_factory.BitVecSym(f"{tag}a", 256), S.symbol_factory.BitVecSym(f"{tag}b", 256)
    return check(pkg, [f"{tag}a", f"{tag}b"], S.ULT(a + b, a), S.ULT(b, 2**200))


def case_mul_relation(pkg, tag):
    S = pkg.smt
    a, b = S.symbol_factory.BitVecSym(f"{tag}a", 16), S.symbol_factory.BitVecSym(f"{tag}b", 16)
    return check(pkg, [f"{tag}a", f"{tag}b"], a * b == 77, S.UGT(a, 1), S.UGT(b, 1))


def case_division(pkg, tag):
    sf = pkg.smt.symbol_factory
    a = sf.BitVecSym(f"{tag}a", 16)
    return check(pkg, [f"{tag}a"], a / sf.BitVecVal(3, 16) == sf.BitVecVal(5, 16), a % 3 == 1)


def case_signed_compare(pkg, tag):
    x = pkg.smt.symbol_factory.BitVecSym(f"{tag}x", 8)
    return check(pkg, [f"{tag}x"], x < 0, x > -5)


def case_selector(pkg, tag):
    S = pkg.smt
    data = S.symbol_factory.BitVecSym(f"{tag}cd", 256)
    sel = S.Extract(255, 224, data)
    return check(pkg, [f"{tag}cd"], sel == S.symbol_factory.BitVecVal(0xDEADBEEF, 32))


def case_arrays(pkg, tag):
    S = pkg.smt
    storage = S.Array(f"{tag}st", 256, 256)
    i, j = S.symbol_factory.BitVecSym(f"{tag}i", 256), S.symbol_factory.BitVecSym(f"{tag}j", 256)
    vi, vj = storage[i], storage[j]
    names = [f"{tag}i", f"{tag}j", f"{tag}st"]
    return [check(pkg, names, i == j, vi != vj), check(pkg, names, i != j, vi == 5, vj == 7)]


def case_store_select(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    storage = S.Array(f"{tag}s", 256, 256)
    storage[sf.BitVecVal(3, 256)] = sf.BitVecVal(0xAA, 256)
    x = sf.BitVecSym(f"{tag}x", 256)
    v = storage[x]
    names = [f"{tag}x", f"{tag}s"]
    return [check(pkg, names, v == 0xAA), check(pkg, names, x == 3, v != 0xAA)]


def case_store_chain(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    storage = S.Array(f"{tag}xs", 256, 256)
    k = sf.BitVecSym(f"{tag}k", 256)
    storage[sf.BitVecVal(1, 256)] = sf.BitVecVal(11, 256)
    storage[sf.BitVecVal(2, 256)] = sf.BitVecVal(22, 256)
    read = storage[k]
    names = [f"{tag}k", f"{tag}xs"]
    return [check(pkg, names, k == 1, read == 22), check(pkg, names, k == 2, read == 22),
            check(pkg, names, k == 5, read == 77)]


def case_const_array(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    arr = S.K(256, 256, 7)
    arr[sf.BitVecVal(9, 256)] = sf.BitVecVal(8, 256)
    x = sf.BitVecSym(f"{tag}x", 256)
    return [check(pkg, [f"{tag}x"], arr[x] == 8), check(pkg, [], arr[x] == 6)]


def case_ite(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    c = sf.BitVecSym(f"{tag}c", 256)
    r = S.If(c == 0, sf.BitVecVal(11, 256), sf.BitVecVal(22, 256))
    return check(pkg, [f"{tag}c"], r == 22)


def case_uf(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    h = S.Function(f"{tag}keccak", 256, 256)
    a, b = sf.BitVecSym(f"{tag}a", 256), sf.BitVecSym(f"{tag}b", 256)
    return [check(pkg, [f"{tag}a", f"{tag}b"], h(a) == h(b), a != b, S.ULT(a, 4)),
            check(pkg, [], a == b, h(a) != h(b))]


def case_random_systems(pkg, tag):
    """test_solver.py's random differential (its shapes, 8-bit), solver
    against solver: 12 systems."""
    S = pkg.smt
    sf = S.symbol_factory
    rng = random.Random(1337)
    out = []
    for trial in range(12):
        names = [f"{tag}v{trial}_{i}" for i in range(3)]
        xs = [sf.BitVecSym(n, 8) for n in names]
        cons = []
        for _ in range(rng.randint(1, 4)):
            a, b = rng.sample(xs, 2)
            kind = rng.randrange(5)
            k = sf.BitVecVal(rng.getrandbits(8), 8)
            if kind == 0:
                cons.append(a + b == k)
            elif kind == 1:
                cons.append(S.ULT(a, k))
            elif kind == 2:
                cons.append((a & b) == k)
            elif kind == 3:
                cons.append(a * sf.BitVecVal(rng.getrandbits(4), 8) == k)
            else:
                cons.append(S.Or(a == k, b == k))
        out.append(check(pkg, names, *cons))
    return out


def case_get_model(pkg, tag):
    sf = pkg.smt.symbol_factory
    x = sf.BitVecSym(f"{tag}gm", 256)
    out = [pkg.model.get_model((x == 42,), enforce_execution_time=False).assignment[f"{tag}gm"]]
    for _ in range(2):  # the second unsat comes from the memo
        try:
            pkg.model.get_model((x == 1, x == 2), enforce_execution_time=False)
            out.append("sat")
        except pkg.exc.UnsatError as why:
            out.append(str(why))
    m = pkg.model.get_model((sf.BitVecSym(f"{tag}y", 64) * 3 == 9,),
                            minimize=(sf.BitVecSym(f"{tag}y", 64),),
                            enforce_execution_time=False)
    return out + [m.assignment[f"{tag}y"]]


def case_independence(pkg, tag):
    sf = pkg.smt.symbol_factory
    x, y, z = (sf.BitVecSym(f"{tag}{v}", 256) for v in "xyz")
    s = pkg.smt.IndependenceSolver(timeout=20000)
    s.add(x == 5, y == x + 1)
    s.add(z == 99)
    first = model_of(s.check(), s, [f"{tag}{v}" for v in "xyz"])
    s2 = pkg.smt.IndependenceSolver(timeout=20000)
    s2.add(x == 5, z == 1, z == 2)
    return [first, s2.check()]


def case_optimize(pkg, tag):
    S = pkg.smt
    sf = S.symbol_factory
    out = []
    x = sf.BitVecSym(f"{tag}x", 32)
    s = S.Optimize(timeout=20000)
    s.add(S.UGE(x, 1000), S.ULT(x, 100000))
    s.minimize(x)
    out.append(model_of(s.check(), s, [f"{tag}x"]))
    y = sf.BitVecSym(f"{tag}y", 16)
    s = S.Optimize(timeout=20000)
    s.add(S.ULT(y, 1234))
    s.maximize(y)
    out.append(model_of(s.check(), s, [f"{tag}y"]))
    # calldata-size style: minimize one, maximize another, jointly bound
    a, b = sf.BitVecSym(f"{tag}a", 64), sf.BitVecSym(f"{tag}b", 64)
    s = S.Optimize(timeout=20000)
    s.add(S.UGT(a + b, 300), S.ULT(b, 200), S.ULT(a, 5000))
    s.minimize(a)
    s.maximize(b)
    out.append(model_of(s.check(), s, [f"{tag}a", f"{tag}b"]))
    return out


CASES = {fn.__name__[5:]: fn for fn in (
    case_trivial, case_model_values, case_inequality_chain, case_addition_overflow,
    case_evm_overflow_256, case_mul_relation, case_division, case_signed_compare,
    case_selector, case_arrays, case_store_select, case_store_chain, case_const_array,
    case_ite, case_uf, case_random_systems, case_get_model, case_independence,
    case_optimize)}


@pytest.mark.parametrize("name", CASES)
def test_verdicts_and_models_equal_the_jax_package(name, deterministic):
    got = run_both(CASES[name])
    assert got["port"] == got["jax"]


def test_one_session_over_every_case_equals_the_jax_package(deterministic):
    """All cases in turn through ONE persistent session each: the
    sessions' histories (blast store, learned clauses) stay equal."""
    tag_cases = list(CASES.values())
    got = run_both(lambda pkg, tag: [case(pkg, f"{tag}c{i}") for i, case in enumerate(tag_cases)])
    assert got["port"] == got["jax"]


def test_expected_answers(deterministic):
    """A few answers test_solver.py states, held on the port alone."""
    tag = f"ts{next(_FRESH)}"
    pkg = PACKAGES["port"]
    assert case_inequality_chain(pkg, tag) == [["sat", {f"{tag}x": 102}], ["unsat", None]]
    assert case_division(pkg, tag + "d") == ["sat", {f"{tag}da": 16}]
    mins = case_optimize(pkg, tag + "o")
    assert mins[0][1] == {f"{tag}ox": 1000} and mins[1][1] == {f"{tag}oy": 1233}
    assert case_independence(pkg, tag + "i") == [
        ["sat", {f"{tag}ix": 5, f"{tag}iy": 6, f"{tag}iz": 99}], "unsat"]


def test_race_cone_picks_the_same_indices():
    tag = f"ts{next(_FRESH)}"
    picked = {}
    for name, pkg in PACKAGES.items():
        T = pkg.smt.terms
        rng = random.Random(5)
        xs = [T.bv_var(f"{tag}c{i}", 32) for i in range(12)]
        lowered = []
        for _ in range(40):
            a, b = rng.sample(xs, 2)
            lowered.append(T.ult(T.add(a, T.bv_const(rng.getrandbits(8), 32)), b))
        lowered.append(T.eq(xs[0], T.bv_const(7, 32)))
        picked[name] = [[lowered.index(t) for t in pkg.solver._race_cone(lowered, cap)]
                        for cap in (3, 8, 20, 384)]
    assert picked["port"] == picked["jax"]
    assert [len(p) for p in picked["port"]] == [3, 8, 20, 41]


def test_sprint_and_marathon_budgets_equal_the_jax_package(monkeypatch, deterministic):
    """tests/laser/smt/test_determinism.py:91 on both packages: the
    sprint passes SPRINT_CONFLICTS, and with the sprint forced to
    UNKNOWN the deterministic marathon passes timeout_ms * 8 conflicts
    with the full caller budget as its wall valve; the verdict repeats."""
    tag = f"ts{next(_FRESH)}"
    out = {}
    for name, pkg in PACKAGES.items():
        calls = []
        real = pkg.native.SolverSession.solve

        def recording(self, nvars, flat, units, timeout_ms=None, conflict_budget=None,
                      _calls=calls, _real=real, _S=pkg.solver):
            _calls.append((timeout_ms, conflict_budget))
            if conflict_budget == _S.SPRINT_CONFLICTS:
                return pkg.native.UNKNOWN, None
            return _real(self, nvars, flat, units, timeout_ms=timeout_ms,
                         conflict_budget=conflict_budget)

        monkeypatch.setattr(pkg.native.SolverSession, "solve", recording)
        T = pkg.smt.terms
        x = T.bv_var(f"{tag}x", 64)
        query = [T.ult(T.bv_const(10, 64), x), T.ult(x, T.bv_const(100, 64))]
        first = pkg.solver.check_terms(query, timeout_ms=10_000)
        second = pkg.solver.check_terms(query, timeout_ms=10_000)
        out[name] = (first[0], first[1].assignment[f"{tag}x"], second[1].assignment[f"{tag}x"],
                     calls, pkg.solver.SPRINT_CONFLICTS)
    assert out["port"] == out["jax"]
    status, xv, again, calls, sprint = out["port"]
    assert status == "sat" and 10 < xv < 100 and again == xv
    assert calls[:2] == [(10_000, sprint), (10_000, 10_000 * 8)]


# ---------------------------------------------------------------------------
# the race, on the CPU (device="cpu": the plain portfolio)
# ---------------------------------------------------------------------------


@pytest.fixture
def racing(monkeypatch):
    """The port in its default mode with the race on, every CDCL call
    stubbed to UNKNOWN after a short wait (so the marathon keeps
    slicing while the race searches), and the counters at zero."""
    monkeypatch.setattr(port_args, "deterministic_solving", False)
    port_solver.reset_blast_session()

    def unknown(self, *a, **kw):
        time.sleep(0.02)
        return port_native.UNKNOWN, None

    monkeypatch.setattr(port_native.SolverSession, "solve", unknown)
    SolverStatistics().reset()
    DegradationLog().reset()
    yield
    port_solver.reset_blast_session()


def narrow_query(tag):
    T = port_smt.terms
    x = T.bv_var(f"{tag}x", 8)
    return [T.eq(T.mul(x, T.bv_const(3, 8)), T.bv_const(9, 8)), T.ult(x, T.bv_const(10, 8))]


def test_race_on_the_cpu_wins_with_a_validated_witness(racing):
    from mythril_tpu_torch.laser.smt.evalterm import eval_term

    from mythril_tpu_torch.observe import querylog, solverstats
    from mythril_tpu_torch.support.phase_profile import PhaseProfile

    port_model.get_model((port_smt.symbol_factory.BitVecSym("ts_phase", 8) == 1,),
                         enforce_execution_time=False)
    tag = f"ts{next(_FRESH)}"
    query = narrow_query(tag)
    marker, losses = solverstats.marker(), querylog.loss_marker()
    status, model = port_solver.check_terms(query, timeout_ms=20_000, device="cpu")
    stats = SolverStatistics()
    assert status == "sat" and model.assignment[f"{tag}x"] == 3
    assert all(eval_term(c, model.assignment) for c in query)
    assert (stats.race_started, stats.race_wins, stats.race_errors, stats.device_sat_count) == (
        1, 1, 0, 1)
    assert stats.cdcl_sat_count == 0
    table = solverstats.attribution(since=marker)
    assert table["device-portfolio"]["verdicts"] == {"sat": 1} and "host-cdcl" not in table
    assert table["device-portfolio"]["escalations"] == 1
    assert querylog.loss_reasons(since=losses) == {}
    assert PhaseProfile().as_dict()["solve"]["count"] >= 1  # get_model's phase


def test_race_witness_that_fails_the_gate_is_refused(racing, monkeypatch):
    tag = f"ts{next(_FRESH)}"
    monkeypatch.setattr(port_portfolio, "device_check",
                        lambda lowered, **kw: {f"{tag}x": 4})
    status, model = port_solver.check_terms(narrow_query(tag), timeout_ms=600, device="cpu")
    stats = SolverStatistics()
    assert (status, model) == ("unknown", None)
    assert (stats.race_started, stats.race_wins, stats.race_losses, stats.race_errors) == (
        1, 0, 1, 0)


def test_a_raising_race_is_counted_not_swallowed(monkeypatch):
    """device_check raising (a build or launch error) ends the race as
    an error: counted, recorded, and the CDCL still decides."""
    from mythril_tpu_torch.laser.smt.solver import device_race

    def broken(lowered, **kw):
        raise RuntimeError("portfolio_sls launch failed: cudaError 700")

    real = port_native.SolverSession.solve

    def sprint_unknown(self, nvars, flat, units, timeout_ms=None, conflict_budget=None):
        if conflict_budget == port_solver.SPRINT_CONFLICTS:
            return port_native.UNKNOWN, None
        time.sleep(0.05)  # the race has time to fail first
        return real(self, nvars, flat, units, timeout_ms=timeout_ms,
                    conflict_budget=conflict_budget)

    monkeypatch.setattr(port_args, "deterministic_solving", False)
    monkeypatch.setattr(port_portfolio, "device_check", broken)
    monkeypatch.setattr(port_native.SolverSession, "solve", sprint_unknown)
    port_solver.reset_blast_session()
    SolverStatistics().reset()
    DegradationLog().reset()
    from mythril_tpu_torch.observe import querylog

    tag = f"ts{next(_FRESH)}"
    losses = querylog.loss_marker()
    status, model = port_solver.check_terms(narrow_query(tag), timeout_ms=20_000, device="cpu")
    assert device_race.wait_idle(10)  # the race thread has ended
    port_solver.reset_blast_session()
    stats = SolverStatistics()
    assert status == "sat" and model.assignment[f"{tag}x"] == 3
    assert (stats.race_started, stats.race_errors, stats.race_wins) == (1, 1, 0)
    assert DegradationLog().counts == {"device-race-failed": 1}
    assert "cudaError 700" in DegradationLog().events[0]["detail"]
    # the host kept the verdict after the race came back empty
    assert querylog.loss_reasons(since=losses, verdict="sat") == {"SLS_NONCONVERGED": 1}


def test_parallel_solving_escape_runs_the_portfolio(racing, monkeypatch):
    """--parallel-solving where no race can start (an exploration holds
    the card, as on the explorer's ladder): a query the CDCL leaves
    unknown gets one portfolio search (here the plain one)."""
    from mythril_tpu_torch.laser.smt.solver.device_race import DEVICE_BUSY

    monkeypatch.setattr(port_args, "parallel_solving", True)
    tag = f"ts{next(_FRESH)}"
    DEVICE_BUSY.acquire()
    try:
        status, model = port_solver.check_terms(narrow_query(tag), timeout_ms=300,
                                                device="cpu")
    finally:
        DEVICE_BUSY.release()
    stats = SolverStatistics()
    assert status == "sat" and model.assignment[f"{tag}x"] == 3
    assert (stats.race_started, stats.device_sat_count) == (0, 1)


@pytest.mark.parametrize("path", ["race", "escape"])
def test_get_model_searches_on_the_device_it_is_given(racing, monkeypatch, path):
    """get_model's `device` reaches Optimize and check_terms: the race,
    and the --parallel-solving escape where an exploration holds the
    card (DEVICE_BUSY, so no race starts, as on the explorer's ladder),
    search on the CPU when the caller names it; `device=None` would mean
    the card (and raise on a host without one)."""
    from mythril_tpu_torch.laser.smt.solver.device_race import DEVICE_BUSY

    seen = []
    real = port_portfolio.device_check

    def recording(lowered, **kw):
        seen.append(torch.device(kw["device"]).type)
        # the race finds nothing; the escape searches for real
        return real(lowered, **kw) if path == "escape" else None

    monkeypatch.setattr(port_args, "parallel_solving", True)
    monkeypatch.setattr(port_portfolio, "device_check", recording)
    port_model.clear_cache()
    tag = f"ts{next(_FRESH)}"
    x = port_smt.symbol_factory.BitVecSym(f"{tag}x", 8)
    constraints = (x * 3 == 9, port_smt.ULT(x, 10))
    if path == "escape":
        DEVICE_BUSY.acquire()
    try:
        if path == "escape":
            model = port_model.get_model(constraints, enforce_execution_time=False,
                                         solver_timeout=600, device="cpu")
            assert model.assignment[f"{tag}x"] == 3
        else:
            with pytest.raises(port_exceptions.SolverTimeOutException):
                port_model.get_model(constraints, enforce_execution_time=False,
                                     solver_timeout=600, device="cpu")
    finally:
        if path == "escape":
            DEVICE_BUSY.release()
        port_model.clear_cache()
    stats = SolverStatistics()
    assert seen == ["cpu"]
    assert (stats.race_started, stats.race_errors, stats.device_sat_count) == (
        (0, 0, 1) if path == "escape" else (1, 0, 0))


def pin_chip() -> None:
    """The JAX verdicts of chip_smoke.py's solver phase, on the CPU."""
    import json
    import sys
    from pathlib import Path

    sys.path[:0] = [str(Path(__file__).parent), str(Path(__file__).parents[1])]
    import conftest  # noqa: F401  (JAX on the CPU)
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    import test_torch_arena
    from mythril_tpu.laser.batch.arena import ArenaView as JaxArenaView

    out, _steps, _active = test_torch_arena.jax_wave()
    view = JaxArenaView(jax.tree_util.tree_map(jnp.asarray, jax.device_get(out)))
    flips = chip_smoke.flip_queries(view, np.asarray(out.base.code_id))
    corpus = chip_smoke.solver_corpus(jax_smt.terms, flips)
    jax_solver.reset_blast_session()
    verdicts = {}
    for name, raw in corpus:
        verdicts[name] = jax_solver.check_terms(raw, timeout_ms=chip_smoke.SOLVER_TIMEOUT_MS)[0]
        print(name, verdicts[name])
    verdicts["escape"] = jax_solver.check_terms(
        chip_smoke.escape_query(jax_smt.terms), timeout_ms=chip_smoke.ESCAPE_TIMEOUT_MS)[0]
    print("escape", verdicts["escape"])
    doc = {"settings": {"timeout_ms": chip_smoke.SOLVER_TIMEOUT_MS,
                        "escape_timeout_ms": chip_smoke.ESCAPE_TIMEOUT_MS},
           "verdicts": verdicts}
    chip_smoke.SOLVER_PIN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {chip_smoke.SOLVER_PIN}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--pin-chip"]:
        pin_chip()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_solver.py --pin-chip")
