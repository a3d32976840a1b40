"""The port's golden analysis and `analyze_corpus`'s JAX parameters.

`mythril_tpu_torch.analysis.goldens.golden_corpus_run` runs the JAX
package's pinned golden configuration (two transactions, 120 s walks,
host-only, deterministic solving) through the port's `analyze_corpus`,
and each fixture's canonical issue rows must equal the committed JAX
goldens (tests/testdata/goldens/*.issues.json) byte for byte in
canonical form. Tier-1 runs the fixtures whose walks take about a second
(TIER1); the slow test runs all 13, as the JAX suite's
tests/analysis/test_golden_reports.py does. environments.sol is the one
fixture where the JAX package's own live run differs from its committed
golden: run alone, both packages give the golden's two SWC-101 (278 and
378), but the witness at 278 is one transaction where the golden has
two; run after the other fixtures in one process, as the golden run
does, both lose one of the two (the term layer's history changes the
walk's queries). There the port, run alone, is held to the JAX package
run alone.

Then the parameters the port's analyze_corpus took from the JAX one:
`use_device=False` runs no prepass and no solver race (the gate reads
closed in every walk, and the flags are restored after it);
`on_timeout="fail"` raises DeadlineExpiredError; `deterministic_solving`
is scoped to the call and restored after a raise; the schedule is the
JAX one (overlapped when the device axis is on, the corpus has more than
one contract and either `_effective_cpus()` > 1 or OVERLAP_MIN_CORPUS
rows are runnable; prepass first otherwise), and the overlapped
schedule on the CPU finds the prepass-first run's issues.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mythril_tpu_torch.analysis import corpus as port_corpus
from mythril_tpu_torch.analysis.goldens import (
    GOLDEN_FIXTURES,
    canonical_issues,
    golden_corpus_run,
)
from mythril_tpu_torch.exceptions import DeadlineExpiredError
from mythril_tpu_torch.support.support_args import args

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).resolve().parent / "testdata" / "goldens"
FIXTURE_NAMES = sorted(f.stem for f in GOLDEN_FIXTURES.glob("*.sol.o"))
#: the fixtures whose golden walks take about a second on one core
TIER1 = ("exceptions.sol", "metacoin.sol", "multi_contracts.sol", "nonascii.sol",
         "origin.sol", "suicide.sol")
#: fixtures whose committed golden the JAX package's live run does not give
LIVE_JAX = ("environments.sol",)

GATED_KILL = "604260003560f81c14600d57005b33ff"
ALWAYS_ASSERT = "fe00000000"


def golden(name):
    return json.loads((GOLDEN_DIR / f"{name}.issues.json").read_text())


@pytest.fixture(scope="module")
def tier1_results():
    return dict(golden_corpus_run(TIER1))


@pytest.mark.parametrize("name", TIER1)
def test_golden_run_equals_the_committed_golden(name, tier1_results):
    result = tier1_results[name]
    assert result["error"] is None, result["error"]
    assert result["complete"] and not result["owned"]
    assert result["device_prepass"] is None  # host-only: no prepass ran
    assert canonical_issues(result["issues"]) == golden(name)


def test_every_fixture_has_a_golden():
    goldens = sorted(p.name[: -len(".issues.json")] for p in GOLDEN_DIR.glob("*.issues.json"))
    assert goldens == FIXTURE_NAMES and set(TIER1) < set(FIXTURE_NAMES)


#: one fixture's golden run in a fresh process (a walk's findings depend
#: on the terms earlier walks left in the process), printing [error,
#: canonical rows]; {package} is mythril_tpu or mythril_tpu_torch
ALONE = """
import json
from {package}.analysis.goldens import GOLDEN_FIXTURES, canonical_issues
from {package}.analysis.corpus import analyze_corpus
code = (GOLDEN_FIXTURES / "{name}.o").read_text().strip()
(result,) = analyze_corpus([(code, "", "{name}")], transaction_count=2, execution_timeout=120,
                           create_timeout=10, use_device=False, deterministic_solving=True)
print(json.dumps([result["error"], canonical_issues(result["issues"])]))
"""


def golden_run_alone(package, name):
    proc = subprocess.run([sys.executable, "-c", ALONE.format(package=package, name=name)],
                          cwd=GOLDEN_DIR.parents[2], capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def all_results():
    return dict(golden_corpus_run())


@pytest.mark.slow
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_full_golden_corpus(name, request):
    if name in LIVE_JAX:
        error, got = golden_run_alone("mythril_tpu_torch", name)
        jax_error, want = golden_run_alone("mythril_tpu", name)
        assert jax_error is None, jax_error
    else:
        result = request.getfixturevalue("all_results")[name]
        error, got, want = result["error"], canonical_issues(result["issues"]), golden(name)
    assert error is None, error
    assert got == want, [[(r["address"], r["swc-id"], r["tx_steps"]) for r in rows]
                         for rows in (got, want)]


# --------------------------------------------------------------------------
# analyze_corpus: the JAX parameters
# --------------------------------------------------------------------------


def test_host_only_leg_runs_no_prepass_and_no_race(monkeypatch):
    """use_device=False: no corpus prepass, no explorer, and every walk
    with `device_prepass` and `device_solving` at "never" (the race's
    gate reads closed), restored afterwards; the result equals the
    committed golden."""
    from mythril_tpu_torch.analysis import symbolic
    from mythril_tpu_torch.laser.batch import explore
    from mythril_tpu_torch.laser.smt.solver import device_race, solver

    def refuse(*a, **kw):
        raise AssertionError("the host-only leg reached the device")

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", refuse)
    monkeypatch.setattr(explore.DeviceCorpusExplorer, "run", refuse)
    monkeypatch.setattr(device_race.DeviceRace, "__init__", refuse)
    gates, flags = [], []
    enabled = solver.device_solving_enabled

    def gate():
        gates.append(enabled())
        return gates[-1]

    monkeypatch.setattr(solver, "device_solving_enabled", gate)
    wrapper = symbolic.SymExecWrapper.__init__

    def spying(self, *a, **kw):
        flags.append((args.device_prepass, args.device_solving))
        wrapper(self, *a, **kw)

    monkeypatch.setattr(symbolic.SymExecWrapper, "__init__", spying)
    before = (args.device_prepass, args.device_solving, args.deterministic_solving)
    code = (GOLDEN_FIXTURES / "suicide.sol.o").read_text().strip()
    (result,) = port_corpus.analyze_corpus(
        [(code, "", "suicide.sol")], transaction_count=2, execution_timeout=120,
        use_device=False, deterministic_solving=True)
    assert result["error"] is None and result["complete"]
    assert canonical_issues(result["issues"]) == golden("suicide.sol")
    assert flags == [("never", "never")]
    assert gates and not any(gates)
    assert (args.device_prepass, args.device_solving, args.deterministic_solving) == before


def test_device_flags_are_restored_after_a_failing_walk(monkeypatch):
    from mythril_tpu_torch.analysis import symbolic

    def fail(self, *a, **kw):
        raise RuntimeError("walk fault")

    monkeypatch.setattr(symbolic.SymExecWrapper, "__init__", fail)
    before = (args.device_prepass, args.device_solving)
    (result,) = port_corpus.analyze_corpus([(GATED_KILL, "", "g")], use_device=False)
    assert "walk fault" in result["error"] and result["complete"] is False
    assert (args.device_prepass, args.device_solving) == before


def test_on_timeout_fail_raises_and_partial_returns():
    rows = [(GATED_KILL, "", "g"), (ALWAYS_ASSERT, "", "a")]
    partial = port_corpus.analyze_corpus(rows, deadline_s=0.0, use_device=False)
    assert [(r["skipped"], r["complete"]) for r in partial] == [
        ("deadline-expired", False), ("deadline-expired", False)]
    with pytest.raises(DeadlineExpiredError, match="2/2 contract"):
        port_corpus.analyze_corpus(rows, deadline_s=0.0, use_device=False,
                                   on_timeout="fail")


def test_deterministic_solving_is_scoped_and_restored_after_a_raise(monkeypatch):
    monkeypatch.setattr(args, "deterministic_solving", False)
    seen = []
    real = port_corpus._skipped_result

    def spying(*a, **kw):
        seen.append(args.deterministic_solving)
        return real(*a, **kw)

    monkeypatch.setattr(port_corpus, "_skipped_result", spying)
    with pytest.raises(DeadlineExpiredError):
        port_corpus.analyze_corpus([(GATED_KILL, "", "g")], deadline_s=0.0,
                                   use_device=False, deterministic_solving=True,
                                   on_timeout="fail")
    assert seen == [True] and args.deterministic_solving is False
    port_corpus.analyze_corpus([(GATED_KILL, "", "g")], deadline_s=0.0, use_device=False)
    assert seen == [True, False]  # None leaves the flag as it is


class FakeOverlap:
    """OverlappedPrepass's interface with no thread: every outcome final
    and none, the card free."""
    created = []

    def __init__(self, rows, **kw):
        import threading

        FakeOverlap.created.append((len(rows), kw))
        self.lock = threading.Lock()
        self.drain_abandoned = False

    def drain(self):
        pass

    def outcome_for(self, i):
        return None, True

    def yield_lock(self):
        pass

    def finish(self):
        return {}


@pytest.mark.parametrize("cpus,n_rows,use_device,want", [
    (2, 2, None, "overlapped"),
    (1, 2, None, "prepass first"),
    (1, port_corpus.OVERLAP_MIN_CORPUS - 1, None, "prepass first"),
    (1, port_corpus.OVERLAP_MIN_CORPUS, None, "overlapped"),
    (2, 1, None, "prepass first"),
    (2, 2, False, "host only"),
])
def test_schedule_follows_the_cpus_and_the_corpus_size(cpus, n_rows, use_device, want,
                                                       monkeypatch):
    firsts, walks = [], []
    FakeOverlap.created = []
    monkeypatch.setattr(port_corpus, "_effective_cpus", lambda: cpus)
    monkeypatch.setattr(port_corpus, "OverlappedPrepass", FakeOverlap)
    monkeypatch.setattr(port_corpus, "corpus_device_prepass",
                        lambda rows, **kw: firsts.append(len(rows)) or {})
    monkeypatch.setattr(port_corpus, "_static_triage", lambda rows: {})

    def walk(code, creation, name, address, outcome, use_device=True, **kw):
        walks.append((name, use_device))
        return {"name": name, "issues": [], "issue_objects": [], "error": None}

    monkeypatch.setattr(port_corpus, "_analyze_one", walk)
    # distinct lengths: the overlapped schedule walks smallest code first
    rows = [("60" * (4 + (n_rows - i)) + "00", "", f"c{i}") for i in range(n_rows)]
    results = port_corpus.analyze_corpus(rows, device="cpu", use_device=use_device)
    got = ("overlapped" if FakeOverlap.created else
           "prepass first" if firsts else "host only")
    assert got == want
    assert [r["name"] for r in results] == [name for _, _, name in rows]
    assert sorted(walks) == sorted((name, use_device is not False) for _, _, name in rows)
    if want == "overlapped":
        assert [name for name, _ in walks] == [name for _, _, name in reversed(rows)]
        ((n, kw),) = FakeOverlap.created
        assert n == n_rows and kw["device"] == "cpu" and kw["ownership"] is True


def test_overlapped_schedule_finds_the_prepass_first_issues(monkeypatch):
    """The milestone corpus on the CPU through both schedules: the same
    issue set (SWC-106 at 15, SWC-110 at 0), every contract complete."""
    monkeypatch.setattr(args, "deterministic_solving", True)
    monkeypatch.setattr(args, "sprint_cap_s", 0.0)

    def fingerprints(cpus):
        monkeypatch.setattr(port_corpus, "_effective_cpus", lambda: cpus)
        results = port_corpus.analyze_corpus(
            [(GATED_KILL, "", "gated_kill"), (ALWAYS_ASSERT, "", "asserts")],
            transaction_count=2, execution_timeout=30, waves=2, device="cpu")
        assert all(r["complete"] and r["error"] is None for r in results)
        return sorted((r["name"], i["swc-id"], i["address"], i["title"])
                      for r in results for i in r["issues"])

    overlapped, first = fingerprints(2), fingerprints(1)
    assert overlapped == first
    assert ("gated_kill", "106", 15, "Unprotected Selfdestruct") in first
    assert ("asserts", "110", 0, "Exception State") in first
