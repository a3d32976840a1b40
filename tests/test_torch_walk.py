"""The port's host walk (SymExecWrapper + fire_lasers) against the JAX
package's, on the CPU.

Both packages walk the same contracts under `deterministic_solving`
(no solver race, conflict-budgeted marathons) from a fresh solver
session and model cache, each test with static pruning (the detector
screen, analysis/static) off and on, set alike in both packages:

- the 14 module positive fixtures of
  tests/analysis/test_module_positive_fixtures.py, each with its module
  alone, and the fault-suite contracts of tests/laser/test_pipeline.py
  (KILLABLE, WRITER, BRANCHER, GATED) with every module, run live
  through both packages with no device prepass: the issue fingerprints
  (swc-id, address, title, function) are equal, both packages mount the
  same modules (`static_screen`), and every fixture gives at least one
  issue;
- the five quick vendored contracts the device does not own (origin,
  metacoin, overflow, underflow, kinds_of_calls), walked with a pinned
  JAX prepass outcome injected (carried as JSON by
  `interop.outcome_to_json`/`outcome_from_json`): the issues' `as_dict`s
  equal the JAX walk's (an `as_dict` carries no wall time) in every
  field but the transaction sequence, which must equal the pin's or
  replay to its issue's pc on the port's concrete interpreter
  (analysis/replay.py). The witness model is not a function of the
  query alone in either package: the term layer orders commutative
  children by creation id, so the terms an earlier walk in the same
  process left behind change the CNF of a later one (overflow's first
  SWC-101 gets another sequence when it is walked after another
  contract; the static screen, which changes which queries a walk
  poses, moves kinds_of_calls' and overflow's sequences too).

The three slow vendored contracts (calls, ether_send, environments, 15
to 50 s each on the CPU) run only in the script mode,

    PYTHONPATH=. python tests/test_torch_walk.py --full

which walks all eight against the JAX package live (`--full-static`:
both with static pruning on). The JAX side is
pinned in tests/test_torch_walk_pinned.json (the eight outcomes from the
JAX corpus prepass at WAVES waves a phase under each package's
enumeration-only solver, and the JAX walk's issues); regenerate it with

    PYTHONPATH=. python tests/test_torch_walk.py --pin
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from mythril_tpu_torch import interop
from mythril_tpu_torch.analysis import corpus as port_corpus
from mythril_tpu_torch.laser import symbolic_wave

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
PINNED = TESTS / "test_torch_walk_pinned.json"
ADDR = port_corpus.DEFAULT_ADDRESS

#: the vendored contracts the device does not own at the analyze
#: geometry (ROADMAP.md Queue 1 item 4), quick ones first
QUICK = ("origin", "metacoin", "overflow", "underflow", "kinds_of_calls")
SLOW = ("calls", "ether_send", "environments")
#: the JAX corpus prepass's wave cap a phase for the pinned outcomes
WAVES = 8
#: the walk's settings: the JAX analyze defaults, two transactions
WALK = dict(strategy="bfs", transaction_count=2, execution_timeout=600,
            create_timeout=10, max_depth=128, loop_bound=3, modules=None,
            solver_timeout=None)

#: tests/laser/test_pipeline.py's fault-suite contracts (held to it below)
FAULT_SUITE = {
    "KILLABLE": "33ff",
    "WRITER": "6001600055600060015500",
    "BRANCHER": "600035600757005b600160005500",
    "GATED": "60003560f81c604214600d57005b600160005500",
}
#: a selfdestruct behind calldata byte 0 == 0x42 (pc 15)
GATED_KILL = "604260003560f81c14600d57005b33ff"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FIXTURES = _load(TESTS / "analysis" / "test_module_positive_fixtures.py").FIXTURES


def vendored(name: str) -> str:
    return (symbolic_wave.CONTRACTS / f"{name}.sol.o").read_text().strip()


@pytest.fixture(autouse=True)
def deterministic(monkeypatch):
    """Both packages: deterministic solving, no device prepass of their
    own, static pruning off (the `static` fixture turns it on), and a
    fresh model cache and solver session (SymExecWrapper resets the
    session itself)."""
    from mythril_tpu.support import model as jax_model
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support import model as port_model
    from mythril_tpu_torch.support.support_args import args as port_args

    for flag, value in (("deterministic_solving", True), ("device_prepass", "never"),
                        ("static_prune", False)):
        monkeypatch.setattr(jax_args, flag, value)
        monkeypatch.setattr(port_args, flag, value)
    jax_model.clear_cache()
    port_model.clear_cache()


@pytest.fixture(params=[False, True], ids=["static_off", "static_on"])
def static(request, monkeypatch):
    """Static pruning as the parameter says, in both packages."""
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support.support_args import args as port_args

    monkeypatch.setattr(jax_args, "static_prune", request.param)
    monkeypatch.setattr(port_args, "static_prune", request.param)
    return request.param


class _Contract:
    """The positive-fixture suite's FakeContract, over either package's
    Disassembly."""

    def __init__(self, disassembly_cls, code):
        self.name = "Test"
        self.code = code
        self.creation_code = None
        self.disassembly = disassembly_cls(code)


def walk_live(package: str, code: str, modules=None, tx_count=1, screen=None):
    """The positive-fixture suite's `analyze` through `package`: one
    SymExecWrapper + fire_lasers at address 0x1234, bfs. `screen`, a
    list, receives the wrapper's static screen (None: all modules)."""
    security = importlib.import_module(f"{package}.analysis.security")
    symbolic = importlib.import_module(f"{package}.analysis.symbolic")
    disassembly = importlib.import_module(f"{package}.disassembler.disassembly")
    kw = {"device": "cpu"} if package == "mythril_tpu_torch" else {}
    sym = symbolic.SymExecWrapper(
        _Contract(disassembly.Disassembly, code), address=0x1234, strategy="bfs",
        execution_timeout=90, create_timeout=30, transaction_count=tx_count,
        modules=modules, **kw)
    if screen is not None:
        screen.append(sym.static_screen)
    return security.fire_lasers(sym, white_list=modules)


def fingerprints(issues):
    return sorted((i.swc_id, i.address, i.title, i.function) for i in issues)


@pytest.mark.parametrize("module", sorted(FIXTURES))
def test_positive_fixture_issues_equal_the_jax_package(module, static):
    code, expected_swc = FIXTURES[module]
    screens = []
    want = fingerprints(walk_live("mythril_tpu", code, [module], screen=screens))
    got = fingerprints(walk_live("mythril_tpu_torch", code, [module], screen=screens))
    assert got == want
    assert got, f"{module} produced no issues on its positive fixture"
    if expected_swc is not None:
        assert {fp[0] for fp in got} & expected_swc
    assert screens[0] == screens[1]
    assert (screens[1] is None) == (not static)
    if static:
        assert module in screens[1]


@pytest.mark.parametrize("name", sorted(FAULT_SUITE))
def test_fault_suite_issues_equal_the_jax_package(name, static):
    code = FAULT_SUITE[name]
    screens = []
    want = fingerprints(walk_live("mythril_tpu", code, tx_count=2, screen=screens))
    got = fingerprints(walk_live("mythril_tpu_torch", code, tx_count=2, screen=screens))
    assert got == want
    assert screens[0] == screens[1]
    assert (screens[1] is None) == (not static)


def test_inputs_are_the_jax_suites_contracts():
    pipeline = TESTS / "laser" / "test_pipeline.py"
    text = pipeline.read_text()
    for name, code in FAULT_SUITE.items():
        assert f'{name} = "{code}"' in text, name
    assert len(FIXTURES) == 14


@pytest.mark.parametrize("options", [
    {"strategy": "dfs"}, {"disable_dependency_pruning": True},
    {"loop_bound": 2}, {"iprof": True}, {"modules": ["ExternalCalls"]}])
def test_walk_options_keep_the_issues(options, monkeypatch):
    """The walk's knobs (the CLI's --strategy, --disable-dependency-pruning,
    --loop-bound, --enable-iprof) run the walk to the same issues on the
    external-call fixture; -m keeps the module's alone."""
    from mythril_tpu_torch.support.support_args import args

    code = FIXTURES["ExternalCalls"][0]
    base = port_corpus._analyze_one(code, "", "c", 0x1234, None, transaction_count=1,
                                    device="cpu")
    options = dict(options)
    if options.pop("iprof", False):
        monkeypatch.setattr(args, "iprof", True)
    got = port_corpus._analyze_one(code, "", "c", 0x1234, None, transaction_count=1,
                                   device="cpu", **options)
    assert got["error"] is None and base["error"] is None
    fps = [(i["swc-id"], i["address"], i["title"]) for i in base["issues"]]
    assert ("107", 16, "External Call To User-Supplied Address") in fps
    if "modules" in options:
        fps = [fp for fp in fps if fp[0] == "107"]
    assert [(i["swc-id"], i["address"], i["title"]) for i in got["issues"]] == fps


def test_cli_passes_the_walk_flags(monkeypatch, capsys):
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.mythril import mythril_analyzer
    from mythril_tpu_torch.support.support_args import args

    seen = {}

    class Record:
        """The walk the analyzer facade builds: its options and the
        solver timeout in the flag bag."""

        def __init__(self, contract, address, strategy, **kw):
            seen.update(kw, strategy=strategy, solver_timeout=args.solver_timeout)
            self.execution_info = []

    def fire(sym, modules=None):
        seen["fired_modules"] = modules
        return []

    monkeypatch.setattr(mythril_analyzer, "SymExecWrapper", Record)
    monkeypatch.setattr(mythril_analyzer, "fire_lasers", fire)
    for flag in ("call_depth_limit", "iprof", "static_prune", "static_answer", "specialize",
                 "blockjit", "solver_timeout", "device_prepass", "device_solving",
                 "device_prepass_budget", "device_ownership", "deterministic_solving",
                 "parallel_solving", "pipeline", "run_deadline_s", "on_timeout"):
        monkeypatch.setattr(args, flag, getattr(args, flag))
    rc = cli.main(["analyze", "--bin-runtime", "-c", "33ff", "--device", "cpu", "-o", "json",
                   "-m", "TxOrigin, Exceptions", "--strategy", "dfs", "--max-depth", "40",
                   "-b", "2", "--solver-timeout", "500", "--create-timeout", "3",
                   "--call-depth-limit", "2", "--disable-dependency-pruning",
                   "--enable-coverage-strategy", "--enable-iprof"])
    capsys.readouterr()
    assert rc == 0
    assert {k: seen[k] for k in ("strategy", "max_depth", "loop_bound", "solver_timeout",
                                 "create_timeout", "modules", "disable_dependency_pruning")} == {
        "strategy": "dfs", "max_depth": 40, "loop_bound": 2, "solver_timeout": 500,
        "create_timeout": 3, "modules": ["TxOrigin", "Exceptions"],
        "disable_dependency_pruning": True}
    assert seen["fired_modules"] == ["TxOrigin", "Exceptions"]
    # --enable-coverage-strategy is parsed and read nowhere, as in the JAX package
    assert "enable_coverage_strategy" not in seen
    assert (args.call_depth_limit, args.iprof) == (2, True)


def test_wrapper_explores_on_its_device_when_no_outcome_is_injected(monkeypatch):
    """SymExecWrapper with no injected outcome runs its own device
    prepass (DeviceSymbolicExplorer) on the wrapper's device, here the
    CPU: the prepass's witness for the selfdestruct becomes a device
    issue, its branch directions seed the walk, and the reported issues
    are the JAX package's walk's."""
    from mythril_tpu_torch.laser.batch import explore
    from mythril_tpu_torch.support.phase_profile import PhaseProfile
    from mythril_tpu_torch.support.support_args import args

    devices = []
    real = explore.DeviceSymbolicExplorer.__init__

    def recording(self, *a, **kw):
        devices.append(kw.get("device"))
        real(self, *a, **kw)

    monkeypatch.setattr(explore.DeviceSymbolicExplorer, "__init__", recording)
    want = fingerprints(walk_live("mythril_tpu", GATED_KILL))
    monkeypatch.setattr(args, "device_prepass", "auto")
    symbolic = importlib.import_module("mythril_tpu_torch.analysis.symbolic")
    security = importlib.import_module("mythril_tpu_torch.analysis.security")
    disassembly = importlib.import_module("mythril_tpu_torch.disassembler.disassembly")
    sym = symbolic.SymExecWrapper(
        _Contract(disassembly.Disassembly, GATED_KILL), address=0x1234, strategy="bfs",
        execution_timeout=90, create_timeout=30, transaction_count=1, device="cpu")
    got = fingerprints(security.fire_lasers(sym))
    stats = sym.device_exploration["stats"]
    assert devices == ["cpu"]
    assert stats["waves"] >= 1 and stats["witness_issues"] >= 1
    assert [(i.swc_id, i.address) for i in sym.device_issues] == [("106", 15)]
    assert sym.laser.device_covered and "prepass" in PhaseProfile().as_dict()
    assert got == want and ("106", 15) in {fp[:2] for fp in got}


def test_walk_races_where_the_analysis_runs(monkeypatch):
    """A walk on the CPU out of deterministic mode, the CDCL leaving every
    query unknown: the walk's queries race (SymExecWrapper's device down
    to check_terms), every race searches on the CPU and never on the
    card, none raises, and the walk ends without error."""
    from mythril_tpu_torch.laser.smt.solver import device_race, native_sat
    from mythril_tpu_torch.laser.smt.solver import portfolio as port_portfolio
    from mythril_tpu_torch.laser.smt.solver.solver_statistics import SolverStatistics
    from mythril_tpu_torch.support.support_args import args

    seen = []
    real = port_portfolio.device_check

    def recording(lowered, **kw):
        seen.append(torch.device(kw["device"]).type)
        return real(lowered, **kw)

    monkeypatch.setattr(args, "deterministic_solving", False)
    monkeypatch.setattr(native_sat.SolverSession, "solve",
                        lambda self, *a, **kw: (native_sat.UNKNOWN, None))
    monkeypatch.setattr(port_portfolio, "device_check", recording)
    stats = SolverStatistics()
    before = (stats.race_started, stats.race_errors)
    result = port_corpus._analyze_one(FAULT_SUITE["GATED"], "", "gated", 0x1234, None,
                                      transaction_count=1, solver_timeout=300, device="cpu")
    assert device_race.wait_idle(timeout=120)
    assert result["error"] is None, result["error"]
    assert stats.race_started > before[0] and stats.race_errors == before[1]
    assert seen and set(seen) == {"cpu"}


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


def port_walk(name: str, outcome_json: str):
    from mythril_tpu_torch.support.support_args import args

    assert args.deterministic_solving
    return port_corpus._analyze_one(
        vendored(name), "", name, ADDR, interop.outcome_from_json(outcome_json),
        device="cpu", **WALK)


def walk_differences(got: list, want: list) -> list:
    """Where the port's walked issue dicts differ from the JAX walk's:
    [(position, swc-id, pc, the fields that differ)], a length mismatch
    as [(-1, got's (swc-id, pc)s, want's)]. Every field but the
    transaction sequence must be equal; a sequence that differs from
    the JAX walk's must replay to its pc ("tx_sequence" is listed when
    it does not)."""
    from mythril_tpu_torch.analysis.replay import replays_to

    if len(got) != len(want):
        return [(-1, [(i["swc-id"], i["address"]) for i in got],
                 [(i["swc-id"], i["address"]) for i in want])]
    bad = []
    for k, (g, w) in enumerate(zip(got, want)):
        fields = sorted(key for key in set(g) | set(w)
                        if key != "tx_sequence" and g.get(key) != w.get(key))
        if g["tx_sequence"] != w["tx_sequence"] and not replays_to(g, device="cpu"):
            fields.append("tx_sequence")
        if fields:
            bad.append((k, g["swc-id"], g["address"], fields))
    return bad


@pytest.mark.parametrize("name", QUICK)
def test_vendored_walk_equals_the_jax_pin(name, pinned, static):
    """The pin is the JAX walk with static pruning off; the static-on
    walk reaches the same issues (the screen only drops modules that
    cannot fire), so it is held to the same pin."""
    result = port_walk(name, pinned["outcomes"][name])
    assert result["error"] is None, result["error"]
    assert walk_differences(result["issues"], pinned["issues"][name]) == []
    assert result["states"] > 0 and result["device_prepass"] is not None


def test_outcome_json_round_trips(pinned):
    text = pinned["outcomes"]["origin"]
    outcome = interop.outcome_from_json(text)
    assert all(isinstance(b, tuple) for b in outcome["covered_branches"])
    assert interop.outcome_to_json(outcome) == text
    assert interop.outcome_to_json({"s": {(3, True), (1, False)}}) == '{"s": [[1, false], [3, true]]}'


def test_live_jax_walk_matches_the_pin(pinned):
    """The pin is what the JAX walk gives now (origin, live)."""
    result = jax_walk("origin", pinned["outcomes"]["origin"])
    assert result["error"] is None and result["issues"] == pinned["issues"]["origin"]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def jax_walk(name: str, outcome_json: str) -> dict:
    """The JAX package's `_analyze_one` on a vendored contract, the
    pinned outcome injected, deterministic, host only."""
    from mythril_tpu.analysis import corpus as jax_corpus

    outcome = json.loads(outcome_json)
    return jax_corpus._analyze_one((
        vendored(name), "", name, ADDR, WALK["strategy"], WALK["transaction_count"],
        WALK["execution_timeout"], WALK["create_timeout"], WALK["max_depth"],
        WALK["loop_bound"], WALK["modules"], WALK["solver_timeout"], False, outcome, True))


def jax_outcomes() -> dict:
    """The JAX corpus prepass over the eight contracts (the small-corpus
    geometry, WAVES waves a phase with no wall budget, its ladder off and
    its enumeration-only solver), as outcome_to_json texts."""
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from test_torch_explore import _jax_setup, enum_only_solver

    rows = [(vendored(n), "", n) for n in QUICK + SLOW]
    with pytest.MonkeyPatch.context() as mp:
        jax_explore = _jax_setup(mp.setattr)
        base = jax_explore.DeviceCorpusExplorer

        class Capped(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **dict(kw, waves=WAVES, budget_s=None))

        mp.setattr(jax_explore, "DeviceCorpusExplorer", Capped)
        mp.setattr(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
        outcomes = jax_corpus.corpus_device_prepass(
            rows, address=ADDR, transaction_count=2, execution_timeout=86400,
            ownership=True)
    return {name: interop.outcome_to_json(outcomes[i]) for i, (_, _, name) in enumerate(rows)}


def _script_setup(static: bool = False):
    import conftest  # noqa: F401  (the suite's JAX settings: CPU devices, flags)
    from mythril_tpu.support import model as jax_model
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support import model as port_model
    from mythril_tpu_torch.support.support_args import args as port_args

    for a in (jax_args, port_args):
        a.deterministic_solving = True
        a.device_prepass = "never"
        a.static_prune = static
    return jax_model, port_model


def pin() -> None:
    jax_model, _ = _script_setup()
    t0 = time.perf_counter()
    doc = {"settings": dict(WALK, waves=WAVES, solver="enumeration only"),
           "outcomes": jax_outcomes(), "issues": {}}
    print(f"JAX prepass {time.perf_counter() - t0:.1f} s")
    for name in QUICK + SLOW:
        jax_model.clear_cache()
        t0 = time.perf_counter()
        result = jax_walk(name, doc["outcomes"][name])
        assert result["error"] is None, result["error"]
        doc["issues"][name] = result["issues"]
        print(f"{name}: {len(result['issues'])} issues, {result['states']} states, "
              f"{time.perf_counter() - t0:.1f} s")
    PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}")


def full(static: bool = False) -> None:
    """All eight contracts: the JAX walk live and the port's, each with
    the pinned outcome injected and static pruning as `static` says in
    both; exits non-zero on any difference (as in the tests)."""
    jax_model, port_model = _script_setup(static)
    doc = json.loads(PINNED.read_text())
    bad = 0
    for name in QUICK + SLOW:
        jax_model.clear_cache()
        t0 = time.perf_counter()
        want = jax_walk(name, doc["outcomes"][name])
        t_jax = time.perf_counter() - t0
        port_model.clear_cache()
        t0 = time.perf_counter()
        got = port_walk(name, doc["outcomes"][name])
        t_port = time.perf_counter() - t0
        differ = (["error"] if got["error"] is not None
                  else walk_differences(got["issues"], want["issues"]))
        bad += bool(differ)
        print(f"{name}: {f'DIFFERENT {differ}' if differ else 'equal'}, "
              f"{len(got['issues'])} issues, JAX {t_jax:.1f} s, port {t_port:.1f} s")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    modes = {"--pin": pin, "--full": full, "--full-static": lambda: full(True)}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        modes[sys.argv[1]]()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_walk.py "
                 "--pin | --full | --full-static")
