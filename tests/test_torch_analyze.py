"""The port's corpus analysis and issue synthesis against the JAX package's.

`mythril_tpu_torch.analysis` (corpus.py's device half, prepass.py,
evidence.py, report.py) runs here on the CPU (`device="cpu"`) beside the
JAX package's on the same inputs:

- the milestone corpus (`gated_kill`, `always_assert`,
  __graft_entry__.py:dryrun_multichip), KILL2TX
  (tests/laser/test_device_symbolic.py), the round-5 evidence contracts
  `WRAP_AND_ORIGIN`, `CALL_TO_CALLDATA` and `STORAGE_ADD`
  (tests/laser/test_evidence_round5.py), and
  `corpusgen.degrader_contract(0x5000)`, whose CALLDATACOPY past the
  16384-byte memory cap degrades every lane;
- `analyze_corpus` at the JAX package's small-corpus prepass geometry
  (32 lanes a contract, mem_cap 16384, storage_cap 128, 512 steps a wave,
  two transactions) with a fixed cap of WAVES waves a phase in place of
  the wall budget, so that a run does not depend on the clock. The JAX
  side is its own `analyze_corpus` on its single-process path (the
  prepass, then the ownership gate and `_owned_result`; an unowned
  contract goes to its host walk, as in the port), under
  `deterministic_solving` on both sides, with static pruning off, the
  device-first funnel on and the host escalation ladder off
  (`_sprint_cap_s` returns -1.0, as in tests/test_torch_explore.py),
  since the port defers every device survivor. The round-5 contracts run
  under each package's enumeration-only solver (tests/test_torch_explore.py
  `enum_only_solver`): the plain SLS on their 256-bit flip queries costs
  about 50 s on the CPU here. The other corpora run the real solver.

What is held, and how exactly:

- per contract, `owned` and the issue fingerprints (swc-id, address,
  title, severity, function, description) equal the JAX package's. The
  witnesses' calldata and their `min_gas_used`/`max_gas_used` are not
  compared: the two SLS streams differ (a counter hash here, threefry
  there), so the bytes after a solved selector differ;
- every port witness replays: its transaction sequence, run through the
  port's concrete interpreter (laser/batch/run.py) on the CPU from the
  initial state it declares, reaches the issue's pc, and an SWC-106 or
  SWC-110 issue halts there (analysis/replay.py);
- `witness_issues` and `evidence_issues` on pinned outcomes (the JAX
  explorer's, and one that exercises every evidence class), fed to both
  packages as plain dicts, give exactly equal `as_dict`s (an `as_dict`
  carries no time field, so nothing is masked);
- `Report` as text, markdown, json and jsonv2 renders equal text on the
  same issues, with jsonv2's `discoveryTime` (a wall time) masked;
- a contract the device does not own is walked on the host with its
  prepass outcome injected: it is `complete: True` with the JAX walk's
  issue fingerprints, and the CLI exits 0 on it; `--device-ownership
  never` walks every contract; a walk that raises leaves its contract
  `complete: False` with the traceback in `error`, and the CLI exits 1;
  a prepass failure raises.

The JAX side is pinned in tests/test_torch_analyze_pinned.json; one test
runs it live on the milestone corpus. Regenerate the pin with

    PYTHONPATH=. python tests/test_torch_analyze.py --pin

and the JAX side of chip_smoke.py's pinned analysis (the 13 vendored
contracts under the enumeration-only solver with the host ladder at a
cap that does not bind, under `deterministic_solving`, from a fresh
solver session, the eight the device does not own walked on the host:
chip_smoke.py VENDORED_LADDER_PIN,
tests/test_torch_analyze_vendored_ladder_pinned.json) with
`--pin-vendored-ladder` (about four minutes).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu_torch.analysis import corpus as port_corpus
from mythril_tpu_torch.analysis import evidence as port_evidence
from mythril_tpu_torch.analysis import prepass as port_prepass
from mythril_tpu_torch.analysis import report as port_report
from mythril_tpu_torch.analysis.replay import replay_sequence, replays_to
from mythril_tpu_torch.ethereum.evmcontract import EVMContract as PortContract
from mythril_tpu_torch.laser.smt.solver import portfolio as port_portfolio

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PINNED = Path(__file__).with_name("test_torch_analyze_pinned.json")

ADDR = port_corpus.DEFAULT_ADDRESS
GATED_KILL = "604260003560f81c14600d57005b33ff"
ALWAYS_ASSERT = "fe00000000"
KILL2TX = (
    "60003560f81c" "8060011460155780600214601b5700"
    "5b3360005500" "5b600054331460255700" "5b33ff"
)
#: corpusgen.degrader_contract(0x5000) (held to the JAX package's below)
DEGRADER = "602060006150003960003560aa14601257005bfe"
#: tests/laser/test_evidence_round5.py's contracts (held to them below)
WRAP_AND_ORIGIN = "6005600035036000553260003514601157005b00"
CALL_TO_CALLDATA = "6000600060006000600160003561fffff100"
STORAGE_ADD = "6000546000350160005500"

WAVES = 8
#: no wall budget: the wave cap alone ends each phase
NO_BUDGET = float("inf")

#: name -> (rows, enumeration-only solver)
CORPORA = {
    "milestone": ([(GATED_KILL, "", "gated_kill"), (ALWAYS_ASSERT, "", "asserts")], False),
    "kill2tx": ([(KILL2TX, "", "kill2tx")], False),
    "degrader": ([(DEGRADER, "", "degrader")], False),
    "round5": ([(WRAP_AND_ORIGIN, "", "wrap_and_origin"),
                (CALL_TO_CALLDATA, "", "call_to_calldata"),
                (STORAGE_ADD, "", "storage_add")], True),
}


def fingerprint(issue):
    return [issue["swc-id"], issue["address"], issue["title"], issue["severity"],
            issue["function"], issue["description"]]


def summarize(results):
    """[name, owned, sorted issue fingerprints] per contract."""
    return [[r["name"], bool(r.get("owned")), sorted(fingerprint(i) for i in r["issues"])]
            for r in results]


def enum_only_solver(pf, **kw):
    from test_torch_explore import enum_only_solver as make

    return make(pf, **kw)


@pytest.fixture(scope="module", autouse=True)
def ladder_off():
    """The port's host ladder off, deterministic solving on and static
    pruning off for the module, as the pins were made (the walk's
    queries then race nothing); specialization and blockjit off, as on
    the JAX side of the pins (the suite's conftest turns them off
    there)."""
    from mythril_tpu_torch.support.support_args import args

    names = ("sprint_cap_s", "deterministic_solving", "static_prune", "specialize",
             "blockjit")
    saved = [getattr(args, name) for name in names]
    for name, value in zip(names, (0.0, True, False, False, False)):
        setattr(args, name, value)
    yield
    for name, value in zip(names, saved):
        setattr(args, name, value)


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


def port_analyze(name):
    """The port's analyze_corpus on CORPORA[name], on the single-CPU
    schedule (prepass first) that the JAX pin was taken on."""
    rows, enum = CORPORA[name]
    saved = port_portfolio.device_solve_batch, port_corpus._effective_cpus
    if enum:
        port_portfolio.device_solve_batch = enum_only_solver(port_portfolio, device="cpu")
    port_corpus._effective_cpus = lambda: 1
    try:
        return port_corpus.analyze_corpus(
            rows, transaction_count=2, execution_timeout=30, waves=WAVES,
            device_budget_s=NO_BUDGET, device="cpu")
    finally:
        port_portfolio.device_solve_batch, port_corpus._effective_cpus = saved


@pytest.fixture(scope="module")
def port_results():
    return {name: port_analyze(name) for name in CORPORA}


@pytest.mark.parametrize("name", CORPORA)
def test_analyze_corpus_equals_the_jax_package(name, port_results, pinned):
    assert summarize(port_results[name]) == pinned["analyze"][name]


def test_milestone_reports_swc106_and_swc110(port_results):
    gated, asserts = port_results["milestone"]
    assert gated["owned"] and asserts["owned"]
    assert [(i["swc-id"], i["address"], i["title"], i["severity"], i["function"])
            for i in gated["issues"]] == [
        ("106", 15, "Unprotected Selfdestruct", "High", "fallback")]
    assert [(i["swc-id"], i["address"], i["title"], i["severity"])
            for i in asserts["issues"]] == [("110", 0, "Exception State", "Medium")]


@pytest.mark.parametrize("name", CORPORA)
def test_every_witness_replays_to_its_pc(name, port_results):
    for result in port_results[name]:
        for issue in result["issues"]:
            got = replay_sequence(issue["tx_sequence"], issue["address"], device="cpu")
            assert replays_to(issue, device="cpu"), (result["name"], fingerprint(issue), got)


def test_unowned_contract_is_reported_not_analyzed(port_results, pinned):
    """The contract the device does not own (every lane degrades) is now
    analyzed by the host walk, with the JAX walk's issues."""
    (result,) = port_results["degrader"]
    assert summarize([result]) == pinned["analyze"]["degrader"]
    assert result["complete"] is True and result["owned"] is False
    assert result["error"] is None and result["device_complete"] is False
    assert result["states"] > 0 and result["issues"]
    assert result["device_prepass"]["scope"] == "corpus"


def test_inputs_are_the_jax_suites_contracts():
    import importlib.util

    from mythril_tpu.analysis import corpusgen

    assert DEGRADER == corpusgen.degrader_contract(0x5000)
    path = Path(__file__).parent / "laser" / "test_evidence_round5.py"
    spec = importlib.util.spec_from_file_location("test_evidence_round5", path)
    round5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(round5)
    assert (WRAP_AND_ORIGIN, CALL_TO_CALLDATA, STORAGE_ADD) == (
        round5.WRAP_AND_ORIGIN, round5.CALL_TO_CALLDATA, round5.STORAGE_ADD)


def test_prepass_failure_raises(monkeypatch):
    from mythril_tpu_torch.laser.batch import explore
    from mythril_tpu_torch.support.resilience import DegradationLog

    def fail(self):
        raise RuntimeError("wave fault")

    monkeypatch.setattr(explore.DeviceCorpusExplorer, "run", fail)
    marker = DegradationLog().marker()
    with pytest.raises(RuntimeError, match="wave fault"):
        port_corpus.analyze_corpus([(GATED_KILL, "", "g")], device="cpu")
    assert DegradationLog().counts_since(marker) == {"prepass-failed": 1}


def test_expired_deadline_marks_contracts_skipped():
    from mythril_tpu_torch.support.resilience import DegradationLog

    marker = DegradationLog().marker()
    results = port_corpus.analyze_corpus(
        [(GATED_KILL, "", "g"), (DEGRADER, "", "d")], deadline_s=0.0, device="cpu")
    assert [(r["name"], r["skipped"], r["complete"], r["issues"]) for r in results] == [
        ("g", "deadline-expired", False, []), ("d", "deadline-expired", False, [])]
    assert DegradationLog().counts_since(marker)["contract-skipped"] == 2


def test_unported_options_raise(monkeypatch):
    """The multi-chip scheduler and the pooled walk raise;
    `--device-ownership never` walks every contract, the owned ones too,
    with their device outcome injected."""
    from mythril_tpu_torch.support.support_args import args

    rows = [(GATED_KILL, "", "g")]
    with pytest.raises(NotImplementedError, match="multi-chip"):
        port_corpus.analyze_corpus(rows, devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="pooled"):
        port_corpus.analyze_corpus(rows, processes=2, device="cpu")
    monkeypatch.setattr(args, "device_ownership", "never")
    (result,) = port_corpus.analyze_corpus(
        rows, transaction_count=2, execution_timeout=30, waves=WAVES,
        device_budget_s=NO_BUDGET, device="cpu")
    assert result["owned"] is False and result["complete"] is True
    assert result["device_complete"] is True and result["states"] > 0
    assert [(i["swc-id"], i["address"], i["title"]) for i in result["issues"]] == [
        ("106", 15, "Unprotected Selfdestruct")]


# ---------------------------------------------------------------------------
# synthesis and the report on the same inputs
# ---------------------------------------------------------------------------

#: one outcome that exercises every evidence class and both filters
#: (an assert-violation at a byte that is not 0xfe, a witness past the
#: replay gas limit)
SYNTHETIC = {
    "code": "60016002016000556000fe00" + "f1" * 4,
    "outcome": {
        "triggers": {
            "assert-violation": [
                {"pc": 10, "input": "aabbccdd" + "00" * 32, "prefix": ["01"],
                 "gas_min": 50, "gas_max": 60, "call_value": 5, "prefix_values": [7],
                 "initial_storage": {"0x0": "0xff"}, "initial_balance": 10**18},
                {"pc": 2, "input": "00", "gas_min": 1, "gas_max": 2},
                {"pc": 10, "input": "11", "gas_min": 0x7D001, "gas_max": 0x7D001},
            ],
            "selfdestruct": [{"pc": 11, "input": "a9059cbb" + "00" * 64, "gas_min": 3,
                              "gas_max": 4}],
        },
        "evidence": [
            {"class": "wrap", "pc": 4, "op": "subtraction", "input": "05"},
            {"class": "wrap", "pc": 4, "op": "addition", "input": "06", "gas_min": 9},
            {"class": "call", "kind": "CALL", "pc": 12, "input": "07", "unchecked": True,
             "value_to_attacker": True, "to_attacker": True, "gas": 5000,
             "w_unchecked": {"input": "08", "pc": 12},
             "w_profit": {"input": "09", "call_value": 3}},
            {"class": "call", "kind": "DELEGATECALL", "pc": 13, "input": "0a",
             "to_attacker": True, "attacker_gas": 2301},
            {"class": "call", "kind": "CALL", "pc": 14, "input": "0b", "to_attacker": True,
             "attacker_gas": 2300},
            {"class": "state_acc", "access": "SLOAD", "pc": 6, "input": "0c"},
            {"class": "state_acc", "access": "SSTORE", "pc": 7, "input": "0d",
             "gas_min": 0x7D001},
            {"class": "env", "swc": "115", "pc": 8, "input": "0e"},
            {"class": "env", "swc": "116", "operation": "block.timestamp", "pc": 9,
             "input": "0f"},
        ],
    },
}


def synthesis_inputs(pinned):
    """[(label, runtime hex, outcome)]: the JAX explorer's outcomes of
    every pinned corpus, and SYNTHETIC."""
    out = [("synthetic", SYNTHETIC["code"], SYNTHETIC["outcome"])]
    for name, (rows, _) in CORPORA.items():
        for (code, _, cname), outcome in zip(rows, pinned["outcomes"][name]):
            out.append((f"{name}/{cname}", code, outcome))
    return out


def _both(code, name="C"):
    from mythril_tpu.ethereum.evmcontract import EVMContract as JaxContract

    return PortContract(code=code, name=name), JaxContract(code=code, name=name)


def test_synthesis_equals_the_jax_package(pinned):
    from mythril_tpu.analysis import evidence as jax_evidence
    from mythril_tpu.analysis import prepass as jax_prepass

    checked = 0
    for label, code, outcome in synthesis_inputs(pinned):
        port_c, jax_c = _both(code)
        for port_fn, jax_fn in ((port_prepass.witness_issues, jax_prepass.witness_issues),
                                (port_evidence.evidence_issues, jax_evidence.evidence_issues)):
            got = [i.as_dict for i in port_fn(port_c, json.loads(json.dumps(outcome)), ADDR)]
            want = [i.as_dict for i in jax_fn(jax_c, json.loads(json.dumps(outcome)), ADDR)]
            assert got == want, (label, port_fn.__name__)
            checked += len(got)
    assert checked >= 20


def test_synthetic_outcome_yields_every_class():
    port_c, _ = _both(SYNTHETIC["code"])
    issues = port_prepass.witness_issues(port_c, SYNTHETIC["outcome"], ADDR)
    assert sorted({i.swc_id for i in issues}) == [
        "101", "104", "105", "106", "107", "110", "112", "115", "116"]
    assert [i.address for i in issues if i.swc_id == "110"] == [10]


def _reports(pinned, forms):
    from mythril_tpu.analysis import prepass as jax_prepass
    from mythril_tpu.analysis.report import Report as JaxReport

    out = {}
    for side, fn, report_cls in (
            ("port", port_prepass.witness_issues, port_report.Report),
            ("jax", jax_prepass.witness_issues, JaxReport)):
        contracts, issues = [], []
        for label, code, outcome in synthesis_inputs(pinned):
            contract = _both(code, label)[side == "jax"]
            contracts.append(contract)
            issues += fn(contract, json.loads(json.dumps(outcome)), ADDR)
        report = report_cls(contracts=contracts)
        for issue in issues:
            issue.add_code_info(contracts[0])
            report.append_issue(issue)
        out[side] = {form: getattr(report, form)() for form in forms}
    return out


def _mask_times(jsonv2: str):
    doc = json.loads(jsonv2)
    for issue in doc[0]["issues"]:
        issue["extra"]["discoveryTime"] = None
    return doc


def test_report_forms_equal_the_jax_package(pinned):
    forms = ("as_text", "as_markdown", "as_json", "as_swc_standard_format")
    got = _reports(pinned, forms)
    for form in forms[:3]:
        assert got["port"][form] == got["jax"][form], form
    assert _mask_times(got["port"][forms[3]]) == _mask_times(got["jax"][forms[3]])
    assert "==== Unprotected Selfdestruct ====" in got["port"]["as_text"]


def test_remediation_strings_are_the_jax_modules():
    from mythril_tpu.analysis.module.modules import (
        delegatecall, dependence_on_origin, dependence_on_predictable_vars, ether_thief,
        exceptions, external_calls, integer, state_change_external_calls, unchecked_retval)
    from mythril_tpu_torch.analysis.module import remediation as r

    assert r.EXCEPTIONS_REMEDIATION == exceptions.REMEDIATION
    assert r.INTEGER_REMEDIATION == integer.REMEDIATION
    assert r.DELEGATECALL_REMEDIATION == delegatecall.REMEDIATION
    assert r.ORIGIN_REMEDIATION == dependence_on_origin.REMEDIATION
    assert r.PREDICTABLE_VARS_REMEDIATION == dependence_on_predictable_vars.REMEDIATION
    assert r.UNCHECKED_RETVAL_REMEDIATION == unchecked_retval.REMEDIATION
    assert r.EXTERNAL_CALLS_REMEDIATION == external_calls.REMEDIATION
    assert r.ETHER_THIEF_REMEDIATION == ether_thief.REMEDIATION
    assert (r.STATE_CHANGE_DESCRIPTION_TAIL_TEMPLATE
            == state_change_external_calls.DESCRIPTION_TAIL_TEMPLATE)


def test_disassembly_names_functions_as_the_jax_package():
    """Over the 13 vendored contracts: the instruction list, the
    dispatcher's selectors and their names (from each package's seeded
    signature table) and the code hash are the JAX package's."""
    from mythril_tpu.analysis import swc_data as jax_swc
    from mythril_tpu_torch.analysis import swc_data as port_swc
    from mythril_tpu_torch.laser import symbolic_wave

    assert port_swc.SWC_TO_TITLE == jax_swc.SWC_TO_TITLE
    named = 0
    for path in sorted(symbolic_wave.CONTRACTS.glob("*.sol.o")):
        port_c, jax_c = _both(path.read_text().strip())
        p, j = port_c.disassembly, jax_c.disassembly
        assert [i.to_dict() for i in p.instruction_list] == [
            i.to_dict() for i in j.instruction_list], path.name
        assert p.func_hashes == j.func_hashes and p.function_hash_to_name == j.function_hash_to_name
        assert port_c.bytecode_hash == jax_c.bytecode_hash
        named += sum(not n.startswith("_function_") for n in p.function_hash_to_name.values())
    assert named > 0


def test_live_jax_analyze_matches_the_pin(pinned, monkeypatch):
    """The pin is what the JAX package's analyze_corpus gives now (the
    milestone corpus, live)."""
    results, _ = jax_analyze("milestone", monkeypatch.setattr)
    assert summarize(results) == pinned["analyze"]["milestone"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_reports_swc106_at_address_15():
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "--bin-runtime", "-c",
         GATED_KILL, "-t", "2", "-o", "json", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["success"] and "partial" not in doc
    assert [(i["swc-id"], i["address"], i["title"], i["severity"], i["function"])
            for i in doc["issues"]] == [
        ("106", 15, "Unprotected Selfdestruct", "High", "fallback")]


def test_cli_exits_1_on_a_contract_it_does_not_own(tmp_path, capsys, monkeypatch):
    """A contract the device does not own is walked: the report holds
    its issues and the command exits 0. Only a walk that raises leaves a
    contract unanalyzed, and then the command exits 1."""
    from mythril_tpu_torch.analysis import symbolic as port_symbolic
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args

    for flag in ("static_prune", "static_answer", "specialize", "blockjit"):  # the CLI sets them
        monkeypatch.setattr(args, flag, getattr(args, flag))
    a, b = tmp_path / "assert.hex", tmp_path / "degrader.hex"
    a.write_text(ALWAYS_ASSERT + "\n")
    b.write_text(DEGRADER + "\n")
    rc = cli.main(["analyze", "--bin-runtime", "-f", str(a), "-f", str(b), "-o", "text",
                   "--device", "cpu", "--deterministic-solving"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert out.count("==== Exception State ====") == 2
    assert "not analyzed" not in out + err and "not ported" not in out + err
    rc = cli.main(["analyze", "--bin-runtime", "-c", DEGRADER, "-o", "jsonv2",
                   "--device", "cpu", "--deterministic-solving"])
    out, _ = capsys.readouterr()
    assert rc == 0
    (doc,) = json.loads(out)
    assert [i["swcID"] for i in doc["issues"]] == ["SWC-110"]
    assert "partial" not in doc["meta"]

    def fault(self, *a, **kw):
        raise RuntimeError("walk fault")

    monkeypatch.setattr(port_symbolic.SymExecWrapper, "__init__", fault)
    rc = cli.main(["analyze", "--bin-runtime", "-c", DEGRADER, "-o", "jsonv2",
                   "--device", "cpu", "--deterministic-solving"])
    out, err = capsys.readouterr()
    assert rc == 1
    (doc,) = json.loads(out)
    assert doc["meta"]["partial"] is True
    # the analyzer facade's per-contract status (a lone contract has no
    # corpus prepass, so no device_complete; the facade owns nothing)
    assert doc["meta"]["degradation"]["contracts"] == [
        {"contract": "MAIN", "complete": False}]
    assert "walk fault" in doc["meta"]["logs"][0]["msg"] and "walk fault" in err


def test_ladder_escape_searches_where_the_analysis_runs(monkeypatch):
    """analyze_corpus(device="cpu") with --parallel-solving and the host
    ladder on, the CDCL leaving every query unknown: each flip query the
    ladder takes goes to the escape, which searches on the CPU (the plain
    portfolio), never on the card, and the analysis ends."""
    from mythril_tpu_torch.laser.smt.solver import native_sat
    from mythril_tpu_torch.laser.smt.solver import solver as port_solver
    from mythril_tpu_torch.support import model as port_model
    from mythril_tpu_torch.support.support_args import args

    seen = []
    real = port_portfolio.device_check

    def recording(lowered, **kw):
        seen.append(torch.device(kw["device"]).type)
        return real(lowered, **kw)

    monkeypatch.setattr(args, "sprint_cap_s", 120.0)
    monkeypatch.setattr(args, "parallel_solving", True)
    monkeypatch.setattr(native_sat.SolverSession, "solve",
                        lambda self, *a, **kw: (native_sat.UNKNOWN, None))
    monkeypatch.setattr(port_portfolio, "device_check", recording)
    monkeypatch.setattr(port_portfolio, "device_solve_batch",
                        enum_only_solver(port_portfolio, device="cpu"))
    port_model.clear_cache()
    try:
        (result,) = port_corpus.analyze_corpus(
            [(WRAP_AND_ORIGIN, "", "wrap_and_origin")], transaction_count=2,
            execution_timeout=30, waves=WAVES, device_budget_s=NO_BUDGET, device="cpu")
    finally:
        port_model.clear_cache()
        port_solver.reset_blast_session()
    assert seen and set(seen) == {"cpu"}
    assert result["name"] == "wrap_and_origin" and "device_prepass" in result
    assert result["error"] is None, result["error"]


def test_cli_refuses_creation_bytecode(capsys):
    from mythril_tpu_torch.interfaces import cli

    with pytest.raises(SystemExit) as exit_:
        cli.main(["analyze", "-c", GATED_KILL, "-o", "json", "--device", "cpu"])
    assert exit_.value.code == 2
    assert "--bin-runtime" in json.loads(capsys.readouterr().out)["error"]


# ---------------------------------------------------------------------------
# the JAX side (live in one test; the rest from the pin)
# ---------------------------------------------------------------------------


def jax_analyze(name, setattr_):
    """The JAX package's analyze_corpus on CORPORA[name] at the port's
    geometry: its explorer capped at WAVES waves a phase with no wall
    budget, its single-process path, and its prepass outcomes recorded.
    Returns (results, outcomes by contract)."""
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from test_torch_explore import _jax_setup

    jax_explore = _jax_setup(setattr_)
    base = jax_explore.DeviceCorpusExplorer

    class Capped(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, waves=WAVES, budget_s=None))

    setattr_(jax_explore, "DeviceCorpusExplorer", Capped)
    setattr_(jax_corpus, "_effective_cpus", lambda: 1)
    rows, enum = CORPORA[name]
    if enum:
        setattr_(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
    seen = {}
    prepass = jax_corpus.corpus_device_prepass

    def recording(*a, **kw):
        seen.update(prepass(*a, **kw))
        return seen

    setattr_(jax_corpus, "corpus_device_prepass", recording)
    results = jax_corpus.analyze_corpus(
        rows, transaction_count=2, execution_timeout=30, use_device=True, processes=1,
        store=False, router=False, deterministic_solving=True)
    outcomes = [{"triggers": seen[i]["triggers"], "evidence": seen[i]["evidence"]}
                for i in range(len(rows))]
    return results, outcomes


def pin() -> None:
    import conftest  # noqa: F401  (the suite's JAX settings: 8 CPU devices, flags)

    doc = {"analyze": {}, "outcomes": {}}
    for name in CORPORA:
        with pytest.MonkeyPatch.context() as mp:
            results, outcomes = jax_analyze(name, mp.setattr)
        doc["analyze"][name] = summarize(results)
        doc["outcomes"][name] = json.loads(json.dumps(outcomes))
        print(name, doc["analyze"][name])
    PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}")


def pin_vendored_ladder() -> None:
    """The JAX side of chip_smoke.py's pinned ladder-on analysis: the 13
    vendored contracts through the JAX package's analyze_corpus, single
    process (corpus_device_prepass at the small-corpus geometry, capped
    at VENDORED_WAVES waves a phase with no wall budget, then
    `_outcome_owns` and `_owned_result`; every other contract through
    its host walk, `_analyze_one`, with its outcome injected, and
    `_merge_prepass_witnesses`), with the explorer's host ladder at
    VENDORED_LADDER_CAP_S (it does not bind), `deterministic_solving`
    on, a fresh solver session and memo cache, and the enumeration-only
    device solver (the JAX device SLS at this geometry had not finished
    after 40 CPU minutes); written to chip_smoke.py's VENDORED_LADDER_PIN
    with the run's host_sat. Static pruning and the static-answer triage
    are on, the JAX package's defaults (`_static_triage` first, its
    answered rows kept out of the prepass, as its analyze_corpus does),
    and so are kernel specialization and blockjit (the explorer's waves
    run the corpus's specialized bucket); the pin records the explorer's
    static counters and its specialization bucket's."""
    import time

    import conftest  # noqa: F401
    from chip_smoke import VENDORED_LADDER_CAP_S, VENDORED_LADDER_PIN, VENDORED_WAVES
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.laser.smt.solver import solver as jax_solver
    from mythril_tpu.support import model as jax_model
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.laser import symbolic_wave
    from test_torch_explore import _jax_setup

    paths = sorted(symbolic_wave.CONTRACTS.glob("*.sol.o"))
    rows = [(p.read_text().strip(), "", p.name) for p in paths]
    t0 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        jax_explore = _jax_setup(mp.setattr)
        mp.setattr(jax_explore.DeviceCorpusExplorer, "_sprint_cap_s",
                   lambda self: VENDORED_LADDER_CAP_S)
        mp.setattr(jax_args, "deterministic_solving", True)
        # the JAX defaults (the suite's conftest turns the answer tier,
        # specialization and blockjit off)
        for flag in ("static_prune", "static_answer", "specialize", "blockjit"):
            mp.setattr(jax_args, flag, True)
        jax_solver.reset_blast_session()
        jax_model.clear_cache()
        base = jax_explore.DeviceCorpusExplorer

        class Capped(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **dict(kw, waves=VENDORED_WAVES, budget_s=None))

        mp.setattr(jax_explore, "DeviceCorpusExplorer", Capped)
        mp.setattr(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
        answers = jax_corpus._static_triage(rows)
        prepass_rows = [("", c, n) if i in answers else (code, c, n)
                        for i, (code, c, n) in enumerate(rows)]
        outcomes = jax_corpus.corpus_device_prepass(
            prepass_rows, address=ADDR, transaction_count=2, execution_timeout=86400,
            ownership=True)
        wall = time.perf_counter() - t0
        contracts = []
        for i, (code, _, name) in enumerate(rows):
            owned = jax_corpus._outcome_owns(outcomes.get(i))
            if i in answers:
                res = answers[i]
            elif owned:
                res = jax_corpus._owned_result(code, "", name, outcomes[i], ADDR)
            else:
                t1 = time.perf_counter()
                res = jax_corpus._analyze_one((
                    code, "", name, ADDR, "bfs", 2, 86400, 10, 128, 3, None, None,
                    False, outcomes.get(i), True))
                assert res["error"] is None, res["error"]
                jax_corpus._merge_prepass_witnesses([res], [rows[i]], {0: outcomes[i]}, ADDR)
                print(f"{name}: walked in {time.perf_counter() - t1:.1f} s")
            fps = sorted(fingerprint(issue) for issue in res["issues"])
            contracts.append([name, owned, fps])
            print(name, owned, [fp[:2] for fp in fps])
    stats = next((o.get("device_prepass") or o.get("stats") for o in outcomes.values()
                  if isinstance(o, dict) and (o.get("device_prepass") or o.get("stats"))), {})
    doc = {"settings": {"waves": VENDORED_WAVES, "lanes_per_contract": 32,
                        "transaction_count": 2, "ladder": "on",
                        "sprint_cap_s": VENDORED_LADDER_CAP_S,
                        "deterministic_solving": True, "budget_s": None,
                        "solver": "enumeration only", "host_walk": "bfs, JAX defaults",
                        "static_prune": True, "static_answer": True,
                        "specialize": True, "blockjit": True},
           "host_sat": stats.get("host_sat"),
           "static": {k: stats.get(k) for k in ("static_summaries", "static_pruned_flips",
                                                "static_seeds_dropped")},
           "specialized": {k: stats.get(k) for k in ("specialized", "spec_pruned_phases",
                                                     "blockjit_fallbacks")},
           "static_answered": sorted(rows[i][2] for i in answers),
           "contracts": contracts}
    VENDORED_LADDER_PIN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {VENDORED_LADDER_PIN} ({wall:.1f} s of prepass, host_sat "
          f"{doc['host_sat']})")


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).parent), str(ROOT)]
    modes = {"--pin": pin, "--pin-vendored-ladder": pin_vendored_ladder}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        modes[sys.argv[1]]()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_analyze.py "
                 "--pin | --pin-vendored-ladder")
