"""The port's analyzer facade against the JAX package's.

`mythril_tpu_torch.mythril` (`MythrilDisassembler`, `MythrilAnalyzer`)
runs here on the CPU (`device="cpu"`) and is held to the JAX facade's
`MythrilAnalyzer.fire_lasers`, pinned in tests/test_torch_facade_pinned.json:

- one contract at a time (`33ff`, SWC-106; `600035600757005bfe`,
  SWC-110; origin.sol.o, a vendored contract the device does not own):
  SymExecWrapper's own device prepass, then the walk;
- the two-contract corpus (`33ff` and `600035600757005bfe`): the
  overlapped corpus prepass (analysis/corpus.py `OverlappedPrepass`) on a
  thread beside the walks, then the witness merge;
- the same corpus with the prepass drained before the first walk, so
  that every walk gets the final outcome with the device on.

Both sides run the JAX suite's facade setup (tests/mythril/test_facade.py:
`use_onchain_data=False`, address 0x11..11, 60 s walks, depth 64, loop
bound 3, one transaction, `device_prepass` "always" on the JAX side,
which is what the port's "auto" does on its device) with deterministic
solving, static pruning on, specialization, blockjit and the pipelined
schedule off. The issue sets are compared per contract by (swc-id,
address, title, severity, function).

The rest are the port's switches and departures, on the CPU with stubs
where the card would be needed: a failing prepass thread re-raised by
`finish` after its PREPASS_FAILED record, `finish` idempotent,
`yield_lock` sleeping only while a flip burst waits, `--device-solving
never` starting no race, `--deadline`/`--on-timeout`, the actor
overrides, every refused flag and subcommand naming its module, and
`disassemble`/`function-to-hash` against the JAX command's output.

The pin also holds the JAX facade's results that chip_smoke.py checks
the card against (`chip`: the command line's defaults, two transactions,
on-chain data on with no chain client). Regenerate it with

    PYTHONPATH=. python tests/test_torch_facade.py --pin-facade

(the JAX facade on the CPU, a few minutes).
"""

import contextlib
import io
import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu_torch.analysis import corpus as port_corpus
from mythril_tpu_torch.interfaces import cli
from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
from mythril_tpu_torch.mythril import mythril_analyzer as port_analyzer
from mythril_tpu_torch.support import resilience
from mythril_tpu_torch.support.support_args import args

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PINNED = Path(__file__).with_name("test_torch_facade_pinned.json")
VENDORED = ROOT / "tests" / "testdata" / "vendored" / "inputs"

KILL = "33ff"
ASSERT = "600035600757005bfe"
UNOWNED = "origin.sol.o"
#: single-contract cases: label -> runtime hex
SINGLE = {"kill": KILL, "assert": ASSERT, "origin": None}
#: the facade setup of tests/mythril/test_facade.py, on both sides
FACADE = dict(strategy="bfs", use_onchain_data=False, address="0x" + "11" * 20,
              execution_timeout=60, create_timeout=10, max_depth=64, loop_bound=3,
              deterministic_solving=True, static_prune=True, specialize=False,
              blockjit=False, pipeline=False)
TXS = 1

#: chip_smoke.py's facade checks: the command line's defaults
GATED_KILL = "604260003560f81c14600d57005b33ff"
ALWAYS_ASSERT = "fe00000000"
CLEAN = ("600035" "60e01c" "80" "63c0ffee00" "14" "601a" "57" "630ddba110" "14"
         "6024" "57" "00" "5b" "6001" "6002" "01" "6000" "55" "00"
         "5b" "602a" "6000" "52" "6020" "6000" "f3")
CLI_DEFAULTS = dict(strategy="bfs", use_onchain_data=True, max_depth=128,
                    execution_timeout=86400, loop_bound=3, create_timeout=10,
                    solver_timeout=10000, static_prune=True, specialize=False,
                    blockjit=False, pipeline=False)
#: CALLDATALOAD, MSTORE, SHA3, SSTORE, then CALLER SELFDESTRUCT: the
#: corpus's one contract whose waves run SHA3 (chip_smoke.py's HASHKILL)
HASHKILL = "6000356000526020600020600055" "33ff"
CHIP_CORPUS = (("gated_kill", GATED_KILL), ("always_assert", ALWAYS_ASSERT),
               ("clean", CLEAN), ("hashkill", HASHKILL))
DISASSEMBLED = "suicide.sol.o"
SIGNATURE = "transfer(address,uint256)"
#: the flags the pinned runs set in the port's flag bag (restored after)
FLAG_NAMES = ("device_prepass", "device_solving", "device_prepass_budget",
              "device_prepass_lanes",
              "device_ownership", "deterministic_solving", "static_prune", "pipeline",
              "specialize", "blockjit", "parallel_solving", "call_depth_limit", "iprof",
              "solver_timeout", "sprint_cap_s", "static_answer", "run_deadline_s",
              "on_timeout")


def code_of(label):
    return SINGLE[label] or (VENDORED / UNOWNED).read_text().strip()


def fingerprints(report):
    """{contract: sorted [swc-id, address, title, severity, function]}."""
    out = {}
    for issue in json.loads(report.as_json())["issues"]:
        out.setdefault(issue["contract"], []).append(
            [issue["swc-id"], issue["address"], issue["title"], issue["severity"],
             issue["function"]])
    return {name: sorted(rows) for name, rows in out.items()}


@pytest.fixture(autouse=True)
def flag_bag():
    """Each test leaves the port's flag bag, the actors and the run
    deadline as it found them."""
    from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS

    saved = {name: getattr(args, name) for name in FLAG_NAMES}
    actors = dict(ACTORS.addresses)
    yield
    for name, value in saved.items():
        setattr(args, name, value)
    ACTORS.addresses.clear()
    ACTORS.addresses.update(actors)
    resilience.clear_run_deadline()


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


def port_facade(codes, drained=False, monkeypatch=None):
    disassembler = MythrilDisassembler()
    for code in codes:
        disassembler.load_from_bytecode(code, bin_runtime=True)
    analyzer = MythrilAnalyzer(disassembler, device="cpu", **FACADE)
    if drained:
        start = MythrilAnalyzer._corpus_prepass

        def drain_first(self, transaction_count):
            pre = start(self, transaction_count)
            pre.drain()
            return pre

        monkeypatch.setattr(MythrilAnalyzer, "_corpus_prepass", drain_first)
    return analyzer.fire_lasers(transaction_count=TXS)


# ---------------------------------------------------------------------------
# parity with the JAX facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(SINGLE))
def test_single_contract_equals_the_jax_facade(label, pinned):
    report = port_facade([code_of(label)])
    assert fingerprints(report) == pinned["single"][label]
    assert not report.partial and not report.exceptions


@pytest.mark.parametrize("drained", [False, True], ids=["overlapped", "drained"])
def test_two_contract_corpus_equals_the_jax_facade(drained, pinned, monkeypatch):
    seen = []
    real = port_corpus.OverlappedPrepass.__init__

    def recording(self, *a, **kw):
        seen.append(kw.get("device"))
        real(self, *a, **kw)

    monkeypatch.setattr(port_corpus.OverlappedPrepass, "__init__", recording)
    report = port_facade([KILL, ASSERT], drained=drained, monkeypatch=monkeypatch)
    got = fingerprints(report)
    assert got == pinned["corpus" if not drained else "drained"]
    assert {row[0] for rows in got.values() for row in rows} == {"106", "110"}
    assert [torch.device(d).type for d in seen] == ["cpu"]
    assert not report.partial and not report.exceptions


# ---------------------------------------------------------------------------
# the overlapped prepass: its departures
# ---------------------------------------------------------------------------


def test_finish_reraises_the_prepass_exception_after_a_record(monkeypatch):
    from mythril_tpu_torch.laser.batch import explore

    def fault(self):
        raise RuntimeError("wave fault")

    monkeypatch.setattr(explore.DeviceCorpusExplorer, "run", fault)
    mark = resilience.DegradationLog().marker()
    pre = port_corpus.OverlappedPrepass([(ASSERT, "", "a"), (GATED_KILL, "", "g")],
                                        0x1111, 1, device="cpu")
    with pytest.raises(RuntimeError, match="wave fault"):
        pre.finish()
    assert resilience.DegradationLog().counts_since(mark) == {"prepass-failed": 1}
    # a walk asking for its outcome after the failure raises too: no
    # contract is walked without the card
    with pytest.raises(RuntimeError, match="wave fault"):
        pre.outcome_for(0)


def test_a_failing_prepass_fails_the_analysis(monkeypatch, capsys, tmp_path):
    from mythril_tpu_torch.laser.batch import explore

    def fault(self):
        raise RuntimeError("wave fault")

    walked = []
    real = port_analyzer.SymExecWrapper

    def recording(*a, **kw):
        walked.append(dict(device_prepass=args.device_prepass,
                           device_solving=args.device_solving))
        return real(*a, **kw)

    monkeypatch.setattr(explore.DeviceCorpusExplorer, "run", fault)
    monkeypatch.setattr(port_analyzer, "SymExecWrapper", recording)
    files = []
    for name, code in (("a", ASSERT), ("g", GATED_KILL)):
        (tmp_path / name).write_text(code + "\n")
        files += ["-f", str(tmp_path / name)]
    with pytest.raises(RuntimeError, match="wave fault"):
        cli.main(["analyze", "--bin-runtime", *files, "-t", "1", "--device", "cpu",
                  "--no-onchain-data", "--deterministic-solving"])
    # every walk that ran was one beside the live prepass (device off);
    # none ran with the device on after the failure
    assert all(w == dict(device_prepass="never", device_solving="never") for w in walked)


def test_finish_is_idempotent(monkeypatch):
    calls = []

    def prepass(contracts, **kw):
        calls.append(kw)
        return {0: {"device_complete": True}}

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", prepass)
    pre = port_corpus.OverlappedPrepass([(ASSERT, "", "a")], 0x1111, 1, device="cpu")
    first = pre.finish()
    assert pre.finish() is first == {0: {"device_complete": True}}
    assert len(calls) == 1 and calls[0]["host_lock"] is pre.lock
    assert pre.outcome_for(0) == ({"device_complete": True}, True)


def test_yield_lock_sleeps_only_while_a_burst_waits(monkeypatch):
    release = threading.Event()

    def prepass(contracts, **kw):
        release.wait(30)
        return {}

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", prepass)
    pre = port_corpus.OverlappedPrepass([(ASSERT, "", "a")], 0x1111, 1, device="cpu")
    try:
        assert pre.outcome_for(0) == (None, False) and pre.deviceless == 1
        t0 = time.perf_counter()
        pre.yield_lock()
        idle = time.perf_counter() - t0
        pre._lock_wanted.set()
        t0 = time.perf_counter()
        pre.yield_lock()
        waiting = time.perf_counter() - t0
    finally:
        release.set()
        pre.finish()
    assert idle < 0.04 and waiting >= 0.05, (idle, waiting)


def test_published_outcomes_are_whole_under_thread_switches(monkeypatch):
    """The prepass thread publishes while a walk reads: with a tiny
    switch interval, every outcome a reader gets is one the thread
    published whole, and the final outcomes are the last published."""
    def prepass(contracts, publish=None, **kw):
        for wave in range(400):
            for i in range(len(contracts)):
                publish(i, {"wave": wave, "contract": i, "stats": {"waves": wave}})
        return {i: {"wave": 400, "contract": i} for i in range(len(contracts))}

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", prepass)
    rows = [(ASSERT, "", str(i)) for i in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pre = port_corpus.OverlappedPrepass(rows, 0x1111, 1, device="cpu")
        seen, deadline = [], time.monotonic() + 30
        while time.monotonic() < deadline:
            outcome, device_ok = pre.outcome_for(len(seen) % 4)
            if device_ok:
                break
            seen.append((len(seen) % 4, outcome))
        final = pre.finish()
    finally:
        sys.setswitchinterval(switch)
    assert final == {i: {"wave": 400, "contract": i} for i in range(4)}
    for i, outcome in seen:
        assert outcome is None or (outcome["contract"] == i
                                   and outcome["stats"]["waves"] == outcome["wave"])


def test_drain_or_finish_that_times_out_is_recorded(monkeypatch):
    release = threading.Event()

    def prepass(contracts, **kw):
        release.wait(30)
        return {}

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", prepass)
    monkeypatch.setattr(port_corpus, "DRAIN_TIMEOUT_S", 0.05)
    mark = resilience.DegradationLog().marker()
    pre = port_corpus.OverlappedPrepass([(ASSERT, "", "a")], 0x1111, 1, device="cpu")
    try:
        pre.drain()
        assert pre.drain_abandoned
        pre.drain()  # paid once
        assert pre.finish() == {}
    finally:
        release.set()
    assert resilience.DegradationLog().counts_since(mark) == {"prepass-drain-timed-out": 1}


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------


def _unknown_query():
    """A query the CDCL sprint leaves unknown (the session stubbed), with
    two conjuncts, so that the marathon may race."""
    from mythril_tpu_torch.laser.smt import terms as T

    x = T.bv_var("facade_race_x", 8)
    return [T.ult(x, T.bv_const(9, 8)), T.ult(T.bv_const(2, 8), x)]


@pytest.mark.parametrize("mode", ["auto", "never"])
def test_device_solving_never_starts_no_race(mode, monkeypatch):
    from mythril_tpu_torch.laser.smt.solver import device_race, native_sat
    from mythril_tpu_torch.laser.smt.solver import solver as port_solver
    from mythril_tpu_torch.observe import querylog

    started = []

    class Race:
        started = False

        def __init__(self, cone, device=None):
            started.append(device)

    monkeypatch.setattr(device_race, "DeviceRace", Race)
    monkeypatch.setattr(native_sat.SolverSession, "solve",
                        lambda self, *a, **kw: (native_sat.UNKNOWN, None))
    monkeypatch.setattr(args, "deterministic_solving", False)
    monkeypatch.setattr(args, "device_solving", mode)
    mark = querylog.loss_marker()
    try:
        verdict, _ = port_solver.check_terms(_unknown_query(), timeout_ms=300, device="cpu")
    finally:
        port_solver.reset_blast_session()
    assert verdict == "unknown"
    assert len(started) == (0 if mode == "never" else 1)
    if mode == "never":
        assert querylog.loss_reasons(since=mark) == {querylog.LOSS_GATE_DISABLED: 1}


def _stub_walk(monkeypatch, seconds=0.0, seen=None):
    """SymExecWrapper and fire_lasers stubbed: each walk records the flag
    bag and the actors, and takes `seconds`."""
    from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS

    class Sym:
        def __init__(self, contract, address, strategy, **kw):
            if seen is not None:
                seen.append(dict(kw, contract=contract.name, strategy=strategy,
                                 address=address,
                                 attacker=hex(ACTORS.attacker.value),
                                 creator=hex(ACTORS.creator.value),
                                 solver_timeout=args.solver_timeout,
                                 device_solving=args.device_solving,
                                 device_prepass=args.device_prepass,
                                 device_prepass_budget=args.device_prepass_budget))
            time.sleep(seconds)
            self.execution_info = []

    monkeypatch.setattr(port_analyzer, "SymExecWrapper", Sym)
    monkeypatch.setattr(port_analyzer, "fire_lasers", lambda sym, modules=None: [])


def _corpus_files(tmp_path, n=3):
    files = []
    for i, (name, code) in enumerate(CHIP_CORPUS[:n]):
        (tmp_path / name).write_text(code + "\n")
        files += ["-f", str(tmp_path / name)]
    return files


def test_deadline_gives_a_partial_report_and_fail_exits_1(monkeypatch, capsys, tmp_path):
    _stub_walk(monkeypatch, seconds=1.5)
    files = _corpus_files(tmp_path)
    argv = ["analyze", "--bin-runtime", *files, "-o", "json", "--device", "cpu",
            "--device-prepass", "never", "--deadline", "1"]
    assert cli.main(argv) == 0
    doc = json.loads(capsys.readouterr().out)
    status = doc["degradation"]["contracts"]
    assert doc["partial"] is True
    assert [(Path(c["contract"]).name, c["complete"], c.get("skipped")) for c in status] == [
        ("gated_kill", True, None), ("always_assert", False, "deadline-expired"),
        ("clean", False, "deadline-expired")]
    assert doc["degradation"]["reasons"]["contract-skipped"] == 2
    with pytest.raises(SystemExit) as exit_:
        cli.main(argv + ["--on-timeout", "fail"])
    assert exit_.value.code == 1
    assert "Analysis deadline expired" in json.loads(capsys.readouterr().out)["error"]
    assert resilience.run_deadline() is None


def test_cli_passes_the_facade_flags(monkeypatch, capsys):
    seen = []
    _stub_walk(monkeypatch, seen=seen)
    attacker, creator = "0x" + "ab" * 20, "0x" + "cd" * 20
    rc = cli.main(["analyze", "--bin-runtime", "-c", GATED_KILL, "--device", "cpu",
                   "-o", "json", "--attacker-address", attacker, "--creator-address",
                   creator, "--device-solving", "never", "--device-prepass", "never",
                   "--device-prepass-budget", "3.5", "--solver-timeout", "700",
                   "--strategy", "dfs", "--max-depth", "40", "-b", "2",
                   "--no-onchain-data", "--custom-modules-directory", "/nowhere"])
    capsys.readouterr()
    assert rc == 0
    (walk,) = seen
    assert (walk["attacker"], walk["creator"]) == (attacker, creator)
    assert {k: walk[k] for k in ("strategy", "max_depth", "loop_bound", "solver_timeout",
                                 "device_solving", "device_prepass",
                                 "device_prepass_budget", "custom_modules_directory",
                                 "address")} == {
        "strategy": "dfs", "max_depth": 40, "loop_bound": 2, "solver_timeout": 700,
        "device_solving": "never", "device_prepass": "never",
        "device_prepass_budget": 3.5, "custom_modules_directory": "/nowhere",
        "address": "0x" + "0" * 40}
    assert walk["dynloader"].active is False and torch.device(walk["device"]).type == "cpu"
    with pytest.raises(SystemExit) as exit_:
        cli.main(["analyze", "--bin-runtime", "-c", GATED_KILL, "--device", "cpu",
                  "-o", "json", "--attacker-address", "12ab"])
    assert exit_.value.code == 2
    assert json.loads(capsys.readouterr().out)["error"] == "Attacker address is invalid"


def test_corpus_shard_partitions_as_the_jax_package(monkeypatch, capsys, tmp_path):
    from mythril_tpu.analysis.corpus import corpus_shard as jax_shard

    rows = [(code, "", name) for name, code in CHIP_CORPUS] + [(KILL, "", "k")]
    for count in (1, 2, 3):
        for index in range(count):
            assert port_corpus.corpus_shard(rows, index, count) == jax_shard(rows, index, count)
    seen = []
    _stub_walk(monkeypatch, seen=seen)
    files = _corpus_files(tmp_path, n=4)
    for index in range(2):
        assert cli.main(["analyze", "--bin-runtime", *files, "-o", "json", "--device", "cpu",
                         "--device-prepass", "never", "--corpus-shard", f"{index}/2"]) == 0
    capsys.readouterr()
    # the two hosts' shards walk every contract exactly once
    assert sorted(Path(w["contract"]).name for w in seen) == sorted(n for n, _ in CHIP_CORPUS)
    # a host whose shard is empty prints an empty report
    (empty,) = [i for i in range(2) if not port_corpus.corpus_shard([(KILL, "", "MAIN")], i, 2)]
    assert cli.main(["analyze", "--bin-runtime", "-c", KILL, "-o", "json", "--device", "cpu",
                     "--corpus-shard", f"{empty}/2"]) == 0
    assert json.loads(capsys.readouterr().out)["issues"] == [] and len(seen) == 4
    with pytest.raises(SystemExit):
        cli.main(["analyze", "--bin-runtime", "-c", KILL, "-o", "json", "--device", "cpu",
                  "--corpus-shard", "nonsense"])
    assert "--corpus-shard wants I/N" in json.loads(capsys.readouterr().out)["error"]


def test_chain_reads_raise_naming_the_rpc_client():
    from mythril_tpu_torch.support.loader import DynLoader

    with pytest.raises(ValueError, match="RPC client"):
        DynLoader(None, active=True).read_storage("0x" + "11" * 20, 0)
    with pytest.raises(ValueError, match="disabled"):
        DynLoader(None, active=False).read_balance("0x" + "11" * 20)


# the flags and commands the port refuses, and a word of what each needs
REFUSED = [
    (["analyze", "--bin-runtime", "-c", "00", "--devices", "2"], "device mesh"),
    (["analyze", "--bin-runtime", "-c", "00", "--host-first-funnel"], "host-first"),
    (["analyze", "--bin-runtime", "-c", "00", "--sparse-pruning"], "laser/ethereum/svm.py"),
    (["analyze", "--bin-runtime", "-c", "00", "--unconstrained-storage"], "account.py"),
    (["analyze", "--bin-runtime", "-c", "00", "-q"], "4byte"),
    (["analyze", "--bin-runtime", "-c", "00", "--no-static-answer"], "analyze_corpus"),
    (["analyze", "x.sol"], "solc"),
    (["analyze", "--truffle"], "solc"),
    (["analyze", "-a", "0x" + "11" * 20], "RPC client"),
    (["analyze", "--bin-runtime", "-c", "00", "--rpc", "ganache"], "RPC client"),
    (["analyze", "--bin-runtime", "-c", "00", "--infura-id", "k"], "RPC client"),
    (["disassemble", "x.sol"], "solc"),
    (["hash-to-address", "0x12"], "leveldb"),
    (["leveldb-search", "code#PUSH1#"], "leveldb"),
    (["read-storage", "0", "0x" + "11" * 20], "RPC client"),
]


@pytest.mark.parametrize("argv,needs", REFUSED, ids=[" ".join(a[:1] + a[-2:]) for a, _ in REFUSED])
def test_refused_flags_and_commands_name_their_module(argv, needs, capsys):
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert needs in err and ("not ported" in err or "not in the port" in err), err


def test_facade_refuses_what_the_port_lacks():
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(KILL, bin_runtime=True)
    for option, needs in (({"mesh_devices": 2}, "device mesh"),
                          ({"sparse_pruning": True}, "svm.py"),
                          ({"unconstrained_storage": True}, "account.py"),
                          ({"device_first": False}, "host-first")):
        with pytest.raises(NotImplementedError, match=needs):
            MythrilAnalyzer(disassembler, device="cpu", **option)
    for load, needs in ((lambda: disassembler.load_from_address("0x" + "11" * 20), "RPC"),
                        (lambda: disassembler.load_from_solidity(["a.sol"]), "solc"),
                        (lambda: disassembler.get_state_variable_from_storage("0x1"), "RPC"),
                        (lambda: MythrilDisassembler(enable_online_lookup=True), "4byte")):
        with pytest.raises(NotImplementedError, match=needs):
            load()


def test_global_defaults_and_prepass_lanes_are_the_jax_ones(monkeypatch):
    """Every option the JAX facade publishes to the flag bag is published
    with its JAX default or refused (`pipeline` keeps the port's False),
    and `device_prepass_lanes` sizes SymExecWrapper's prepass."""
    from mythril_tpu.mythril import mythril_analyzer as jax_analyzer
    from mythril_tpu_torch.laser.batch import explore

    refused = {field for field, *_ in port_analyzer._REFUSED}
    ported = port_analyzer._GLOBAL_DEFAULTS
    assert set(jax_analyzer._GLOBAL_DEFAULTS) == set(ported) | refused
    assert {k: v for k, v in ported.items() if k != "pipeline"} == {
        k: jax_analyzer._GLOBAL_DEFAULTS[k] for k in ported if k != "pipeline"}

    class Stop(Exception):
        pass

    seen = []

    def explorer(code, lanes=None, **_kw):
        seen.append(lanes)
        raise Stop

    monkeypatch.setattr(explore, "DeviceSymbolicExplorer", explorer)
    disassembler = MythrilDisassembler()
    address, _ = disassembler.load_from_bytecode(GATED_KILL, bin_runtime=True)
    for options, want in (({"device_prepass_lanes": 64}, 64), ({}, 128)):
        analyzer = MythrilAnalyzer(disassembler, device="cpu", device_prepass="always",
                                   address=address, **options)
        assert args.device_prepass_lanes == want
        with pytest.raises(Stop):
            analyzer._symbolically_execute(None, transaction_count=1)
    assert seen == [64, 128]


def _jax_cli(argv):
    """The JAX `myth` command in this process: its stdout."""
    from mythril_tpu.interfaces import cli as jax_cli

    parser = jax_cli.build_parser()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            jax_cli.parse_args_and_execute(parser=parser, args=parser.parse_args(argv))
        except SystemExit:
            pass
    return buf.getvalue()


def _port_cli(argv, capsys):
    assert cli.main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["disassemble", "--bin-runtime", "-f", str(VENDORED / DISASSEMBLED)],
    ["disassemble", "-c", "6001600055"],
    ["function-to-hash", SIGNATURE],
    ["version"],
    ["version", "-o", "json"],
    ["list-detectors", "-o", "json"],
], ids=lambda a: " ".join(a[:2]))
def test_commands_equal_the_jax_output(argv, capsys):
    assert _port_cli(argv, capsys) == _jax_cli(argv)


def test_graph_and_statespace_are_written(tmp_path, capsys, pinned):
    graph, space = tmp_path / "g.html", tmp_path / "s.json"
    base = ["analyze", "--bin-runtime", "-c", GATED_KILL, "--device", "cpu",
            "--no-onchain-data", "--deterministic-solving"]
    assert cli.main(base + ["-g", str(graph), "--phrack"]) == 0
    assert cli.main(base + ["-j", str(space)]) == 0
    html = graph.read_text()
    assert "new vis.Network(" in html and "background: #ffffff" in html  # --phrack
    doc = json.loads(space.read_text())
    assert (len(doc["nodes"]), len(doc["edges"])) == tuple(pinned["statespace_offchain"])


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def jax_facade(codes, settings, transaction_count, names=None, drained=False):
    """The JAX facade's report fingerprints on `codes`, with the device
    prepass forced on (what the port's "auto" does on its device)."""
    from mythril_tpu.mythril import MythrilAnalyzer as JaxAnalyzer
    from mythril_tpu.mythril import MythrilDisassembler as JaxDisassembler
    from mythril_tpu.support.support_args import args as jax_args

    disassembler = JaxDisassembler(eth=None)
    for i, code in enumerate(codes):
        _, contract = disassembler.load_from_bytecode(code, bin_runtime=True)
        if names:
            contract.name = names[i]
    analyzer = JaxAnalyzer(disassembler, **settings)
    jax_args.device_prepass = "always"
    start = JaxAnalyzer._corpus_prepass
    if drained:
        def drain_first(self, tc):
            pre = start(self, tc)
            pre.drain()
            return pre
        JaxAnalyzer._corpus_prepass = drain_first
    try:
        report = analyzer.fire_lasers(transaction_count=transaction_count)
    finally:
        JaxAnalyzer._corpus_prepass = start
    return report, analyzer


def pin_facade() -> None:
    from mythril_tpu.support.support_args import args as jax_args

    jax_args.sprint_cap_s = 5.0
    out = {"settings": dict(FACADE, transaction_count=TXS, device_prepass="always"),
           "single": {}}
    for label in sorted(SINGLE):
        out["single"][label] = fingerprints(jax_facade([code_of(label)], FACADE, TXS)[0])
        print(label, out["single"][label], flush=True)
    out["corpus"] = fingerprints(jax_facade([KILL, ASSERT], FACADE, TXS)[0])
    out["drained"] = fingerprints(jax_facade([KILL, ASSERT], FACADE, TXS, drained=True)[0])
    print("corpus", out["corpus"], "drained", out["drained"], flush=True)
    offchain = dict(FACADE, deterministic_solving=True)
    _, analyzer = jax_facade([GATED_KILL], offchain, TXS)
    space = analyzer.dump_statespace(contract=analyzer.contracts[0])
    out["statespace_offchain"] = [len(space["nodes"]), len(space["edges"])]
    # chip_smoke.py's: the command line's defaults (address 0, on-chain
    # data on with no client, two transactions)
    chip = dict(CLI_DEFAULTS, address="0x" + "0" * 40)
    out["chip_settings"] = dict(chip, transaction_count=2, device_prepass="always")
    out["chip"] = {
        "gated_kill": fingerprints(jax_facade([GATED_KILL], chip, 2)[0]),
        "hashkill": fingerprints(jax_facade([HASHKILL], chip, 2)[0]),
        "corpus": fingerprints(jax_facade([c for _, c in CHIP_CORPUS], chip, 2,
                                          names=[n for n, _ in CHIP_CORPUS])[0]),
        UNOWNED: fingerprints(jax_facade([(VENDORED / UNOWNED).read_text().strip()],
                                         chip, 2)[0]),
    }
    _, analyzer = jax_facade([GATED_KILL], chip, 2)
    space = analyzer.dump_statespace(contract=analyzer.contracts[0])
    out["chip"]["statespace"] = [len(space["nodes"]), len(space["edges"])]
    out["chip"]["disassemble"] = {
        "argv": ["disassemble", "--bin-runtime", "-f",
                 str(Path("tests/testdata/vendored/inputs") / DISASSEMBLED)],
        "stdout": _jax_cli(["disassemble", "--bin-runtime", "-f",
                            str(VENDORED / DISASSEMBLED)])}
    out["chip"]["function_to_hash"] = {
        "signature": SIGNATURE, "stdout": _jax_cli(["function-to-hash", SIGNATURE])}
    print("chip", json.dumps(out["chip"])[:2000], flush=True)
    PINNED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print("pinned", PINNED)


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin-facade"]:
        sys.path.insert(0, str(ROOT))
        pin_facade()
    else:
        raise SystemExit("usage: test_torch_facade.py --pin-facade")
