"""The port's static layer (mythril_tpu_torch/analysis/static) against the
JAX package's, on the CPU.

- `analyze_bytecode` on the same bytecode gives the same summary in
  both packages: blocks, reachability, resolved, unresolved and invalid
  jumps, underflow blocks, dead directions, the dispatcher, dead
  selectors and inert directions, features, applicable and skipped
  modules (semantic and opcode-only), the taint fixpoint and its value
  sets, function fingerprints, the link node, `static_answerable`,
  `findings()` and `lint_dict()`. Only the wall times differ (`wall_ms`,
  the taint's `wall_ms`); the analysis-config fingerprint embeds each
  package's version, so it is compared with the version left out. The
  programs: the 13 vendored contracts, the JAX `corpusgen` contracts,
  the 14 module positive fixtures and the fault suite, and 200 seeded
  programs (random programs with truncated PUSHes, stack underflows and
  computed jumps, and constant mutations of the others);
- the live-wave differential: the port's `DeviceCorpusExplorer` on
  `corpusgen.deadweight_contract(0)` with static pruning on against the
  JAX explorer's run, both under an enumeration-only solver: the static
  counters and every wave's snapshot (seeded calldata, flip targets
  attempted, coverage) are equal. The JAX run is pinned in
  tests/test_torch_static_waves_pinned.json (its XLA compiles would cost
  a test worker about 1 GB); regenerate it with

      PYTHONPATH=. python tests/test_torch_static.py --pin-waves

- the triage: `analyze_corpus` answers `clean_contract(0)` statically
  (`states == 0`, no lanes) with the issues of the tier-off run;
- a static pass that raises is recorded (`static-prepass-failed`) by the
  explorer, SymExecWrapper and the triage, and printed by `analyze`;
- `python -m mythril_tpu_torch lint` prints the JAX `myth lint` rows
  (json and text, but the wall times), with its `--fail-on` exit codes;
  the JAX rows of the 13 vendored contracts are pinned in
  tests/test_torch_static_lint_pinned.json for chip_smoke.py, which
  runs the port's `lint` on them (`--pin-lint`).

The JAX suite's conftest turns the JAX static-answer tier off for the
session; the tests that compare the tier set `static_answer` in both
packages themselves.
"""

import contextlib
import importlib
import io
import json
import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mythril_tpu.analysis import corpusgen
from mythril_tpu_torch.analysis import static as port_static
from mythril_tpu_torch.laser import symbolic_wave

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
LINT_PIN = TESTS / "test_torch_static_lint_pinned.json"
WAVES_PIN = TESTS / "test_torch_static_waves_pinned.json"
VENDORED = sorted(p.stem.replace(".sol", "") for p in symbolic_wave.CONTRACTS.glob("*.sol.o"))
FAULT_SUITE = {
    "KILLABLE": "33ff",
    "WRITER": "6001600055600060015500",
    "BRANCHER": "600035600757005b600160005500",
    "GATED": "60003560f81c604214600d57005b600160005500",
}
#: the JAX corpusgen contracts (name -> runtime hex)
CORPUSGEN = {
    **{f"deadweight_{s}": corpusgen.deadweight_contract(s) for s in range(4)},
    **{f"clean_{s}": corpusgen.clean_contract(s) for s in range(4)},
    "wide": corpusgen.wide_contract(),
    "bec": corpusgen.bec_contract(),
    "fork": corpusgen.fork_contract(),
    "loop": corpusgen.loop_contract(),
    "poison": corpusgen.poison_contract(),
}
SEED = 2026
N_RANDOM = 200
BATCH = 25


def vendored(name: str) -> str:
    return (symbolic_wave.CONTRACTS / f"{name}.sol.o").read_text().strip()


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FIXTURES = _load(TESTS / "analysis" / "test_module_positive_fixtures.py").FIXTURES

# --------------------------------------------------------------------------
# the programs
# --------------------------------------------------------------------------

#: the opcodes random programs draw from: stack and arithmetic, control
#: flow, the sinks the taint pass and the detector screen read
_POOL = (
    [0x01, 0x02, 0x03, 0x04, 0x10, 0x11, 0x14, 0x15, 0x16, 0x17, 0x1B, 0x1C]
    + [0x32, 0x33, 0x34, 0x35, 0x36, 0x3D, 0x42, 0x43, 0x47]
    + [0x50, 0x51, 0x52, 0x54, 0x55, 0x56, 0x57, 0x5B, 0x5B, 0x5B]
    + [0x80, 0x81, 0x82, 0x90, 0x91, 0xA1, 0xF1, 0xF4, 0xFA, 0xFF]
    + [0x00, 0xF3, 0xFD, 0xFE]
)


def random_program(rng: np.random.Generator) -> bytes:
    """A short random program: opcodes from _POOL, PUSH1s of small
    values and of jump targets, computed jumps (two PUSHes added or
    DUPed before a JUMP/JUMPI), stack underflows at the entry, and a
    trailing PUSH whose operand the code cuts short."""
    out = bytearray()
    if rng.random() < 0.25:
        out += bytes([int(rng.choice([0x01, 0x50, 0x56, 0x90]))])  # underflow at pc 0
    for _ in range(int(rng.integers(4, 40))):
        roll = rng.random()
        if roll < 0.25:
            out += bytes([0x60, int(rng.integers(0, 64))])
        elif roll < 0.35:
            # computed jump: target = a + b, or a DUPed constant
            a = int(rng.integers(0, 32))
            b = int(rng.integers(0, 32))
            out += bytes([0x60, a, 0x60, b, 0x01] if rng.random() < 0.5
                         else [0x60, a + b, 0x80, 0x50])
            out += bytes([0x56] if rng.random() < 0.5 else [0x60, 1, 0x90, 0x57])
        elif roll < 0.4:
            out += bytes([0x63]) + bytes(rng.integers(0, 256, 4).tolist())
        else:
            out.append(int(rng.choice(_POOL)))
    if rng.random() < 0.3:
        width = int(rng.integers(2, 33))
        out += bytes([0x5F + width]) + bytes(rng.integers(0, 256, int(rng.integers(0, width))).tolist())
    return bytes(out)


def seeded_programs():
    """N_RANDOM programs from numpy seed SEED: half random programs, half
    constant mutations (`corpusgen.mutate_constants`) of the vendored,
    corpusgen and fixture contracts."""
    rng = np.random.default_rng(SEED)
    bases = ([vendored(n) for n in VENDORED] + list(CORPUSGEN.values())
             + [code for code, _ in FIXTURES.values()])
    out = []
    for i in range(N_RANDOM):
        if i % 2 == 0:
            out.append(random_program(rng).hex())
        else:
            base = bytes.fromhex(bases[int(rng.integers(0, len(bases)))])
            out.append(corpusgen.mutate_constants(
                base, random.Random(int(rng.integers(0, 2**32)))).hex())
    return out


PROGRAMS = {
    **{f"vendored/{n}": vendored(n) for n in VENDORED},
    **{f"corpusgen/{n}": c for n, c in CORPUSGEN.items()},
    **{f"fixture/{n}": c for n, (c, _) in sorted(FIXTURES.items())},
    **{f"fault/{n}": c for n, c in FAULT_SUITE.items()},
}

# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------


def _plain(value):
    """Sets sorted, dicts with sorted keys, tuples as lists: one JSON-able
    form for both packages' objects."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in sorted(value.items(), key=lambda kv: repr(kv[0]))}
    if isinstance(value, (set, frozenset)):
        return sorted((_plain(v) for v in value), key=repr)
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, bytes):
        return value.hex()
    return value


def _untimed(lint: dict) -> dict:
    lint = dict(lint)
    lint.pop("wall_ms")
    lint["taint"] = {k: v for k, v in lint["taint"].items() if k != "wall_ms"}
    return lint


def view(summary) -> dict:
    """Everything a summary established, but its wall times."""
    flow, cfg = summary.flow, summary.cfg
    taint = None
    if summary.taint is not None:
        taint = {k: v for k, v in vars(summary.taint).items() if k != "wall_ms"}
    return _plain({
        "blocks": {s: [b.end, b.terminator, len(b)] for s, b in cfg.blocks.items()},
        "jumpdests": cfg.jumpdests,
        "peephole": cfg.peephole_targets,
        "reachable": summary.reachable_blocks,
        "dead_blocks": summary.dead_blocks,
        "resolved": flow.resolved_jumps,
        "unresolved": flow.unresolved_jumps,
        "invalid": flow.invalid_jumps,
        "underflow": flow.underflow_blocks,
        "possible_underflow": flow.possible_underflow_blocks,
        "incomplete": summary.incomplete,
        "dead_directions": summary.dead_directions,
        "inert_directions": summary.inert_directions,
        "prune_directions": summary.prune_directions(),
        "features": summary.features,
        "dispatcher": [vars(e) if hasattr(e, "__dict__") else
                       {k: getattr(e, k) for k in e.__slots__} for e in summary.dispatcher],
        "dead_selectors": summary.dead_selectors,
        "applicable": summary.applicable_modules(),
        "applicable_opcode": summary.applicable_modules(semantic=False),
        "static_answerable": summary.static_answerable,
        "taint": taint,
        "vsa": vars(summary.vsa),
        "fingerprints": summary.function_fingerprints,
        "link": summary.link.as_dict() if summary.link is not None else None,
        "findings": summary.findings(),
        "lint": _untimed(summary.lint_dict(name="c")),
    })


def jax_summary(code: str):
    from mythril_tpu.analysis.static import analyze_bytecode

    return analyze_bytecode(code)


def assert_same_summary(code: str) -> dict:
    want = view(jax_summary(code))
    got = view(port_static.analyze_bytecode(code))
    assert got.keys() == want.keys()
    assert {k: got[k] for k in got if got[k] != want[k]} == {}, code
    return got


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_summary_equals_the_jax_package(name):
    assert_same_summary(PROGRAMS[name])


@pytest.mark.parametrize("batch", range(N_RANDOM // BATCH))
def test_seeded_programs_equal_the_jax_package(batch):
    for code in seeded_programs()[batch * BATCH:(batch + 1) * BATCH]:
        assert_same_summary(code)


def test_seeded_programs_reach_the_hard_cases():
    """The seeded set holds what the dataflow must get right: truncated
    trailing PUSHes, definite underflows, computed jumps resolved by the
    dataflow (not the peephole), unresolved and invalid jumps, and
    contracts the static screen answers or cannot answer."""
    from mythril_tpu_torch.disassembler import asm

    seen = set()
    for code in seeded_programs():
        s = port_static.analyze_bytecode(code)
        raw = bytes.fromhex(code)
        ins = asm.disassemble(raw)
        if ins and ins[-1].opcode.startswith("PUSH") and (
                ins[-1].address + 1 + int(ins[-1].opcode[4:]) > len(raw)):
            seen.add("truncated push")
        if s.flow.underflow_blocks:
            seen.add("underflow")
        if set(s.flow.resolved_jumps) - set(s.cfg.peephole_targets):
            seen.add("computed jump")
        if s.flow.unresolved_jumps:
            seen.add("unresolved jump")
        if s.flow.invalid_jumps:
            seen.add("invalid jump")
        if s.dead_directions:
            seen.add("dead direction")
        seen.add(f"answerable {s.static_answerable}")
    assert seen >= {"truncated push", "underflow", "computed jump", "unresolved jump",
                    "invalid jump", "dead direction", "answerable True",
                    "answerable False"}, seen


def test_what_the_vendored_corpus_exercises():
    """No vendored contract is statically answerable; exceptions.sol.o
    alone has directions to prune (two infeasible, one into its inert
    function) and a dead selector; the screen mounts 2 to 7 of the 14
    modules on the eight walked contracts."""
    dead = {}
    for name in VENDORED:
        s = port_static.analyze_bytecode(vendored(name))
        assert not s.static_answerable, name
        if s.prune_directions() or s.dead_selectors:
            dead[name] = (sorted(s.prune_directions()), sorted(x.hex() for x in s.dead_selectors))
    assert dead == {"exceptions": ([(141, True), (530, True), (581, False)], ["f44f13d8"])}
    mounted = {n: len(port_static.analyze_bytecode(vendored(n)).applicable_modules()[0])
               for n in ("calls", "environments", "ether_send", "kinds_of_calls",
                         "overflow", "underflow", "metacoin", "origin")}
    assert mounted == {"calls": 5, "environments": 2, "ether_send": 7, "kinds_of_calls": 6,
                       "overflow": 2, "underflow": 2, "metacoin": 2, "origin": 2}


def test_config_fingerprint_differs_only_by_the_version(monkeypatch):
    """The fingerprint hashes the package version with the rest: with the
    JAX version put in the port's place, the two agree, static flags
    included."""
    import mythril_tpu
    import mythril_tpu_torch
    from mythril_tpu.analysis.static import summary as jax_summary_mod
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.analysis.static import summary as port_summary_mod
    from mythril_tpu_torch.support.support_args import args as port_args

    kw = dict(modules=["Exceptions"], transaction_count=3, solver_timeout=500,
              create_timeout=7)
    assert port_summary_mod.analysis_config_fingerprint(**kw) != \
        jax_summary_mod.analysis_config_fingerprint(**kw)
    monkeypatch.setattr(mythril_tpu_torch, "__version__", mythril_tpu.__version__)
    for prune, answer in ((True, True), (True, False), (False, True)):
        for a in (jax_args, port_args):
            monkeypatch.setattr(a, "static_prune", prune)
            monkeypatch.setattr(a, "static_answer", answer)
        assert port_summary_mod.analysis_config_fingerprint(**kw) == \
            jax_summary_mod.analysis_config_fingerprint(**kw)


def test_summary_cache_and_switches(monkeypatch):
    from mythril_tpu_torch.support.support_args import args

    port_static.clear_static_cache()
    code = corpusgen.deadweight_contract(1)
    first = port_static.summary_for(code)
    assert port_static.summary_for("0x" + code) is first
    assert port_static.static_cache_stats() == {"size": 1, "hits": 1, "misses": 1}
    assert port_static.static_prune_enabled() and port_static.static_answer_enabled()
    monkeypatch.setattr(args, "static_answer", False)
    assert port_static.static_prune_enabled() and not port_static.static_answer_enabled()
    monkeypatch.setattr(args, "static_answer", True)
    monkeypatch.setattr(args, "static_prune", False)
    assert not port_static.static_prune_enabled() and not port_static.static_answer_enabled()
    # another configuration is another cache slot
    assert port_static.summary_for(code) is not first


def test_defaults_are_the_jax_defaults():
    from mythril_tpu.support.support_args import Args as JaxArgs
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import Args as PortArgs

    jax_defaults = JaxArgs.__new__(JaxArgs)
    JaxArgs.__init__(jax_defaults)
    port_defaults = PortArgs.__new__(PortArgs)
    PortArgs.__init__(port_defaults)
    for flag in ("static_prune", "static_answer"):
        assert getattr(port_defaults, flag) is getattr(jax_defaults, flag) is True
    parsed = cli.build_parser().parse_args(["analyze", "--bin-runtime", "-c", "00"])
    assert not parsed.no_static_prune and not parsed.no_static_answer


# --------------------------------------------------------------------------
# the explorer's prune feed, against the JAX explorer
# --------------------------------------------------------------------------

DEADWEIGHT_RUN = dict(lanes_per_contract=8, waves=3, steps_per_wave=64, transaction_count=1,
                      seed=7, pipeline=False)
STATIC_COUNTERS = ("static_pruned_flips", "static_seeds_dropped", "static_summaries",
                   "static_answered")


def _traced(explorer_cls, **kw):
    from mythril_tpu_torch.laser.batch.explore import snapshot_waves

    ex = explorer_cls([corpusgen.deadweight_contract(0)], **DEADWEIGHT_RUN, **kw)
    records = snapshot_waves(ex)
    out = ex.run()
    return {"static_dead": sorted(ex.tracks[0].static_dead),
            "counters": {k: out["stats"][k] for k in STATIC_COUNTERS}, "waves": records}


def jax_waves(setattr_) -> dict:
    """The JAX explorer on deadweight_contract(0), static pruning on, its
    enumeration-only solver, the host ladder off (WAVES_PIN's content)."""
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.support.support_args import args as jax_args
    from test_torch_explore import _jax_setup, enum_only_solver

    jax_explore = _jax_setup(setattr_)
    setattr_(jax_args, "static_prune", True)
    setattr_(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
    return json.loads(json.dumps(_traced(jax_explore.DeviceCorpusExplorer)))


def test_live_waves_prune_as_the_jax_explorer(monkeypatch):
    """deadweight_contract(0) explored with static pruning on, under the
    enumeration-only solver and with the host ladder off, against the
    JAX explorer's run of the same (pinned in WAVES_PIN by --pin-waves:
    the JAX explorer's compiles cost about 1 GB a worker): the static
    counters and every wave's snapshot (its seeded calldata, the flip
    targets attempted, the coverage, every stats counter but the times)
    are equal, and the dead directions and the inert selector's seeds
    were pruned."""
    from mythril_tpu_torch.laser.batch import explore as port_explore
    from mythril_tpu_torch.laser.smt.solver import portfolio as port_portfolio
    from mythril_tpu_torch.support.support_args import args as port_args
    from test_torch_explore import enum_only_solver

    monkeypatch.setattr(port_args, "static_prune", True)
    monkeypatch.setattr(port_args, "sprint_cap_s", 0.0)
    # the pin's JAX explorer ran the generic kernel (`_jax_setup`)
    monkeypatch.setattr(port_args, "specialize", False)
    monkeypatch.setattr(port_portfolio, "device_solve_batch",
                        enum_only_solver(port_portfolio, device="cpu"))
    want = json.loads(WAVES_PIN.read_text())
    got = json.loads(json.dumps(_traced(port_explore.DeviceCorpusExplorer, device="cpu")))
    assert got["counters"] == want["counters"]
    assert got["counters"]["static_summaries"] == 1
    assert got["counters"]["static_seeds_dropped"] == 2
    assert got["counters"]["static_pruned_flips"] >= 1
    assert got["static_dead"] == want["static_dead"] == [[4, False], [33, True]]
    assert len(got["waves"]) == len(want["waves"]) >= 2
    for wave, (g, w) in enumerate(zip(got["waves"], want["waves"])):
        for key in ("serial", "seeded", "tracks", "stats"):
            assert g[key] == w[key], (wave, key)
    dead = bytes.fromhex("deadd00d")
    assert all(not bytes.fromhex(d).startswith(dead) for w in got["waves"] for _, d in w["seeded"])
    # a pruned target is blacklisted (marked attempted) without a solve,
    # and the inert function is never entered
    assert [33, True] not in got["waves"][-1]["tracks"][0]["covered"]


def test_selector_mask_rides_the_static_feed(monkeypatch):
    """A verdict-store mask on a track wraps its static summary
    (`SelectorMaskFeed`): the masked selector reads as dead to seeding
    and its entry direction to the flip frontier, as in the JAX
    explorer; with static pruning off there is no summary to wrap."""
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.laser.batch import explore as port_explore
    from mythril_tpu_torch.store.diff import SelectorMaskFeed
    from mythril_tpu_torch.support.support_args import args as port_args
    from test_torch_explore import _jax_setup

    jax_explore = _jax_setup(monkeypatch.setattr)
    code = corpusgen.deadweight_contract(0)
    live = port_static.analyze_bytecode(code).dispatcher[0]
    masks = {0: (frozenset({live.selector}),
                 frozenset({(live.jumpi_pc, live.entry_taken)}))}
    for a in (jax_args, port_args):
        monkeypatch.setattr(a, "static_prune", True)
    got = port_explore.DeviceCorpusExplorer([code], selector_masks=masks, device="cpu")
    want = jax_explore.DeviceCorpusExplorer([code], selector_masks=masks)
    assert isinstance(got.tracks[0].static, SelectorMaskFeed)
    assert got.tracks[0].static_dead == want.tracks[0].static_dead == {
        (4, False), (33, True), (live.jumpi_pc, live.entry_taken)}
    assert got.stats.store_masked_selectors == want.stats.store_masked_selectors == 1
    assert got.tracks[0].static.dead_selectors == want.tracks[0].static.dead_selectors
    monkeypatch.setattr(port_args, "static_prune", False)
    off = port_explore.DeviceCorpusExplorer([code], selector_masks=masks, device="cpu")
    assert off.tracks[0].static is None and off.stats.store_masked_selectors == 0


# --------------------------------------------------------------------------
# the walk's screen and the triage
# --------------------------------------------------------------------------


class _Contract:
    def __init__(self, disassembly_cls, code, creation_code=None):
        self.name = "Test"
        self.code = code
        self.creation_code = creation_code
        self.disassembly = disassembly_cls(code)


def test_wrapper_screens_as_the_jax_wrapper(monkeypatch):
    """SymExecWrapper on the same contract mounts the same modules in
    both packages, runtime-only (the semantic screen) and deploying (the
    opcode screen over runtime and creation code), and reports the
    screen in its execution info."""
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support.support_args import args as port_args

    for a in (jax_args, port_args):
        monkeypatch.setattr(a, "static_prune", True)
        monkeypatch.setattr(a, "device_prepass", "never")
    creation = "600a600c600039600a6000f3" + FAULT_SUITE["GATED"][:20]
    for code, creation_code in ((vendored("origin"), None), (FAULT_SUITE["GATED"], None),
                                (FAULT_SUITE["KILLABLE"], creation)):
        screens = []
        for package in ("mythril_tpu", "mythril_tpu_torch"):
            symbolic = importlib.import_module(f"{package}.analysis.symbolic")
            disassembly = importlib.import_module(f"{package}.disassembler.disassembly")
            kw = {"device": "cpu"} if package == "mythril_tpu_torch" else {}
            sym = symbolic.SymExecWrapper(
                _Contract(disassembly.Disassembly, code, creation_code), address=0x1234,
                strategy="bfs", execution_timeout=5, create_timeout=5, transaction_count=1,
                run_analysis_modules=False, **kw)
            info = [i.as_dict() for i in sym.execution_info if "static_analysis" in i.as_dict()]
            screens.append((sym.static_screen, info[0]["static_analysis"]["modules_skipped"]))
        assert screens[0] == screens[1], code
        assert screens[1][0] is not None and screens[1][1]


def _fingerprints(results):
    return {(r["name"], i["swc-id"], i["address"]) for r in results for i in r["issues"]}


def test_triage_answers_the_clean_contract(monkeypatch):
    """analyze_corpus with the triage on: clean_contract(0) is answered
    statically (no issues, no states, no lanes in the prepass), the
    killable contract takes the full path, and the issue set equals the
    run with the tier off, which walks the clean contract; the JAX
    package's triage answers the same rows (its copy of
    tests/analysis/test_static_taint.py's triage differential)."""
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.analysis import corpus as port_corpus
    from mythril_tpu_torch.support.support_args import args as port_args

    contracts = [(corpusgen.clean_contract(0), "", "Clean"), ("33ff", "", "Killable")]
    monkeypatch.setattr(port_args, "deterministic_solving", True)
    monkeypatch.setattr(port_args, "sprint_cap_s", 0.0)
    monkeypatch.setattr(port_corpus, "_effective_cpus", lambda: 1)  # prepass first
    prepass_rows = []
    real = port_corpus.corpus_device_prepass

    def recording(rows, **kw):
        prepass_rows.append(list(rows))
        return real(rows, **kw)

    monkeypatch.setattr(port_corpus, "corpus_device_prepass", recording)

    def leg(answer: bool):
        monkeypatch.setattr(port_args, "static_answer", answer)
        return port_corpus.analyze_corpus(contracts, transaction_count=1, execution_timeout=8,
                                          waves=2, device="cpu")

    triaged, walked = leg(True), leg(False)
    assert all(r["error"] is None and r["complete"] for r in triaged + walked)
    assert _fingerprints(triaged) == _fingerprints(walked)
    assert ("Killable", "106", 1) in _fingerprints(triaged)
    clean = triaged[0]
    assert clean["static_answered"] is True and clean["issues"] == [] and clean["states"] == 0
    assert clean["static_analysis"]["static_answerable"] is True
    assert prepass_rows[0][0][0] == "" and prepass_rows[1][0][0] == contracts[0][0]
    assert not walked[0].get("static_answered")
    monkeypatch.setattr(jax_args, "static_answer", True)
    monkeypatch.setattr(jax_args, "static_prune", True)
    assert sorted(jax_corpus._static_triage(contracts)) == sorted(
        port_corpus._static_triage(contracts)) == [0]


# --------------------------------------------------------------------------
# failures are recorded, never silent
# --------------------------------------------------------------------------


def test_a_failing_static_pass_is_recorded_not_silent(monkeypatch, capsys):
    """summary_for raising: the explorer explores unpruned and counts the
    contract in `static_failed`, SymExecWrapper mounts every module, the
    triage sends the contract down the full path, each records
    `static-prepass-failed` with the contract, and `analyze` prints the
    reason on stderr while the report stays the unpruned analysis's."""
    from mythril_tpu_torch.analysis import corpus as port_corpus
    from mythril_tpu_torch.analysis import symbolic as port_symbolic
    from mythril_tpu_torch.analysis.static import summary as summary_mod
    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser.batch import explore as port_explore
    from mythril_tpu_torch.support.resilience import DegradationLog
    from mythril_tpu_torch.support.support_args import args

    def broken(code, config_fp=None):
        raise RuntimeError("static fault")

    for flag in ("static_prune", "static_answer", "sprint_cap_s", "deterministic_solving",
                 "device_prepass"):
        monkeypatch.setattr(args, flag, getattr(args, flag))
    args.sprint_cap_s, args.deterministic_solving, args.device_prepass = 0.0, True, "never"
    monkeypatch.setattr(summary_mod, "summary_for", broken)
    monkeypatch.setattr(port_static, "summary_for", broken)
    log = DegradationLog()

    mark = log.marker()
    ex = port_explore.DeviceCorpusExplorer([corpusgen.deadweight_contract(0), "33ff"],
                                           device="cpu")
    assert ex.static_failed == 2 and ex.stats.static_summaries == 0
    assert all(t.static is None and t.static_dead == frozenset() for t in ex.tracks)
    assert log.counts_since(mark) == {"static-prepass-failed": 2}
    assert log.events[-1]["site"] == "explorer" and log.events[-1]["contract"].startswith(
        "sha256 ")

    mark = log.marker()
    sym = port_symbolic.SymExecWrapper(
        _Contract(Disassembly, FAULT_SUITE["GATED"]), address=0x1234, strategy="bfs",
        execution_timeout=5, transaction_count=1, device="cpu")
    assert sym.static_screen is None and sym.static_summary is None
    assert log.counts_since(mark) == {"static-prepass-failed": 1}
    assert (log.events[-1]["site"], log.events[-1]["contract"]) == ("walk", "Test")

    mark = log.marker()
    assert port_corpus._static_triage([(corpusgen.clean_contract(0), "", "Clean")]) == {}
    assert (log.events[-1]["site"], log.events[-1]["contract"]) == ("corpus-triage", "Clean")

    rc = cli.main(["analyze", "--bin-runtime", "-c", corpusgen.clean_contract(0), "-o", "json",
                   "--device", "cpu", "-t", "1", "--deterministic-solving"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert json.loads(out)["issues"] == []
    assert re.search(r"degraded: static-prepass-failed x[1-9]", err), err


# --------------------------------------------------------------------------
# lint
# --------------------------------------------------------------------------


def _jax_lint(argv):
    """The JAX `myth lint` command, in this process; (exit code, stdout)."""
    from mythril_tpu.interfaces import cli as jax_cli

    parser = jax_cli.build_parser()
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            jax_cli.parse_args_and_execute(parser=parser, args=parser.parse_args(["lint"] + argv))
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def _port_lint(argv, capsys):
    from mythril_tpu_torch.interfaces import cli

    try:
        code = cli.main(["lint"] + argv)
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _mask_wall(text: str) -> str:
    return re.sub(r"wall: [0-9.e-]+ ms", "wall: - ms", text)


def _rows(text: str):
    return [_untimed(row) for row in json.loads(text)]


@pytest.mark.parametrize("name", ["exceptions", "origin", "suicide"])
def test_lint_prints_the_jax_rows(name, capsys):
    code = vendored(name)
    for argv in (["-c", code, "--bin-runtime"], ["-c", code]):
        want_rc, want = _jax_lint(argv + ["-o", "json"])
        got_rc, got = _port_lint(argv + ["-o", "json"], capsys)
        assert (got_rc, _rows(got)) == (want_rc, _rows(want)) == (0, _rows(want))
        want_rc, want = _jax_lint(argv)
        got_rc, got = _port_lint(argv, capsys)
        assert (got_rc, _mask_wall(got)) == (want_rc, _mask_wall(want))
        assert got.startswith("Static analysis: MAIN (0x")


def test_lint_fail_on_exit_codes(tmp_path, capsys):
    """--fail-on: 1 when the check fires (the dead branch of
    exceptions.sol.o), 0 when it does not, 2 for an unknown check; the
    JAX command gives the same codes; a corpus of files is one row
    each."""
    code = vendored("exceptions")
    for argv, rc in ((["--fail-on", "dead-branch"], 1), (["--fail-on", "stack-underflow"], 0),
                     (["--fail-on", "no-such-check"], 2)):
        for form in (["-o", "json"], []):
            want_rc, _ = _jax_lint(["-c", code, "--bin-runtime"] + argv + form)
            got_rc, out = _port_lint(["-c", code, "--bin-runtime"] + argv + form, capsys)
            assert got_rc == want_rc == rc, (argv, form)
    _, out = _port_lint(["-c", code, "--fail-on", "dead-branch"], capsys)
    assert out.rstrip().endswith("lint: --fail-on check(s) fired: dead-branch")
    a, b = tmp_path / "a.hex", tmp_path / "b.hex"
    a.write_text(code + "\n")
    b.write_text(FAULT_SUITE["KILLABLE"] + "\n")
    rc, out = _port_lint(["-f", str(a), "-f", str(b), "-o", "json"], capsys)
    assert rc == 0 and [r["contract"] for r in json.loads(out)] == [str(a), str(b)]


def lint_rows(text: str):
    """`lint -o json` rows as the pin holds them: no wall times, no
    contract name (the JAX command names a lone input MAIN, the port's a
    corpus of files by path)."""
    return [{k: v for k, v in row.items() if k != "contract"} for row in _rows(text)]


def vendored_paths():
    return [str(symbolic_wave.CONTRACTS.relative_to(TESTS.parent) / f"{n}.sol.o")
            for n in VENDORED]


def jax_lint_pin() -> list:
    """The JAX `myth lint -f FILE -o json` row of each vendored contract."""
    rows = []
    for path in vendored_paths():
        rc, out = _jax_lint(["-f", str(TESTS.parent / path), "-o", "json"])
        assert rc == 0, path
        rows += lint_rows(out)
    return rows


def test_lint_pin_is_the_jax_rows_and_the_ports(capsys):
    """The pin chip_smoke.py holds the port's lint to is what the JAX
    command prints now, and what the port's prints on the 13 files."""
    pin = json.loads(LINT_PIN.read_text())
    assert pin["paths"] == vendored_paths()
    assert jax_lint_pin() == pin["rows"]
    files = [a for path in vendored_paths() for a in ("-f", str(TESTS.parent / path))]
    rc, out = _port_lint(files + ["-o", "json"], capsys)
    assert rc == 0 and lint_rows(out) == pin["rows"]


def pin_lint() -> None:
    LINT_PIN.write_text(json.dumps({"paths": vendored_paths(), "rows": jax_lint_pin()},
                                   indent=1, sort_keys=True) + "\n")
    print(f"wrote {LINT_PIN}")


def pin_waves() -> None:
    with pytest.MonkeyPatch.context() as mp:
        doc = jax_waves(mp.setattr)
    WAVES_PIN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {WAVES_PIN}")


if __name__ == "__main__":
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    modes = {"--pin-lint": pin_lint, "--pin-waves": pin_waves}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_static.py --pin-lint | --pin-waves")
    import conftest  # noqa: F401  (the suite's JAX settings)

    modes[sys.argv[1]]()
