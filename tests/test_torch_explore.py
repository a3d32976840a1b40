"""The port's device explorer against the JAX package's.

`mythril_tpu_torch.laser.batch.explore` (DeviceCorpusExplorer,
DeviceSymbolicExplorer) runs here on the CPU (`device="cpu"`: the plain
versions of the kernels) beside the JAX explorer on the same inputs:

- the scenario contracts of the JAX explorer's own tests at their sizes
  (8 lanes, 3-4 waves, 64 steps): KILLABLE, WRITER, BRANCHER, GATED
  (tests/laser/test_pipeline.py), the two-transaction storage-gated
  selfdestruct KILL2TX (tests/laser/test_device_symbolic.py) and the
  milestone corpus (`gated_kill`, `always_assert`, __graft_entry__.py).
  Every contract's fingerprint (coverage, trigger pcs by kind, evidence
  (class, pc): what issue synthesis reads) must equal the JAX
  explorer's, under both schedules, and the two schedules must agree;
- exact parity: with `device_solve_batch` replaced on both sides by an
  enumeration-only solver built from each package's own
  `device_enumerate` (so no SLS stream enters), every wave's seeded
  calldata, covered set, triggers, evidence records, carries and every
  stats counter but the times (`explore.wave_snapshot`) must be equal;
- `outcome()` and `ExploreStats.as_dict()` have the JAX package's keys.

Both sides run with static pruning off (the port's default is on: the
module turns it off, and tests/test_torch_static.py holds the static-on
explorer to the JAX one) and the device-first funnel. In
the tests above the host escalation ladder is off on both sides: the
port's `args.sprint_cap_s` is 0 for the whole module and the JAX
explorer's `_sprint_cap_s` returns -1.0, so every device survivor is
deferred. The JAX side takes about a minute here (a compile per shape),
so its results are pinned in `tests/test_torch_explore_pinned.json`;
one test runs the JAX explorer live and holds it to the pin. Regenerate
the pin with

    PYTHONPATH=. python tests/test_torch_explore.py --pin

With the ladder ON (the port's default; a cap of LADDER_CAP_S seconds
that never binds here) and both packages' enumeration-only solver under
`deterministic_solving`, every scenario's fingerprints and `host_sat`
(the ladder's sat verdicts) must equal the JAX explorer's, pinned in
`tests/test_torch_explore_ladder_pinned.json` by `--pin-ladder`; both
packages' solver sessions and memo caches start fresh for every run.

compare the two explorers at the full small-corpus prepass geometry
(13 contracts x 32 lanes, both schedules, enumeration only; a few
minutes) with `--full-width`, and run generation 0's pinned flip
queries through the JAX host ladder with `--ladder-check`.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu_torch import interop
from mythril_tpu_torch.laser.batch import explore as port_explore
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.smt.solver import portfolio as port_portfolio

torch.set_num_threads(1)

PINNED = Path(__file__).with_name("test_torch_explore_pinned.json")
LADDER_PINNED = Path(__file__).with_name("test_torch_explore_ladder_pinned.json")
#: the ladder's wall cap in the ladder-on runs (never reached)
LADDER_CAP_S = 120.0

WRITER = "6001600055600060015500"
BRANCHER = "600035600757005b600160005500"
KILLABLE = "33ff"
GATED = "60003560f81c604214600d57005b600160005500"
KILL2TX = (
    "60003560f81c" "8060011460155780600214601b5700"
    "5b3360005500" "5b600054331460255700" "5b33ff"
)
GATED_KILL = "604260003560f81c14600d57005b33ff"
ALWAYS_ASSERT = "fe00000000"

SCENARIOS = {
    "fault_suite": ([KILLABLE, WRITER, BRANCHER, GATED],
                    dict(lanes_per_contract=8, waves=3, steps_per_wave=64,
                         transaction_count=1, seed=7)),
    "kill2tx": ([KILL2TX],
                dict(calldata_len=36, lanes_per_contract=8, waves=4,
                     steps_per_wave=64, transaction_count=2)),
    "milestone": ([GATED_KILL, ALWAYS_ASSERT],
                  dict(lanes_per_contract=8, waves=3, steps_per_wave=64,
                       transaction_count=2)),
}
SCHEDULES = {"lockstep": False, "pipelined": True}


def fingerprint(contract):
    """The issue-bearing outcome of one contract (the JAX pipeline
    suite's `_fingerprint`), as JSON-able lists."""
    return [
        [list(b) for b in contract["covered_branches"]],
        {kind: sorted(t["pc"] for t in bucket)
         for kind, bucket in sorted(contract["triggers"].items())},
        sorted([e["class"], e["pc"]] for e in contract["evidence"]),
    ]


def traced_run(explorer):
    """Run `explorer`, taking `explore.wave_snapshot` after every wave."""
    records = port_explore.snapshot_waves(explorer)
    return explorer.run(), records


def enum_only_solver(pf, **enum_kw):
    """A `device_solve_batch` that only enumerates (each package's own
    `device_enumerate`): a verdict depends on the query alone."""

    def solve(queries, **_kw):
        out = []
        for q in queries:
            prog, _, loss = pf.compile_program_relaxed(q)
            if prog is None or not prog.var_slots:
                out.append(pf.DeviceVerdict("unknown", None, loss or "QUERY_TRIVIAL", None))
                continue
            verdict, asn = pf.device_enumerate(prog, **enum_kw)
            if verdict == "unknown":
                out.append(pf.DeviceVerdict("unknown", None, "SLS_NONCONVERGED", None))
            else:
                out.append(pf.DeviceVerdict(verdict, asn, None, "enum"))
        return out

    return solve


def port_run(name, pipeline, trace=False, **over):
    codes, kw = SCENARIOS[name]
    ex = port_explore.DeviceCorpusExplorer(codes, pipeline=pipeline, device="cpu",
                                           **dict(kw, **over))
    if trace:
        return (ex,) + traced_run(ex)
    return ex, ex.run(), None


@pytest.fixture(scope="module", autouse=True)
def ladder_off():
    """The port's host ladder off for the module (a zero cap defers
    every device survivor), as the ladder-off pins were made; the
    ladder-on tests switch it on themselves. The port's static pruning,
    specialization and blockjit are off too, as on the JAX side of every
    pin here; the static-on and specialized tests switch them on
    themselves."""
    from mythril_tpu_torch.support.support_args import args

    saved = args.sprint_cap_s, args.static_prune, args.specialize, args.blockjit
    args.sprint_cap_s, args.static_prune, args.specialize, args.blockjit = 0.0, False, False, False
    yield
    args.sprint_cap_s, args.static_prune, args.specialize, args.blockjit = saved


@pytest.fixture(scope="module")
def pinned():
    return json.loads(PINNED.read_text())


@pytest.fixture(scope="module")
def port_outcomes():
    """{(scenario, schedule): (explorer, outcome)} on the real solver."""
    out = {}
    for name in SCENARIOS:
        for sched, pipe in SCHEDULES.items():
            ex, res, _ = port_run(name, pipe)
            out[(name, sched)] = (ex, res)
    return out


@pytest.fixture(scope="module")
def port_traces():
    """{(scenario, schedule): per-wave records} under enumeration only."""
    solve = enum_only_solver(port_portfolio, device="cpu")
    saved = port_portfolio.device_solve_batch
    port_portfolio.device_solve_batch = solve
    try:
        return {(name, sched): port_run(name, pipe, trace=True)[2]
                for name in SCENARIOS for sched, pipe in SCHEDULES.items()}
    finally:
        port_portfolio.device_solve_batch = saved


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_fingerprints_equal_the_jax_explorer(name, sched, port_outcomes, pinned):
    _, res = port_outcomes[(name, sched)]
    got = [fingerprint(c) for c in res["contracts"]]
    assert got == pinned["fingerprints"][f"{name}/{sched}"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_pipelined_fingerprints_equal_lock_step(name, port_outcomes):
    lock = port_outcomes[(name, "lockstep")][1]
    piped = port_outcomes[(name, "pipelined")][1]
    assert [fingerprint(c) for c in piped["contracts"]] == [
        fingerprint(c) for c in lock["contracts"]]
    assert piped["stats"]["pipelined"] == 1 and lock["stats"]["pipelined"] == 0
    assert piped["stats"]["waves_inflight_max"] == 2
    assert piped["stats"]["waves_overlapped"] >= 1
    assert lock["stats"]["waves_inflight_max"] <= 1
    assert lock["stats"]["waves_overlapped"] == 0


def test_scenarios_find_what_the_jax_suites_find(port_outcomes):
    """The triggers the JAX suites assert: KILLABLE's selfdestruct, both
    directions of GATED's flip, KILL2TX's second-transaction selfdestruct
    with its prefix, and the milestone corpus' two triggers."""
    fault = port_outcomes[("fault_suite", "pipelined")][1]["contracts"]
    assert "selfdestruct" in fault[0]["triggers"]
    assert {(11, True), (11, False)} <= {tuple(b) for b in fault[3]["covered_branches"]}
    ex, res = port_outcomes[("kill2tx", "lockstep")]
    assert res["stats"]["transactions"] == 2 and res["stats"]["carries_banked"] >= 1
    (kill,) = res["contracts"][0]["triggers"]["selfdestruct"][:1]
    assert kill["pc"] == 39 and bytes.fromhex(kill["input"])[0] == 0x02
    assert [bytes.fromhex(p)[0] for p in kill["prefix"]] == [0x01]
    gated, asserts = port_outcomes[("milestone", "lockstep")][1]["contracts"]
    kills = gated["triggers"]["selfdestruct"]
    assert [t["pc"] for t in kills] == [15] and bytes.fromhex(kills[0]["input"])[0] == 0x42
    assert [t["pc"] for t in asserts["triggers"]["assert-violation"]] == [0]
    for name, sched in port_outcomes:
        log = port_outcomes[(name, sched)][0].reseed_log
        assert sum(r["witness_invalid"] for r in log) == 0


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_enumeration_only_waves_equal_exactly(name, sched, port_traces, pinned):
    got = port_traces[(name, sched)]
    want = pinned["traces"][f"{name}/{sched}"]
    assert len(got) == len(want)
    for wave, (g, w) in enumerate(zip(got, want)):
        for key in ("serial", "seeded", "tracks", "stats"):
            assert g[key] == w[key], (wave, key)


def test_symbolic_explorer_matches_the_jax_kill2tx_witness(pinned):
    ex = port_explore.DeviceSymbolicExplorer(
        KILL2TX, calldata_len=36, lanes=8, waves=4, steps_per_wave=64,
        transaction_count=2, pipeline=True, device="cpu")
    single = ex.run()
    assert fingerprint(single) == pinned["fingerprints"]["kill2tx/pipelined"][0]
    assert single["stats"]["transactions"] == 2
    assert ex.covered == {tuple(b) for b in single["covered_branches"]}


def test_outcome_and_stats_keys_equal_the_jax_package():
    from mythril_tpu.laser.batch import explore as jax_explore

    jax_track = jax_explore._ContractTrack(GATED)
    port_track = port_explore._ContractTrack(GATED)
    assert sorted(port_track.outcome()) == sorted(jax_track.outcome())
    assert sorted(port_track.completeness_gates()) == sorted(jax_track.completeness_gates())
    assert list(port_explore.ExploreStats().as_dict()) == list(
        jax_explore.ExploreStats().as_dict())
    assert port_explore.MERGE_POLICY == jax_explore.MERGE_POLICY
    for code in (GATED, KILL2TX, "6000" * 10 + "6101f435"):
        assert port_explore.required_calldata_len(code) == jax_explore.required_calldata_len(code)


def test_warm_reseed_equals_a_cold_rebuild():
    """From the second wave on, the explorer reseeds the next wave in
    the spent wave's buffers; the seeded batch must equal a cold
    make_batch of the same payload, every field (poisoned lanes'
    opaque storage tids included), and whole runs must agree."""
    ex = port_explore.DeviceCorpusExplorer(
        [BRANCHER, WRITER], lanes_per_contract=4, waves=2, steps_per_wave=64,
        transaction_count=2, pipeline=False, device="cpu")
    ex.run()
    carry = {"journal": {3: 7, 2**200: 1}, "prefix": [], "base": {3: 7},
             "balance": 10**18, "callvalue": 5}
    for t in ex.tracks:
        t.carries = [carry]
    payload = ex._prepare_wave(ex._seed_phase_inputs())
    cold = interop.symbatch_to_numpy(ex._cold_sym(payload))
    warm = interop.symbatch_to_numpy(ex._warm_sym(payload, ex._carcass))
    for name in cold.base._fields:
        np.testing.assert_array_equal(getattr(warm.base, name), getattr(cold.base, name), name)
    for name in cold._fields[1:]:
        np.testing.assert_array_equal(getattr(warm, name), getattr(cold, name), name)

    class ColdExplorer(port_explore.DeviceCorpusExplorer):
        def _dispatch_wave(self, payload):
            self._carcass = None  # the cold path every wave
            return super()._dispatch_wave(payload)

    kw = dict(lanes_per_contract=8, waves=4, steps_per_wave=64, transaction_count=2,
              pipeline=False, seed=3, device="cpu")
    warm_out = port_explore.DeviceCorpusExplorer([BRANCHER], **kw).run()
    cold_out = ColdExplorer([BRANCHER], **kw).run()
    assert fingerprint(warm_out["contracts"][0]) == fingerprint(cold_out["contracts"][0])
    assert warm_out["contracts"][0]["corpus_size"] == cold_out["contracts"][0]["corpus_size"]


def test_arena_view_holds_host_copies_only():
    """The pipelined schedule reseeds wave N+1 into wave N's buffers
    while N's view is still being consumed: the view must hold no
    device tensor."""
    ex = port_explore.DeviceCorpusExplorer([GATED], lanes_per_contract=4, waves=1,
                                           steps_per_wave=64, device="cpu")
    fl = ex._dispatch_wave(ex._prepare_wave(ex._seed_phase_inputs()))
    view = ex._harvest_wave(fl)
    assert isinstance(view, ArenaView)
    tensors = [k for k, v in vars(view).items() if isinstance(v, torch.Tensor)]
    assert tensors == []
    before = {k: v.copy() for k, v in vars(view).items() if isinstance(v, np.ndarray)}
    ex._carcass.base.status.fill_(7)
    ex._carcass.ar_op.fill_(3)
    assert all(np.array_equal(v, getattr(view, k)) for k, v in before.items())


def test_unported_options_raise(monkeypatch):
    """The mesh raises; specialization, ported, attaches its kernel (the
    corpus's union bucket, pinned in the cache, and the block-program
    table, since exceptions.sol.o's lowered density pays), and static
    pruning attaches its feed: a summary on every track and the
    statically dead directions (exceptions.sol.o has three), and none
    with it off."""
    from mythril_tpu_torch.laser import symbolic_wave
    from mythril_tpu_torch.laser.batch import blockjit, specialize
    from mythril_tpu_torch.support.support_args import args

    with pytest.raises(NotImplementedError, match="mesh"):
        port_explore.DeviceCorpusExplorer([GATED], n_devices=2, device="cpu")
    exceptions = (symbolic_wave.CONTRACTS / "exceptions.sol.o").read_text().strip()
    monkeypatch.setattr(args, "blockjit", True)
    spec = port_explore.DeviceCorpusExplorer([GATED, exceptions], specialize=True,
                                             device="cpu")
    assert spec._kernel is not None and spec._kernel.refs >= 1
    assert spec._kernel is specialize.kernel_cache().get(spec.kernel_phases)
    assert spec.kernel_phases.block_depth == blockjit.BLOCK_DEPTH
    assert tuple(spec._fuse_tbl.shape) == tuple(spec.code_table.jumpdest.shape)
    assert (spec.stats.specialized, spec.specialize_failed) == (1, 0)
    assert spec.stats.spec_pruned_phases == len(spec.kernel_phases.pruned)
    assert port_explore.DeviceCorpusExplorer([GATED], device="cpu")._kernel is None
    off = port_explore.DeviceCorpusExplorer([GATED, exceptions], device="cpu")
    assert [t.static for t in off.tracks] == [None, None]
    assert off.stats.static_summaries == 0
    monkeypatch.setattr(args, "static_prune", True)
    on = port_explore.DeviceCorpusExplorer([GATED, exceptions], device="cpu")
    assert all(t.static is not None for t in on.tracks)
    assert on.tracks[0].static_dead == frozenset()
    assert on.tracks[1].static_dead == {(141, True), (530, True), (581, False)}
    assert (on.stats.static_summaries, on.static_failed) == (2, 0)


def test_absent_ladder_defers_and_keeps_retrying():
    """With a zero cap, a query the device leaves unknown is deferred by
    the ladder (counted, recorded SPRINT_PREEMPTED) and stays retriable:
    it is collected again the next wave rather than blacklisted."""
    saved = port_portfolio.device_solve_batch
    port_portfolio.device_solve_batch = enum_only_solver(port_portfolio, device="cpu")
    try:
        ex = port_explore.DeviceCorpusExplorer(
            [GATED], lanes_per_contract=4, waves=3, steps_per_wave=64, pipeline=False,
            seed=5, device="cpu")
        out = ex.run()
    finally:
        port_portfolio.device_solve_batch = saved
    tried = [r["candidates"] for r in ex.reseed_log]
    assert tried[0] == 1 and ex.ladder_deferred >= 1
    assert ex.ladder_deferred == sum(r["deferred"] for r in ex.reseed_log)
    assert not out["contracts"][0]["completeness_gates"]["frontier_closed"]
    assert all(r["verdicts"].get("unknown", 0) == r["lowered"] for r in ex.reseed_log)


def test_deferred_queries_are_captured_for_the_jax_replay_lab(tmp_path):
    """With capture armed, a query the zero-cap ladder defers lands in
    the corpus as a flip-frontier artifact whose last loss is
    SPRINT_PREEMPTED, and the JAX package's corpus loader reads it."""
    from mythril_tpu.observe import querylog as jax_querylog
    from mythril_tpu_torch.observe import querylog

    saved = port_portfolio.device_solve_batch
    port_portfolio.device_solve_batch = enum_only_solver(port_portfolio, device="cpu")
    querylog.configure_capture(str(tmp_path))
    try:
        ex = port_explore.DeviceCorpusExplorer(
            [GATED], lanes_per_contract=4, waves=2, steps_per_wave=64, seed=5,
            device="cpu")
        ex.run()
    finally:
        querylog.configure_capture(None)
        port_portfolio.device_solve_batch = saved
    corpus = jax_querylog.load_corpus(str(tmp_path), reason="SPRINT_PREEMPTED")
    assert len(corpus) == 1 and ex.ladder_deferred == 1
    (artifact,) = corpus
    assert artifact["origin"] == "flip-frontier" and artifact["verdict"] == "unknown"
    device, ladder = artifact["observations"]
    assert (device["engine"], device["loss_reason"]) == ("device-portfolio", "SLS_NONCONVERGED")
    assert (ladder["engine"], ladder["site"]) == ("host-cdcl", "sprint_flips")
    assert ladder["detail"] == {"sprint_cap_s": 0.0}


@pytest.mark.parametrize("sched", SCHEDULES)
def test_flight_recorder_holds_the_runs_spans(sched):
    from mythril_tpu_torch.observe.spans import flight_recorder

    flight_recorder().clear()
    ex = port_explore.DeviceCorpusExplorer(
        [GATED], lanes_per_contract=4, waves=2, steps_per_wave=64,
        pipeline=SCHEDULES[sched], device="cpu")
    waves = ex.run()["stats"]["waves"]
    spans = flight_recorder().tail()
    by_name = {}
    for span in spans:
        by_name.setdefault(span.name, []).append(span)
    (run,) = by_name["explore.run"]
    (phase,) = by_name["phase"]
    assert phase.parent == run.sid and phase.attrs["txn"] == 0
    for name in ("wave.dispatch", "wave.harvest", "wave.consume", "wave.device"):
        assert len(by_name[name]) == waves, name
    for name in ("wave.dispatch", "wave.harvest", "wave.consume",
                 "flip.solve.device", "flip.solve.host"):
        assert all(span.parent == phase.sid for span in by_name[name]), name
    assert all(span.track == "device" for span in by_name["wave.device"])
    assert all(run.t0 <= span.t0 <= span.t1 <= run.t1 for span in spans)


def test_live_jax_explorer_matches_the_pin(pinned, monkeypatch):
    """The pin is what the JAX explorer gives now (one scenario live)."""
    got = jax_fingerprints("fault_suite", False, monkeypatch)
    assert got == pinned["fingerprints"]["fault_suite/lockstep"]


def test_live_jax_enumeration_trace_matches_the_pin(pinned, monkeypatch):
    """The pinned per-wave traces are what the JAX explorer gives now
    (one enumeration-only scenario live)."""
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio

    jax_explore = _jax_setup(monkeypatch.setattr)
    monkeypatch.setattr(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
    codes, kw = SCENARIOS["kill2tx"]
    ex = jax_explore.DeviceCorpusExplorer(codes, pipeline=False, **kw)
    assert traced_run(ex)[1] == pinned["traces"]["kill2tx/lockstep"]


# ---------------------------------------------------------------------------
# the ladder on
# ---------------------------------------------------------------------------


def ladder_on(setattr_, args, solver_mod, model_mod):
    """One package's ladder-on settings: the cap that never binds,
    reproducible solving, a fresh solver session and memo cache."""
    setattr_(args, "sprint_cap_s", LADDER_CAP_S)
    setattr_(args, "deterministic_solving", True)
    solver_mod.reset_blast_session()
    model_mod.clear_cache()


def port_ladder_run(name, sched, monkeypatch):
    from mythril_tpu_torch.laser.smt.solver import solver as port_solver
    from mythril_tpu_torch.support import model as port_model
    from mythril_tpu_torch.support.support_args import args

    ladder_on(monkeypatch.setattr, args, port_solver, port_model)
    monkeypatch.setattr(port_portfolio, "device_solve_batch",
                        enum_only_solver(port_portfolio, device="cpu"))
    ex, res, _ = port_run(name, SCHEDULES[sched])
    return ex, res


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_ladder_on_equals_the_jax_explorer(name, sched, monkeypatch):
    ladder = json.loads(LADDER_PINNED.read_text())
    ex, res = port_ladder_run(name, sched, monkeypatch)
    key = f"{name}/{sched}"
    assert [fingerprint(c) for c in res["contracts"]] == ladder["fingerprints"][key]
    assert res["stats"]["host_sat"] == ladder["host_sat"][key]
    assert ex.ladder_deferred == 0
    assert sum(r["witness_invalid"] for r in ex.reseed_log) == 0


def test_ladder_decides_what_the_zero_cap_defers(monkeypatch):
    """GATED under the enumeration-only solver: its flip query is wider
    than enumeration reaches, so with the ladder off it is deferred
    every wave and the frontier stays open; with the ladder on the host
    CDCL decides it, both directions are covered and the frontier
    closes."""
    kw = dict(lanes_per_contract=4, waves=3, steps_per_wave=64, pipeline=False, seed=5,
              device="cpu")
    monkeypatch.setattr(port_portfolio, "device_solve_batch",
                        enum_only_solver(port_portfolio, device="cpu"))
    off = port_explore.DeviceCorpusExplorer([GATED], **kw)
    off_out = off.run()
    from mythril_tpu_torch.laser.smt.solver import solver as port_solver
    from mythril_tpu_torch.support import model as port_model
    from mythril_tpu_torch.support.support_args import args

    ladder_on(monkeypatch.setattr, args, port_solver, port_model)
    ex = port_explore.DeviceCorpusExplorer([GATED], **kw)
    on_out = ex.run()
    assert off_out["stats"]["host_sat"] == 0 and off.ladder_deferred >= 1
    assert on_out["stats"]["host_sat"] >= 1 and ex.ladder_deferred == 0
    assert {(11, True), (11, False)} <= {tuple(b) for b in on_out["contracts"][0]["covered_branches"]}
    assert on_out["contracts"][0]["completeness_gates"]["frontier_closed"]
    assert not off_out["contracts"][0]["completeness_gates"]["frontier_closed"]


def test_capped_ladder_defers_with_the_real_cap(tmp_path, monkeypatch):
    """A cap the pass exceeds: the queries past it are recorded
    SPRINT_PREEMPTED with that cap, counted in ladder_deferred and
    returned capped (retriable); the ones before it were decided, and
    check_terms captured them."""
    from mythril_tpu_torch.laser.smt import symbol_factory
    from mythril_tpu_torch.observe import querylog
    from mythril_tpu_torch.support.support_args import args

    # each query sleeps 0.6 s before it solves: the first two start
    # inside the 1 s cap (the first solve has 0.4 s of slack, which a
    # loaded host's first blast needs), the last two after it
    monkeypatch.setattr(args, "sprint_cap_s", 1.0)
    ex = port_explore.DeviceCorpusExplorer(["00"], lanes_per_contract=1, pipeline=False,
                                           device="cpu")
    real = port_explore.get_model

    def slow(*a, **kw):
        import time

        time.sleep(0.6)
        return real(*a, **kw)

    monkeypatch.setattr(port_explore, "get_model", slow)
    xs = [symbol_factory.BitVecSym(f"capq{i}", 256) for i in range(4)]
    batch = [[x * 3 == 9 + 3 * i] for i, x in enumerate(xs)]
    out = [None] * 4
    querylog.configure_capture(str(tmp_path))
    try:
        capped, survivors = ex._sprint_flips(batch, out)
    finally:
        querylog.configure_capture(None)
    assert capped == {2, 3} and survivors == [2, 3] and ex.ladder_deferred == 2
    assert [o is not None for o in out] == [True, True, False, False]
    assert ex.stats.host_sat == 2
    observations = [o for p in sorted(tmp_path.glob("q-*.json"))
                    for o in json.loads(p.read_text())["observations"]]
    assert sorted(o["site"] for o in observations) == ["check_terms"] * 2 + ["sprint_flips"] * 2
    assert [(o["loss_reason"], o["detail"]) for o in observations
            if o["site"] == "sprint_flips"] == [("SPRINT_PREEMPTED", {"sprint_cap_s": 1.0})] * 2


# ---------------------------------------------------------------------------
# the JAX side (live in one test; the rest from the pin)
# ---------------------------------------------------------------------------


def _jax_setup(setattr_):
    from mythril_tpu.laser.batch import explore as jax_explore
    from mythril_tpu.support.support_args import args as jax_args

    for flag, value in (("static_prune", False), ("device_first", True),
                        ("specialize", False), ("blockjit", False)):
        setattr_(jax_args, flag, value)
    setattr_(jax_explore.DeviceCorpusExplorer, "_sprint_cap_s", lambda self: -1.0)
    return jax_explore


def jax_fingerprints(name, pipeline, monkeypatch):
    jax_explore = _jax_setup(monkeypatch.setattr)
    codes, kw = SCENARIOS[name]
    res = jax_explore.DeviceCorpusExplorer(codes, pipeline=pipeline, **kw).run()
    return [fingerprint(c) for c in res["contracts"]]


def pin() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio

    jax_explore = _jax_setup(setattr)
    doc = {"fingerprints": {}, "traces": {}}
    for name, (codes, kw) in SCENARIOS.items():
        for sched, pipe in SCHEDULES.items():
            res = jax_explore.DeviceCorpusExplorer(codes, pipeline=pipe, **kw).run()
            doc["fingerprints"][f"{name}/{sched}"] = [fingerprint(c) for c in res["contracts"]]
    real = jax_explore.device_solve_batch
    jax_explore.device_solve_batch = enum_only_solver(jax_portfolio)
    try:
        for name, (codes, kw) in SCENARIOS.items():
            for sched, pipe in SCHEDULES.items():
                ex = jax_explore.DeviceCorpusExplorer(codes, pipeline=pipe, **kw)
                doc["traces"][f"{name}/{sched}"] = traced_run(ex)[1]
    finally:
        jax_explore.device_solve_batch = real
    PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}")


def pin_ladder() -> None:
    """The JAX explorer's fingerprints and host_sat on every scenario and
    schedule with the ladder on (LADDER_CAP_S, deterministic_solving)
    and its enumeration-only solver, each run from a fresh solver
    session and memo cache, into LADDER_PINNED."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.laser.smt.solver import solver as jax_solver
    from mythril_tpu.support import model as jax_model
    from mythril_tpu.support.support_args import args as jax_args

    jax_explore = _jax_setup(setattr)
    jax_explore.DeviceCorpusExplorer._sprint_cap_s = lambda self: LADDER_CAP_S
    jax_explore.device_solve_batch = enum_only_solver(jax_portfolio)
    doc = {"settings": {"sprint_cap_s": LADDER_CAP_S, "deterministic_solving": True,
                        "solver": "enumeration only"},
           "fingerprints": {}, "host_sat": {}}
    for name, (codes, kw) in SCENARIOS.items():
        for sched, pipe in SCHEDULES.items():
            ladder_on(setattr, jax_args, jax_solver, jax_model)
            res = jax_explore.DeviceCorpusExplorer(codes, pipeline=pipe, **kw).run()
            doc["fingerprints"][f"{name}/{sched}"] = [fingerprint(c) for c in res["contracts"]]
            doc["host_sat"][f"{name}/{sched}"] = res["stats"]["host_sat"]
            print(name, sched, "host_sat", res["stats"]["host_sat"])
    LADDER_PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {LADDER_PINNED}")


def full_width() -> None:
    """Both explorers at the JAX small-corpus prepass geometry (the 13
    vendored contracts x 32 lanes, mem_cap 16384, storage_cap 128, 512
    steps, 8 waves a phase, 2 transactions), both schedules, under the
    enumeration-only solver: prints whether each schedule's fingerprints
    equal the JAX explorer's, and whether the schedules agree (a few
    minutes; not a test)."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu_torch.laser import symbolic_wave as wave

    jax_explore = _jax_setup(setattr)
    jax_explore.device_solve_batch = enum_only_solver(jax_portfolio)
    port_portfolio.device_solve_batch = enum_only_solver(port_portfolio, device="cpu")
    codes = [c.hex() for c in wave.load_contracts()]
    kw = dict(calldata_len=max(port_explore.required_calldata_len(c) for c in codes),
              lanes_per_contract=32, waves=8, steps_per_wave=512, mem_cap=16384,
              storage_cap=128, transaction_count=2, seed=1)
    got = {}
    for side, make in (("jax", lambda p: jax_explore.DeviceCorpusExplorer(codes, pipeline=p, **kw)),
                       ("port", lambda p: port_explore.DeviceCorpusExplorer(
                           codes, pipeline=p, device="cpu", **kw))):
        for sched, pipe in SCHEDULES.items():
            t0 = time.perf_counter()
            res = make(pipe).run()
            got[(side, sched)] = [fingerprint(c) for c in res["contracts"]]
            print(f"{side} {sched}: {time.perf_counter() - t0:.1f} s, waves "
                  f"{res['stats']['waves']}, device_steps {res['stats']['device_steps']}")
    for sched in SCHEDULES:
        print(f"{sched}: port == jax: {got[('port', sched)] == got[('jax', sched)]}")
    for side in ("jax", "port"):
        same = [a == b for a, b in zip(got[(side, "lockstep")], got[(side, "pipelined")])]
        print(f"{side}: lock-step == pipelined for {sum(same)} of {len(same)} contracts")


def ladder_check() -> None:
    """Generation 0's pinned flip frontier (the JAX wave of `test_torch_arena.jax_wave`, its
    decode held to `flip_frontier_pinned.json`) through the JAX
    explorer's host ladder (`_sprint_flips`: `get_model` at 2000 ms a
    query, under a cap that lets each query run), printing each
    query's verdict (about half a minute; not a test)."""
    import time

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import test_torch_arena
    from mythril_tpu.laser.batch import explore as jax_explore
    from mythril_tpu.laser.batch.arena import ArenaView as JaxArenaView
    from mythril_tpu.laser.smt.solver.preprocess import lower as jax_lower
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.laser import flip_frontier as ff

    for flag, value in (("static_prune", False), ("specialize", False),
                        ("blockjit", False), ("sprint_cap_s", 120.0)):
        setattr(jax_args, flag, value)
    out, _steps, _active = test_torch_arena.jax_wave()
    view = JaxArenaView(jax.tree_util.tree_map(jnp.asarray, jax.device_get(out)))
    code_ids = np.asarray(out.base.code_id)
    pinned = ff.load_pinned()
    frontier = ff.pinned_wave_frontier(view, code_ids, lower_fn=jax_lower)
    print("decode equals the pin:",
          frontier == {k: v for k, v in pinned.items() if k != "settings"})
    tracks = {}
    by = ff.lanes_by_contract(code_ids)
    ff.harvest(view, tracks, by)
    cands, _tried, _opaque = ff.collect_candidates(view, tracks, by)
    ex = jax_explore.DeviceCorpusExplorer(["00"], lanes_per_contract=1, pipeline=False)
    solved = [None] * len(cands)
    t0 = time.perf_counter()
    capped, survivors = ex._sprint_flips([c[2] for c in cands], solved)
    print(f"{len(cands)} queries in {time.perf_counter() - t0:.3f} s: host_sat "
          f"{ex.stats.host_sat}, capped {sorted(capped)}, timeouts {survivors}")
    for i, ((lane, _k, _conds, target), asn) in enumerate(zip(cands, solved)):
        verdict = ("sat" if asn is not None else "timeout" if i in survivors
                   else "capped" if i in capped else "unsat")
        print(f"  lane {lane} target {target}: {verdict}")


if __name__ == "__main__":
    modes = {"--pin": pin, "--pin-ladder": pin_ladder, "--full-width": full_width,
             "--ladder-check": ladder_check}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        modes[sys.argv[1]]()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_explore.py "
                 "--pin | --pin-ladder | --full-width | --ladder-check")
