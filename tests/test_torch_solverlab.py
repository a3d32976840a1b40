"""The port's solver lab (analysis/solverlab.py) and the rest of its query
flight recorder (observe/querylog.py) against the JAX package's.

Held live against the JAX package on the CPU:

- the fault-suite exploration of the JAX tests/laser/test_solverlab.py
  (GATED and BRANCHER, 8 lanes, 3 waves, 64 steps, seed 7), captured by
  each package's explorer with the device-first funnel (the product
  default): the same content addresses in both, and the JAX pin's
  (tests/test_torch_routing_pinned.json, which chip_smoke.py's routing
  phase holds the card to);
- a corpus either package captured loads and replays in the other, with
  the same host verdicts and the same waterfall; the replay rules hold on
  the port's device and race engines (`device="cpu"`, few candidates and
  steps: every SAT witness passes the concrete check, an UNSAT comes only
  from enumeration, an unknown is never a disagreement);
- the JAX suite's cases (capture determinism, shards, filters, report
  mode, no mutation, the command line, JSON reports) on the port, the
  shard partition and the tune sweep's trial list equal to the JAX ones;
- `deserialize_terms` and `load_corpus` (the JAX tests/observe/
  test_querylog.py serialization and corpus cases): the round trip
  decides alike and rebuilds the same interned terms, content addresses
  are stable, name-canonical and equal across the packages, and a
  document serialized by one package rebuilds in the other.

Solving is deterministic: the host engine is conflict-budgeted, the
corpus queries are enumeration-sized, and the device search's verdicts
are held by the rule above, never to a wall budget.
"""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mythril_tpu_torch.analysis import solverlab  # noqa: E402
from mythril_tpu_torch.laser.smt import terms  # noqa: E402
from mythril_tpu_torch.laser.smt.evalterm import eval_term  # noqa: E402
from mythril_tpu_torch.laser.smt.solver import portfolio  # noqa: E402
from mythril_tpu_torch.observe import querylog  # noqa: E402
from mythril_tpu_torch.support.support_args import args  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    """No capture leaks between cases; solving deterministic, no race."""
    from mythril_tpu.observe import querylog as jax_querylog

    restore = (args.device_solving, args.parallel_solving, args.deterministic_solving)
    args.deterministic_solving = True
    for ql in (querylog, jax_querylog):
        ql.configure_capture(None)
    yield
    (args.device_solving, args.parallel_solving, args.deterministic_solving) = restore
    for ql in (querylog, jax_querylog):
        ql.configure_capture(None)
    portfolio.reset_tuned_defaults()


def jax_capture(out_dir):
    """The JAX explorer's fault-suite capture, device-first (the product
    default; the JAX suite's conftest runs the host-first funnel)."""
    from mythril_tpu.laser.batch.explore import DeviceCorpusExplorer
    from mythril_tpu.observe import querylog as jax_querylog
    from mythril_tpu.support.model import clear_cache
    from mythril_tpu.support.support_args import args as jax_args

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_args, "device_first", True)
        clear_cache()
        jax_querylog.configure_capture(str(out_dir))
        try:
            DeviceCorpusExplorer(list(chip_smoke.FAULT_SUITE_CODES),
                                 **chip_smoke.FAULT_SUITE).run()
        finally:
            jax_querylog.configure_capture(None)
    return jax_querylog.load_corpus(str(out_dir))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each package's fault-suite corpus (its directory, its artifacts)."""
    base = tmp_path_factory.mktemp("fault")
    port_dir, jax_dir = base / "port", base / "jax"
    saved = args.deterministic_solving
    args.deterministic_solving = True
    try:
        port = chip_smoke.capture_fault_suite(port_dir, device="cpu")
    finally:
        args.deterministic_solving = saved
    return {"port": (port_dir, port), "jax": (jax_dir, jax_capture(jax_dir))}


@pytest.fixture(scope="module")
def pin():
    return json.loads(chip_smoke.ROUTING_PIN.read_text())


def test_fault_suite_addresses_equal_across_packages_and_the_pin(corpora, pin):
    shas = {name: sorted(a["sha"] for a in corpus) for name, (_d, corpus) in corpora.items()}
    assert shas["port"] == shas["jax"] == pin["fault_suite"]["shas"]
    assert all(a["origin"] == "flip-frontier" for a in corpora["port"][1])


def test_fault_suite_replay_agrees_100_percent(corpora, pin):
    corpus_dir, corpus = corpora["port"]
    report = solverlab.run(str(corpus_dir), engines=["host"])
    host = report["replay"]["host"]
    assert host["agreement"]["disagree"] == 0, report["disagreements"]
    assert host["agreement_pct"] == 100.0
    assert host["verdicts"] == pin["fault_suite"]["host_verdicts"]
    # every host-won query carries a loss reason: the waterfall counts them
    assert sum(report["loss_waterfall_sat"].values()) == sum(
        1 for a in corpus if a["verdict"] == "sat" and a["loss_reason"])


@pytest.mark.parametrize("captured_by, replayed_by", [("jax", "port"), ("port", "jax")])
def test_corpus_replays_across_packages(captured_by, replayed_by, corpora):
    """A corpus captured by one package loads and replays in the other:
    the same host verdict table and the same waterfall."""
    from mythril_tpu.analysis import solverlab as jax_solverlab
    from mythril_tpu.observe import querylog as jax_querylog

    labs = {"jax": (jax_solverlab, jax_querylog), "port": (solverlab, querylog)}
    corpus_dir = corpora[captured_by][0]
    reports = {}
    for name, (lab, ql) in labs.items():
        corpus = ql.load_corpus(str(corpus_dir))
        assert [a["sha"] for a in corpus] == [a["sha"] for a in corpora[captured_by][1]]
        reports[name] = lab.replay_corpus(corpus, engines=["host"])
    for key in ("live_verdicts", "origins", "buckets", "loss_waterfall", "loss_waterfall_sat"):
        assert reports[replayed_by][key] == reports[captured_by][key], key
    host = {name: r["replay"]["host"] for name, r in reports.items()}
    assert host["port"]["verdicts"] == host["jax"]["verdicts"]
    assert host["port"]["agreement"] == host["jax"]["agreement"]


def test_capture_replay_determinism(tmp_path, corpora):
    """The same exploration captured again gives the same content
    addresses; a corpus replayed twice gives the same verdict tables."""
    second = chip_smoke.capture_fault_suite(tmp_path / "again", device="cpu")
    first = corpora["port"][1]
    assert {a["sha"] for a in first} == {a["sha"] for a in second}
    r1 = solverlab.replay_corpus(first, engines=["host"])
    r2 = solverlab.replay_corpus(first, engines=["host"])
    assert r1["replay"]["host"]["verdicts"] == r2["replay"]["host"]["verdicts"]
    assert r1["replay"]["host"]["agreement"] == r2["replay"]["host"]["agreement"]


def _query_corpus(tmp_path):
    """A corpus of host-won queries with loss reasons and three origins
    (bare check_terms, flip-frontier and module contexts), some sat and
    one unsat, captured by the port's check_terms with the race off."""
    from mythril_tpu_torch.laser.smt.solver.solver import check_terms

    args.device_solving = "never"
    querylog.configure_capture(str(tmp_path))
    try:
        for i, (origin, lo, hi) in enumerate((("flip-frontier", 3, 9), ("module", 4, 11),
                                              (None, 5, 12), (None, 9, 3))):
            x = terms.bv_var(f"slq{i}", 16)
            query = [terms.ult(terms.bv_const(lo, 16), x), terms.ult(x, terms.bv_const(hi, 16))]
            if origin is None:
                check_terms(query, device="cpu")
            else:
                with querylog.query_context(origin):
                    check_terms(query, device="cpu")
    finally:
        querylog.configure_capture(None)
    return querylog.load_corpus(str(tmp_path))


@pytest.mark.parametrize("engine", ["device", "race"])
def test_device_and_race_engines_keep_the_replay_rule(engine, corpora, tmp_path):
    """The portfolio engine (and the race funnel with the gate forced
    open) on the CPU: no disagreement, no invalid witness, no error; each
    SAT the device engine gives is a witness that satisfies every
    constraint, each UNSAT comes from enumeration."""
    corpus = corpora["port"][1] + _query_corpus(tmp_path)
    args.deterministic_solving = False
    seen = []
    real = portfolio.device_solve_batch

    def recorded(queries, **kw):
        out = real(queries, **kw)
        seen.extend(zip(queries, out))
        return out

    portfolio.device_solve_batch = recorded
    try:
        report = solverlab.replay_corpus(corpus, engines=[engine], candidates=16, steps=64,
                                         timeout_ms=10_000, device="cpu")
    finally:
        portfolio.device_solve_batch = real
    table = report["replay"][engine]
    assert table["agreement"]["disagree"] == 0, report["disagreements"]
    assert not {"invalid", "error"} & set(table["verdicts"]), table
    assert sum(table["verdicts"].values()) == len(corpus)
    if engine == "device":
        assert table["verdicts"].get("sat") and table["verdicts"].get("unsat")
        for query, verdict in seen:
            if verdict.status == "sat":
                assert all(eval_term(c, verdict.assignment) for c in query)
            if verdict.status == "unsat":
                assert verdict.via == "enum"


def test_shard_partitions_exactly_as_in_jax():
    from mythril_tpu.analysis import solverlab as jax_solverlab

    corpus = [{"sha": f"{i * 7919:064x}", "verdict": "sat", "origin": "module",
               "program": {"nodes": [], "roots": []}} for i in range(17)]
    shards = [solverlab.shard_corpus(corpus, solverlab.parse_shard(f"{i}/4")) for i in range(4)]
    assert sorted(a["sha"] for s in shards for a in s) == sorted(a["sha"] for a in corpus)
    assert shards == [jax_solverlab.shard_corpus(corpus, jax_solverlab.parse_shard(f"{i}/4"))
                      for i in range(4)]
    assert solverlab.parse_shard(None) is None
    for bad in ("4/4", "nope", "1/0"):
        with pytest.raises(ValueError):
            solverlab.parse_shard(bad)


def test_filters_select_by_reason_and_origin(tmp_path):
    everything = _query_corpus(tmp_path)
    reasons = {a["loss_reason"] for a in everything if a["loss_reason"]}
    assert reasons  # host-won queries carry reasons
    reason = sorted(reasons)[0]
    filtered = querylog.load_corpus(str(tmp_path), reason=reason)
    assert filtered and all(a["loss_reason"] == reason for a in filtered)
    for origin, n in (("flip-frontier", 1), ("module", 1), ("memo-miss", 2)):
        picked = querylog.load_corpus(str(tmp_path), origin=origin)
        assert len(picked) == n and all(a["origin"] == origin for a in picked)
    assert querylog.load_corpus(str(tmp_path), origin="no-such-origin") == []


def test_report_mode_skips_solving(tmp_path):
    _query_corpus(tmp_path)
    report = solverlab.run(str(tmp_path), mode="report")
    assert report["mode"] == "report" and "replay" not in report
    assert report["queries"] == 4
    assert set(report) >= {"live_verdicts", "origins", "buckets", "loss_waterfall",
                           "loss_waterfall_sat"}
    assert "loss waterfall" in solverlab.render_text(report)


def test_waterfall_and_texts_equal_jax(tmp_path):
    from mythril_tpu.analysis import solverlab as jax_solverlab

    corpus = _query_corpus(tmp_path)
    assert solverlab.waterfall(corpus) == jax_solverlab.waterfall(corpus)
    report = solverlab.replay_corpus(corpus, engines=["host"])
    jax_report = jax_solverlab.replay_corpus(corpus, engines=["host"])
    for r in (report, jax_report):
        r["replay"]["host"]["wall_s"] = 0.0
    assert report == jax_report
    assert solverlab.render_text(report) == jax_solverlab.render_text(jax_report)


def test_replay_does_not_mutate_the_corpus(tmp_path):
    _query_corpus(tmp_path)
    before = {a["sha"]: len(a["observations"]) for a in querylog.load_corpus(str(tmp_path))}
    querylog.configure_capture(str(tmp_path))  # armed: the replay disarms it
    try:
        solverlab.run(str(tmp_path), engines=["host"])
        assert querylog.capture_dir() == str(tmp_path)
    finally:
        querylog.configure_capture(None)
    after = {a["sha"]: len(a["observations"]) for a in querylog.load_corpus(str(tmp_path))}
    assert before == after


def test_cli_surface_parses_and_runs(tmp_path, capsys):
    from mythril_tpu_torch.interfaces import cli

    parser = cli.build_parser()
    parsed = parser.parse_args(["solverlab", "replay", "--corpus", "/tmp/x", "--engines",
                                "host,device", "--filter", "reason=GATE_DISABLED", "--shard",
                                "0/2", "--timeout-ms", "5000", "--json", "--strict"])
    assert (parsed.command, parsed.mode, parsed.shard, parsed.device) == \
        ("solverlab", "replay", "0/2", "cuda")
    assert parser.parse_args(["solverlab", "report", "--corpus", "/tmp/x"]).mode == "report"
    assert parser.parse_args(["analyze", "-c", "33ff", "--capture-queries",
                              "/tmp/q"]).capture_queries == "/tmp/q"
    _query_corpus(tmp_path)
    assert cli.main(["solverlab", "replay", "--corpus", str(tmp_path), "--engines", "host",
                     "--json", "--strict"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["replay"]["host"]["agreement_pct"] == 100.0
    assert cli.main(["solverlab", "--corpus", str(tmp_path), "--filter", "nope"]) == 1


def test_run_report_is_json_serializable(corpora):
    report = solverlab.run(str(corpora["port"][0]), engines=["host"])
    assert json.loads(json.dumps(report, sort_keys=True))["replay"]["host"][
        "agreement_pct"] == 100.0


def test_tune_sweeps_as_in_jax(monkeypatch):
    """The grid sweep walks the same trials as the JAX one (the baseline,
    then each TUNE_GRID value off the defaults), the random sweep draws the
    same knob sets, and both rank alike."""
    from mythril_tpu.analysis import solverlab as jax_solverlab

    def stub(lab):
        def trial(lowered, candidates, knobs, device=None):
            decided = 1 + (knobs.get("cube_depth") == 4) + (knobs.get("restart_base") == 48)
            return {"knobs": dict(knobs), "sat": decided, "unsat": 0, "decided": decided,
                    "unknown": 0, "wall_s": 0.0}
        monkeypatch.setattr(lab, "_tune_trial", trial)
        monkeypatch.setattr(lab, "_rebuild", lambda art: [art["sha"]])

    for lab in (solverlab, jax_solverlab):
        stub(lab)
    corpus = [{"sha": "q0"}, {"sha": "q1"}]
    for sweep in ("grid", "random"):
        port = solverlab.tune_corpus(corpus, sweep=sweep, trials=8, seed=3)
        jax = jax_solverlab.tune_corpus(corpus, sweep=sweep, trials=8, seed=3)
        assert port == jax
    grid = solverlab.tune_corpus(corpus, sweep="grid")
    assert len(grid["trials"]) == 16 and grid["beats_baseline"]
    assert grid["best"]["knobs"] in ({"cube_depth": 4}, {"restart_base": 48})


def test_tune_trial_runs_the_portfolio_on_the_cpu(corpora):
    corpus = corpora["port"][1]
    lowered = [querylog.deserialize_terms(a["program"]) for a in corpus]
    base = solverlab._tune_trial(lowered, 16, {}, device="cpu")
    tuned = solverlab._tune_trial(lowered, 16, {"cube_depth": 0, "first_pass_steps": 96},
                                  device="cpu")
    assert base["decided"] == tuned["decided"] == len(corpus)
    assert portfolio.PORTFOLIO_DEFAULTS["cube_depth"] == 3  # the overrides were undone


# ---------------------------------------------------------------------------
# deserialize_terms and load_corpus
# ---------------------------------------------------------------------------
def _surface(T, tag):
    """The lowered op surface the JAX round-trip case builds, in terms
    module `T`."""
    x, y = T.bv_var(f"{tag}x", 64), T.bv_var(f"{tag}y", 64)
    b = T.bool_var(f"{tag}b")
    return [
        T.eq(T.add(T.mul(x, y), T.udiv(x, T.bv_const(3, 64))),
             T.bvxor(T.shl(x, T.bv_const(2, 64)), T.bvnot(y))),
        T.band(b, T.bor(T.slt(T.sext(T.extract(7, 0, x), 8), y),
                        T.ule(T.concat(T.extract(15, 8, x), T.extract(7, 0, y)), x))),
        T.eq(T.ite(b, T.urem(x, T.bv_const(5, 64)), T.ashr(y, T.bv_const(1, 64))),
             T.zext(T.extract(31, 0, x), 32)),
        T.bnot(T.eq(T.sdiv(x, y), T.srem(y, x))),
        T.bxor(T.sle(x, y), T.ult(T.lshr(x, T.bv_const(9, 64)), y)),
        T.bor(T.eq(T.bvand(x, y), T.bvor(x, T.bv_const(1, 64))), T.FALSE),
        T.band(T.TRUE, T.ule(T.sub(x, y), x)),
    ]


def test_round_trip_rebuilds_the_same_terms():
    query = _surface(terms, "rt_")
    rebuilt = querylog.deserialize_terms(querylog.serialize_terms(query))
    assert all(a is b for a, b in zip(query, rebuilt))


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_documents_rebuild_across_packages(writer, reader):
    """A program one package serialized rebuilds in the other: both give
    the document the same content address, and the rebuilt constraints
    evaluate as the originals on seeded random assignments. (Serializing
    the rebuilt terms again may order commutative children differently:
    the term layer orders them by creation id, in both packages.)"""
    import numpy as np

    from mythril_tpu.laser.smt import terms as jax_terms
    from mythril_tpu.laser.smt.evalterm import eval_term as jax_eval_term
    from mythril_tpu.observe import querylog as jax_querylog

    pkgs = {"jax": (jax_terms, jax_querylog, jax_eval_term),
            "port": (terms, querylog, eval_term)}
    T, ql, ev = pkgs[writer]
    original = _surface(T, f"x{writer}_")
    doc = ql.serialize_terms(original)
    _T2, ql2, ev2 = pkgs[reader]
    rebuilt = ql2.deserialize_terms(doc)
    assert ql2.content_address(doc) == ql.content_address(doc)
    rng = np.random.default_rng(18)
    for _ in range(16):
        env = {f"x{writer}_x": int(rng.integers(0, 2**63)),
               f"x{writer}_y": int(rng.integers(0, 2**63)),
               f"x{writer}_b": bool(rng.integers(0, 2))}
        assert [ev2(c, env) for c in rebuilt] == [ev(c, env) for c in original]


def test_content_address_stable_name_canonical_and_equal_across_packages():
    from mythril_tpu.laser.smt import terms as jax_terms
    from mythril_tpu.observe import querylog as jax_querylog

    def query(T, name, lo):
        x = T.bv_var(name, 16)
        return [T.ult(T.bv_const(lo, 16), x), T.ult(x, T.bv_const(9, 16))]

    addr = querylog.content_address(querylog.serialize_terms(query(terms, "ca_a", 3)))
    assert addr == querylog.content_address(querylog.serialize_terms(query(terms, "ca_a", 3)))
    assert addr == querylog.content_address(querylog.serialize_terms(query(terms, "ca_b", 3)))
    assert addr != querylog.content_address(querylog.serialize_terms(query(terms, "ca_c", 4)))
    assert addr == jax_querylog.content_address(
        jax_querylog.serialize_terms(query(jax_terms, "ca_j", 3)))


def test_round_trip_preserves_verdicts():
    from mythril_tpu_torch.laser.smt.solver.preprocess import lower
    from mythril_tpu_torch.laser.smt.solver.solver import check_terms

    args.device_solving = "never"
    x = terms.bv_var("rt_verdict_x", 16)
    query = [terms.ult(terms.bv_const(3, 16), x), terms.ult(x, terms.bv_const(9, 16))]
    live, _ = check_terms(query, device="cpu")
    lowered, _recon = lower(query)
    rebuilt = querylog.deserialize_terms(querylog.serialize_terms(lowered))
    assert check_terms(rebuilt, device="cpu")[0] == live == "sat"
    y = terms.bv_var("rt_verdict_y", 16)
    contradiction = [terms.ult(y, terms.bv_const(3, 16)), terms.ult(terms.bv_const(7, 16), y)]
    doc = querylog.serialize_terms(contradiction)
    assert check_terms(querylog.deserialize_terms(doc), device="cpu")[0] == "unsat"
    with pytest.raises(NotImplementedError):
        querylog.deserialize_terms({"nodes": [{"op": "frobnicate", "w": 8, "a": []}],
                                    "roots": [0]})


def test_load_corpus_skips_junk_foreign_and_newer_artifacts(tmp_path):
    corpus = _query_corpus(tmp_path)
    good = len(corpus)
    (tmp_path / "q-junk.json").write_text("{not json")
    (tmp_path / "q-foreign.json").write_text(json.dumps({"kind": "something-else"}))
    newer = dict(corpus[0], schema_version=querylog.ARTIFACT_SCHEMA_VERSION + 1, sha="f" * 64)
    (tmp_path / f"q-{'f' * 64}.json").write_text(json.dumps(newer))
    (tmp_path / "notes.txt").write_text("not an artifact")
    loaded = querylog.load_corpus(str(tmp_path))
    assert len(loaded) == good and [a["sha"] for a in loaded] == sorted(a["sha"] for a in loaded)
    from mythril_tpu.observe import querylog as jax_querylog

    assert loaded == jax_querylog.load_corpus(str(tmp_path))
