"""The port's routing triage (mythril_tpu_torch/routing, observe/routing.py)
against the JAX package's.

Held live against the JAX package on the CPU, with inputs made from a seed
(the JAX tests' synthetic logs, corpusgen's generators, the vendored
contracts):

- the JAX tests' own cases, run on the port's modules (`port_copy`: the
  test source with the package renamed): tests/routing/
  test_router_artifact.py (the train, save, load and decide round trip,
  the refusal ladder, the observe-layer satellites), test_router_tuning.py
  (the tuned artifacts, the replay-agreement gate, the watch loop) and
  test_router_service.py (the admission tier and the in-flight promotion,
  with the engine on `device="cpu"`);
- artifacts trained by either package from the same log are byte-equal
  (the same checksum) and load as the same Router in the other, both ways;
  tuned artifacts likewise; a damaged artifact is refused for the same
  reason in both;
- `features_for` equal on the 13 vendored contracts and corpusgen's rows,
  with and without the corpus link block; `outcome_for` and the log
  readers equal;
- `analyze_corpus(use_device=False, router_dir=)` equal to the JAX run in
  its results and its routing records (walls left out); the routed corpus
  run with the device axis on (`device="cpu"`) and `serve --router`'s
  jobs equal the JAX pin chip_smoke.py's routing phase holds the card to;
- the analyzer facade's `journeys` skeleton and routing record equal the
  JAX facade's (ids and walls left out), `analyze --observe-out` writes the
  record and `--no-observe` none;
- the solver series in the registry: the same query sequence trips the
  health machine's `solver-escalation-share` in both packages, and
  `/metrics` names the same `mtpu_solver_*` series;
- a router that raises while it loads or decides, and a routing record
  that cannot be written, are recorded in the DegradationLog.

Every walk is deterministic (deterministic solving, an execution_timeout
the walks cannot reach), except the promotion cases, whose overrun is a
walk of seconds against a 0.25 s budget or a 1 s clamp.

chip_smoke.py's routing phase reads the committed routing log and the JAX
pins from tests/test_torch_routing_pinned.json. Re-pin with

    PYTHONPATH=. python tests/test_torch_routing.py --pin-routing
"""

import contextlib
import hashlib
import io
import json
import sys
import tempfile
import time
import types
from pathlib import Path

import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mythril_tpu_torch import observe, routing  # noqa: E402
from mythril_tpu_torch.analysis import corpus as port_corpus  # noqa: E402
from mythril_tpu_torch.analysis.corpusgen import synth_bench_corpus  # noqa: E402
from mythril_tpu_torch.analysis.static import link_corpus  # noqa: E402
from mythril_tpu_torch.laser.smt.solver import portfolio  # noqa: E402
from mythril_tpu_torch.observe.registry import registry  # noqa: E402
from mythril_tpu_torch.support.resilience import DegradationLog  # noqa: E402
from mythril_tpu_torch.support.support_args import args  # noqa: E402

torch.set_num_threads(1)

PINNED = chip_smoke.ROUTING_PIN
VENDORED = sorted((ROOT / "tests" / "testdata" / "vendored" / "inputs").glob("*.sol.o"))
#: corpusgen's benchmark rows the features are held on (every generator)
BENCH = synth_bench_corpus(8, proxy_pairs=1, dupes=1, forks=1)


def port_copy(relpath: str, edits=()) -> types.ModuleType:
    """The JAX test module at `relpath`, its source with the package
    renamed and `edits` ((old, new) pairs) applied, as a module of its
    own: the same test code over the port's modules."""
    path = ROOT / relpath
    src = path.read_text().replace("mythril_tpu.", "mythril_tpu_torch.")
    src = src.replace("from mythril_tpu import", "from mythril_tpu_torch import")
    for old, new in edits:
        assert old in src, (relpath, old)
        src = src.replace(old, new)
    mod = types.ModuleType(f"port_copy_{path.stem}")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


#: the JAX router suites, and the edits that put them on the port: the
#: replay stubs take the port engines' `device` keyword, and the service
#: suite's engine runs on the CPU
JAX_SUITES = {
    "tests/routing/test_router_artifact.py": (),
    "tests/routing/test_router_tuning.py": (
        ("lambda lowered, candidates, steps:", "lambda lowered, candidates, steps, device=None:"),
    ),
    "tests/routing/test_router_service.py": (
        ("    host_walk=True,\n)", "    host_walk=True,\n    device=\"cpu\",\n)"),
    ),
}


def jax_cases():
    return [(f, name) for f, edits in JAX_SUITES.items()
            for name in sorted(vars(port_copy(f, edits))) if name.startswith("test_")]


@pytest.fixture(autouse=True)
def _isolated():
    """Each case runs with deterministic solving and leaves both packages'
    flag bags and actors as it found them (an analyzer pushes its options
    into its package's bag: the JAX facade's settings left in the JAX bag
    stall a later JAX explorer in the same process), the committed
    portfolio defaults, no process router, the observe switch on."""
    from mythril_tpu.laser.ethereum.transaction.symbolic import ACTORS as JAX_ACTORS
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.routing import router as jax_router
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
    from mythril_tpu_torch.routing import router as port_router

    bags = [(bag, dict(vars(bag))) for bag in (jax_args, args)]
    actors = [(a, dict(a.addresses)) for a in (JAX_ACTORS, ACTORS)]
    args.deterministic_solving = True
    yield
    for bag, values in bags:
        vars(bag).clear()
        vars(bag).update(values)
    for actor_set, addresses in actors:
        actor_set.addresses.clear()
        actor_set.addresses.update(addresses)
    for pf in (portfolio, jax_portfolio):
        pf.reset_tuned_defaults()
    for rt in (port_router, jax_router):
        rt.configure_router(None)
    observe.set_enabled(True)
    observe.configure(out_dir=None)


@pytest.mark.parametrize("relpath, name", jax_cases(), ids=lambda v: v.rsplit("/", 1)[-1])
def test_jax_router_case_on_the_port(relpath, name, tmp_path, monkeypatch):
    mod = port_copy(relpath, JAX_SUITES[relpath])
    assert mod.routing.__name__ == "mythril_tpu_torch.routing"
    fn = getattr(mod, name)
    wants = fn.__code__.co_varnames[: fn.__code__.co_argcount]
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    # the suites' fixtures, as they define them
    fixtures["records"] = mod.synthetic_records() if hasattr(mod, "synthetic_records") else None
    if "artifact_dir" in wants:
        routing.save_router(str(tmp_path), routing.train_model(fixtures["records"]))
        fixtures["artifact_dir"] = tmp_path
    fn(**{k: fixtures[k] for k in wants})


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------
def synthetic_records(**kw):
    """The JAX artifact suite's synthetic log (its own generator)."""
    return port_copy("tests/routing/test_router_artifact.py").synthetic_records(**kw)


def _packages():
    from mythril_tpu import routing as jax_routing

    return {"jax": jax_routing, "port": routing}


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_router_artifacts_load_across_packages(writer, reader, tmp_path):
    """One log trains a byte-equal artifact in both packages (the JAX
    order of operations); the other package loads it as the same Router
    and decides every record the same way."""
    pkgs = _packages()
    records = synthetic_records()
    paths = {}
    for name, pkg in pkgs.items():
        paths[name] = pkg.save_router(str(tmp_path / name), pkg.train_model(records))
    blobs = {name: Path(p).read_bytes() for name, p in paths.items()}
    assert blobs["jax"] == blobs["port"]
    loaded = pkgs[reader].load_router(str(tmp_path / writer))
    native = pkgs[writer].load_router(str(tmp_path / writer))
    assert loaded.version == native.version == 1
    assert json.loads(blobs[writer])["checksum"] == pkgs[reader].artifact.checksum_doc(
        json.loads(blobs[writer]))
    for rec in records:
        a, b = native.decide(rec["features"]), loaded.decide(rec["features"])
        assert (a.route, a.expected, a.budget_s()) == (b.route, b.expected, b.budget_s())


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_tuned_artifacts_load_across_packages(writer, reader, tmp_path):
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio

    pkgs = _packages()
    pfs = {"jax": jax_portfolio, "port": portfolio}
    knobs = {"restart_base": 48, "noise_hi": 0.6}
    gate = {"queries": 3, "agree": 3, "disagree": 0, "incomplete": 0, "pass": True}
    for name, pkg in pkgs.items():
        pkg.save_tuned(str(tmp_path / name), knobs, gate=gate)
    assert (tmp_path / "jax" / "tuned-v1.json").read_bytes() == \
        (tmp_path / "port" / "tuned-v1.json").read_bytes()
    assert pkgs[reader].maybe_install_tuned(str(tmp_path / writer)) == 1
    assert {k: pfs[reader].PORTFOLIO_DEFAULTS[k] for k in knobs} == knobs
    assert pfs[reader].tuned_version() == 1
    if reader == "port":
        assert registry().value("mtpu_router_tuned_version") == 1


def _damage(kind, path):
    doc = json.loads(path.read_text())
    if kind == "checksum":
        doc["model"]["trained_rows"] += 1
    elif kind == "schema":
        doc["schema_version"] += 1
        doc["checksum"] = routing.artifact.checksum_doc(doc)
    elif kind == "kind":
        doc["kind"] = "mtpu-tuned"
        doc["checksum"] = routing.artifact.checksum_doc(doc)
    elif kind == "feature-schema":
        doc["feature_schema_version"] = 3
        doc["checksum"] = routing.artifact.checksum_doc(doc)
    elif kind == "version":
        path.rename(path.with_name("router-v7.json"))
        return path.with_name("router-v7.json")
    elif kind == "junk":
        path.write_text("{not json")
        return path
    path.write_text(json.dumps(doc, sort_keys=True))
    return path


@pytest.mark.parametrize("kind", ["checksum", "schema", "kind", "feature-schema", "version",
                                  "junk"])
def test_damaged_artifacts_are_refused_alike(kind, tmp_path):
    """Each damage is refused for the same counted reason in both
    packages, and a directory holding only it routes on the heuristics."""
    from mythril_tpu.routing import ArtifactRefused as JaxRefused

    pkgs = _packages()
    path = Path(routing.save_router(str(tmp_path), routing.train_model(synthetic_records())))
    path = _damage(kind, path)
    reasons = {}
    for name, pkg in pkgs.items():
        refused = JaxRefused if name == "jax" else routing.ArtifactRefused
        with pytest.raises(refused) as err:
            pkg.load_router_file(str(path))
        reasons[name] = err.value.reason
    assert reasons["jax"] == reasons["port"] == kind
    before = registry().value("mtpu_router_refused_total", reason=kind)
    assert routing.load_router(str(tmp_path)) is None
    assert registry().value("mtpu_router_refused_total", reason=kind) == before + 1


# ---------------------------------------------------------------------------
# the feature log across the packages
# ---------------------------------------------------------------------------
FEATURE_ROWS = [(p.read_text().strip(), p.name) for p in VENDORED] + \
    [(code, name) for code, _c, name in BENCH]


@pytest.fixture(scope="module")
def linked():
    """Each package's corpus link pass over the feature rows."""
    from mythril_tpu.analysis.static import link_corpus as jax_link_corpus

    rows = [(code, "", name) for code, name in FEATURE_ROWS]
    return {"jax": jax_link_corpus(rows), "port": link_corpus(rows)}


@pytest.mark.parametrize("code, name", FEATURE_ROWS, ids=[n for _, n in FEATURE_ROWS])
def test_features_equal_across_packages(code, name, linked):
    """`features_for` is equal in both packages, alone and with the corpus
    link block (LinkSet.node_meta), so one artifact decides alike."""
    from mythril_tpu import observe as jax_observe

    key = "0x" + hashlib.sha256(bytes.fromhex(code)).hexdigest()
    metas = {pkg: ls.node_meta(key) for pkg, ls in linked.items()}
    assert metas["jax"] == metas["port"]
    assert observe.routing_features_for(code) == jax_observe.routing_features_for(code)
    assert observe.routing_features_for(code, link=metas["port"]) == \
        jax_observe.routing_features_for(code, link=metas["jax"])


OUTCOMES = [
    {"skipped": True}, {"quarantined": True}, {"store_hit": True, "issues": [1]},
    {"static_answered": True}, {"store_incremental": True, "wall_s": 1.5},
    {"promoted": "device-waves", "routed": "host-walk", "wall_s": 2.0},
    {"routed": "host-walk", "issues": [1, 2], "states": 9},
    {"owned": True, "device_prepass": {"waves": 3, "device_sat": 1, "host_sat": 2,
                                        "device_steps": 99}},
    {"error": "boom"}, {},
]


@pytest.mark.parametrize("result", OUTCOMES, ids=range(len(OUTCOMES)))
def test_outcome_for_equal_across_packages(result):
    from mythril_tpu import observe as jax_observe

    assert observe.routing_outcome_for(result) == jax_observe.routing_outcome_for(result)


def test_log_readers_equal_across_packages(tmp_path):
    """A log with junk and a partial tail reads the same in both packages,
    streamed, bounded and tailed."""
    from mythril_tpu.observe import routing as jax_routing_log
    from mythril_tpu_torch.observe import routing as port_routing_log

    path = tmp_path / "routing.jsonl"
    lines = [json.dumps(r, sort_keys=True) for r in synthetic_records(n=30)]
    path.write_text("\n".join(lines[:10] + ["junk", ""] + lines[10:]) + "\n{\"half")
    for fn, args_ in (("read_records", ()), ("read_records", (7,)), ("tail_records", (5,))):
        assert getattr(port_routing_log, fn)(str(path), *args_) == \
            getattr(jax_routing_log, fn)(str(path), *args_)


# ---------------------------------------------------------------------------
# the pin: the crafted log, its artifact, `route eval` and `route explain`
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pin():
    return json.loads(PINNED.read_text())


def _write_log(pin, tmp_path):
    path = tmp_path / "routing.jsonl"
    chip_smoke.write_routing_log(pin, path)
    return path


def test_pin_log_is_the_ports_features(pin):
    """The committed log was crafted from the routed corpus's rows: its
    features are the port's own, with and without the corpus link block."""
    rows = chip_smoke.routing_corpus()
    assert pin["rows"] == [[hashlib.sha256(bytes.fromhex(c)).hexdigest(), n]
                           for c, _, n in rows]
    assert [json.loads(line) for line in pin["log"]] == crafted_log(observe, link_corpus, rows)


def test_route_train_writes_the_jax_artifact(pin, tmp_path):
    log = _write_log(pin, tmp_path)
    rc, out = chip_smoke.route_cli(["route", "train", "--log", str(log), "--out",
                                    str(tmp_path / "router"), "--json"])
    assert rc == 0
    artifact = Path(json.loads(out)["artifact"])
    assert artifact.name == pin["artifact"]["name"]
    assert hashlib.sha256(artifact.read_bytes()).hexdigest() == pin["artifact"]["sha256"]


@pytest.mark.parametrize("mode", ["eval", "explain"])
def test_route_eval_and_explain_equal_the_jax_output(mode, pin, tmp_path):
    log = _write_log(pin, tmp_path)
    assert chip_smoke.route_cli(["route", "train", "--log", str(log), "--out",
                                 str(tmp_path / "router")])[0] == 0
    rc, out = chip_smoke.route_cli(["route", mode, "--log", str(log), "--router",
                                    str(tmp_path / "router"), "--json"])
    assert rc == 0 and json.loads(out) == pin["route"][mode]
    assert _jax_cli(["route", mode, "--log", str(log), "--router", str(tmp_path / "router"),
                     "--json"]) == out


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


def _router(pin, tmp_path):
    log = _write_log(pin, tmp_path)
    assert chip_smoke.route_cli(["route", "train", "--log", str(log), "--out",
                                 str(tmp_path / "router")])[0] == 0
    return str(tmp_path / "router")


# ---------------------------------------------------------------------------
# the corpus path
# ---------------------------------------------------------------------------
def _corpus_kw():
    return dict(chip_smoke.ROUTING_KW)


def test_host_only_corpus_with_a_router_equals_jax(pin, tmp_path):
    """Without the device axis the router stays out (the JAX rule): the
    results carry no stamps, and every row's routing record (features,
    route) equals the JAX run's."""
    from mythril_tpu import observe as jax_observe
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.support.support_args import args as jax_args

    router_dir = _router(pin, tmp_path)
    rows = [r for r in chip_smoke.routing_corpus() if r[2] in ("suicide", "clean")]
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        for flag, value in (("static_prune", True), ("static_answer", True)):
            mp.setattr(jax_args, flag, value)
        for name, corpus_mod, obs in (("jax", jax_corpus, jax_observe),
                                      ("port", port_corpus, observe)):
            obs.routing_log().clear()
            kw = dict(processes=1) if name == "jax" else {}
            results = corpus_mod.analyze_corpus(rows, use_device=False, router_dir=router_dir,
                                                **kw, **_corpus_kw())
            got[name] = (chip_smoke.routing_results(results),
                         chip_smoke.routing_records(obs.routing_log().tail()))
    assert got["port"] == got["jax"]
    assert all(routed is None and promoted is None for _, routed, promoted, _ in got["port"][0])
    assert [r[2] for r in got["port"][1]] == ["host-walk", "static-answer"]


def test_routed_corpus_orchestration_equals_jax_and_the_pin(pin, tmp_path):
    """The routed corpus's orchestration, live in both packages with the
    corpus prepass recorded and stubbed (no outcome: the device rows walk,
    which costs seconds where the CPU prepass costs minutes; chip_smoke.py
    runs the prepasses on the card): the decisions, the prepass rows (the
    host-routed rows left out, the overrunning row alone promoted), the
    routed/promoted stamps, the issue sets and the routing records equal
    the JAX run's; the decisions, the stamps and the records' features and
    routes equal the pin."""
    from mythril_tpu import observe as jax_observe
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.routing import router as jax_router
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.routing import router as port_router

    router_dir = _router(pin, tmp_path)
    rows = chip_smoke.routing_corpus()
    got = {}
    for name, corpus_mod, obs, rt in (("jax", jax_corpus, jax_observe, jax_router),
                                      ("port", port_corpus, observe, port_router)):
        prepass_rows, decisions = [], {}

        def prepass(contracts, *a, _mod=corpus_mod, _rows=prepass_rows, **kw):
            _rows.append([contracts[i][2] for i, _ in _mod._runnable_rows(contracts)])
            return {}

        real_decide = rt.Router.decide

        def decide(self, features, tiers=None, _real=real_decide, _d=decisions):
            decision = _real(self, features, tiers)
            _d[len(_d)] = chip_smoke.routing_decision(decision)
            return decision

        with pytest.MonkeyPatch.context() as mp:
            for flag, value in (("static_prune", True), ("static_answer", True),
                                ("deterministic_solving", True)):
                mp.setattr(jax_args, flag, value)
            mp.setattr(args, "device_prepass", "never")
            mp.setattr(corpus_mod, "_effective_cpus", lambda: 1)
            mp.setattr(corpus_mod, "corpus_device_prepass", prepass)
            mp.setattr(rt.Router, "decide", decide)
            obs.routing_log().clear()
            kw = dict(processes=1, use_device=True) if name == "jax" else dict(device="cpu")
            results = corpus_mod.analyze_corpus(rows, router_dir=router_dir, **kw,
                                                **_corpus_kw())
        named = dict(zip([n for _, _, n in rows if n != "clean"], decisions.values()))
        got[name] = {"decisions": named, "prepass": prepass_rows,
                     "results": chip_smoke.routing_results(results),
                     "records": chip_smoke.routing_records(obs.routing_log().tail())}
    assert got["port"] == got["jax"]
    assert got["port"]["decisions"] == pin["corpus"]["decisions"]
    assert got["port"]["prepass"] == [["exceptions", "multi_contracts"], ["metacoin"]]
    stamps = [r[:3] for r in pin["corpus"]["results"]]
    assert [r[:3] for r in got["port"]["results"]] == stamps
    assert [r[:3] + r[3:] for r in got["port"]["records"]] == pin["corpus"]["records"]


def test_pin_holds_the_routed_corpus_rows(pin):
    """The pinned run routed two rows to the device waves (their prepass
    outcomes injected, owned or walked), two to the host walk (suicide
    inside its budget, metacoin past its 0.25 s floor and promoted), and
    the static answer settled the clean row first."""
    decisions = pin["corpus"]["decisions"]
    assert {n: d[0] for n, d in decisions.items()} == {
        "metacoin": "host-walk", "suicide": "host-walk",
        "exceptions": "device-waves", "multi_contracts": "device-waves"}
    assert decisions["metacoin"][2] == 0.25 and decisions["suicide"][2] > 30
    assert [r[:3] for r in pin["corpus"]["results"]] == [
        ["metacoin", None, "device-waves"], ["suicide", "host-walk", None],
        ["exceptions", "device-waves", None], ["multi_contracts", "device-waves", None],
        ["clean", None, None]]


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
def _served(router_dir, engine_cls, config_cls, job_cls, device=None):
    """`suicide` then `bulk_copy` submitted to an engine-less service with
    the router in `router_dir`: {name: {routed, promoted}} once each has
    settled on the walk pool or been promoted to the wave queue."""
    codes = {name: code for code, _, name in chip_smoke.served_rows()}
    cfg = dict(chip_smoke.ROUTING_SERVE)
    if device is not None:
        cfg["device"] = device
    engine = engine_cls(config_cls(router_dir=router_dir, **cfg))
    assert engine._router is not None
    out = {}
    try:
        for name in chip_smoke.ROUTING_SERVED:
            job = engine.submit(job_cls(codes[name]))
            deadline = time.monotonic() + 300
            while not (job.terminal or job.promoted) and time.monotonic() < deadline:
                time.sleep(0.05)
            out[name] = {"routed": job.routed, "promoted": job.promoted}
            assert job.routed == "host-walk" and (job.terminal or job.promoted), name
    finally:
        engine.close()
    return out


def test_served_routing_equals_the_pin(pin, tmp_path):
    """`serve --router` on the CPU, engine-less (no wave thread): the
    walk-pool job settles routed, the overrunning one is promoted to the
    head of the wave queue, as the JAX engine's pinned jobs were."""
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    got = _served(_router(pin, tmp_path), AnalysisEngine, ServiceConfig, Job, device="cpu")
    assert got == pin["serve"]["jobs"]


def test_promotion_keeps_the_jax_queue_accounting(pin, tmp_path):
    """A job routed at admission never held a queue slot (registered
    without a lane); promoted, it sits at the head of the wave queue with
    the same depth, slots and allocator state as in the JAX engine."""
    from mythril_tpu.service.engine import AnalysisEngine as JaxEngine
    from mythril_tpu.service.engine import ServiceConfig as JaxConfig
    from mythril_tpu.service.jobs import Job as JaxJob
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    router_dir = _router(pin, tmp_path)

    def accounting(engine_cls, config_cls, job_cls, **kw):
        engine = engine_cls(config_cls(router_dir=router_dir, **dict(
            chip_smoke.ROUTING_SERVE, **kw)))
        try:
            job = job_cls("33ff")
            engine.queue.register(job)
            job.routed, job.route_budget_s = "host-walk", 0.25
            job.started_t = time.monotonic() - 5.0
            job.state = "analyzing"
            engine._finalize(job, None, {"stats": {"waves": 0, "device_steps": 0},
                                         "covered_branches": [], "triggers": {},
                                         "degraded_lanes": 0},
                             host_result={"issues": [], "states": 1, "error": None})
            q = engine.queue
            return {"state": job.state, "promoted": job.promoted, "head": q._pending[0] is job,
                    "depth": q.depth(), "jobs": q.jobs_by_state(),
                    "lanes": engine.alloc.occupancy()}
        finally:
            engine.close()

    assert accounting(AnalysisEngine, ServiceConfig, Job, device="cpu") == \
        accounting(JaxEngine, JaxConfig, JaxJob)


# ---------------------------------------------------------------------------
# the analyzer facade and the command line
# ---------------------------------------------------------------------------
def _journey_skeleton(doc):
    """A journey without its ids, times and walls."""
    drop = {"journey_id", "t", "t_s", "ts", "wall_s", "wall_ms", "elapsed_s", "at",
            "offset_s", "start", "end", "duration_s", "tier_dwell_s"}

    def strip(value):
        if isinstance(value, dict):
            return {k: strip(v) for k, v in value.items() if k not in drop}
        if isinstance(value, list):
            return [strip(v) for v in value]
        return value

    return strip(doc)


def test_facade_journeys_and_record_equal_jax():
    """`fire_lasers` writes one routing record per contract and puts its
    journey in the report meta, as the JAX facade does: the records'
    features and routes and the journeys' skeletons are equal."""
    from mythril_tpu import observe as jax_observe
    from mythril_tpu.mythril import MythrilAnalyzer as JaxAnalyzer
    from mythril_tpu.mythril import MythrilDisassembler as JaxDisassembler
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler

    codes = ("6000356000526020600020600055" "33ff", "600035600757005bfe")
    #: the facade setup of tests/mythril/test_facade.py (tests/test_torch_facade.py)
    facade = dict(strategy="bfs", use_onchain_data=False, address="0x" + "11" * 20,
                  execution_timeout=60, create_timeout=10, max_depth=64, loop_bound=3,
                  deterministic_solving=True, static_prune=True, specialize=False,
                  blockjit=False, pipeline=False)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_args, "static_prune", True)
        for name, ana, dis, obs, kw in (
                ("jax", JaxAnalyzer, JaxDisassembler, jax_observe, {}),
                ("port", MythrilAnalyzer, MythrilDisassembler, observe, {"device": "cpu"})):
            disassembler = dis()
            for code in codes:
                disassembler.load_from_bytecode(code, bin_runtime=True)
            obs.routing_log().clear()
            report = ana(disassembler, **kw, **facade).fire_lasers(transaction_count=1)
            got[name] = ([_journey_skeleton(j) for j in report.meta["journeys"]],
                         chip_smoke.routing_records(obs.routing_log().tail()),
                         sorted(i.swc_id for i in report.issues.values()))
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 2 and [r[2] for r in got["port"][1]] == ["host-walk"] * 2


def test_analyze_observe_out_and_no_observe(tmp_path, capsys):
    from mythril_tpu_torch.interfaces import cli

    base = ["analyze", "--bin-runtime", "-c", "33ff", "--device", "cpu", "--device-prepass",
            "never", "--device-solving", "never", "-o", "json"]
    assert cli.main(base + ["--observe-out", str(tmp_path / "on")]) == 0
    (record,) = observe.read_routing_records(str(tmp_path / "on" / "routing_features.jsonl"))
    assert record["features"] == observe.routing_features_for("33ff")
    assert record["outcome"]["route"] == "host-walk"
    observe.configure(out_dir=None)
    assert cli.main(base + ["--observe-out", str(tmp_path / "off"), "--no-observe"]) == 0
    assert not (tmp_path / "off" / "routing_features.jsonl").exists()
    capsys.readouterr()


@pytest.mark.parametrize("command", ["route", "solverlab"])
def test_commands_take_the_jax_flags_and_defaults(command):
    """Every flag of the JAX command parses in the port with the JAX
    default (`solverlab` adds `--device`)."""
    from mythril_tpu.interfaces import cli as jax_cli
    from mythril_tpu_torch.interfaces import cli

    argv = {"route": ["route", "eval", "--log", "L"],
            "solverlab": ["solverlab", "--corpus", "C"]}[command]
    jax_args_ = vars(jax_cli.build_parser().parse_args(argv))
    port_args = vars(cli.build_parser().parse_args(argv))
    for key, value in jax_args_.items():
        if key not in ("epic", "v", "command"):
            assert port_args[key] == value, key
    assert set(port_args) - set(jax_args_) <= {"device"}


def test_serve_router_flags_are_accepted(monkeypatch):
    from mythril_tpu_torch.interfaces import cli

    monkeypatch.setenv("MYTHRIL_ROUTER_DIR", "R")
    for argv in (["--router", "R"], [], ["--router", "R", "--no-router"]):
        parsed = cli.build_parser().parse_args(["serve", "--device", "cpu", *argv])
        assert cli.serve_refusals(parsed) == []
    assert all("router" not in flag for flag, _ in cli.SERVE_REFUSED)


# ---------------------------------------------------------------------------
# the solver series and the tuned gauge
# ---------------------------------------------------------------------------
#: a query sequence past the objective's 16 events: 20 queries, 12 of them
#: escalated one hop
QUERY_SEQUENCE = [("host-cdcl", "sat", 0.01, 1)] * 12 + [("memo", "sat", 0.0, 0)] * 8


def test_solver_series_trip_the_escalation_objective_in_both_packages():
    from mythril_tpu import observe as jax_observe
    from mythril_tpu.observe import slo as jax_slo
    from mythril_tpu_torch.observe import slo

    names = ("mtpu_solver_queries_total", "mtpu_solver_wall_seconds_total",
             "mtpu_solver_query_seconds", "mtpu_solver_escalations_total")
    states, series = {}, {}
    for name, obs, slo_mod in (("jax", jax_observe, jax_slo), ("port", observe, slo)):
        clock = [1000.0]
        engine = slo_mod.SloEngine(slo_mod.default_objectives(), reg=obs.registry(),
                                   clock=lambda: clock[0])
        engine.sample()  # the window's start
        for origin, verdict, wall, hop in QUERY_SEQUENCE:
            obs.record_query(origin, verdict, wall_s=wall, hop=hop)
        clock[0] += 1.0
        states[name] = {s.objective.name: (s.state, s.burn_short, s.total)
                        for s in engine.sample()}
        text = obs.registry().prometheus_text()
        series[name] = [line for line in text.splitlines()
                        if line.startswith("# ") and line.split()[2] in names]
    assert series["port"] == series["jax"] and len(series["port"]) == 2 * len(names)
    assert states["port"]["solver-escalation-share"] == \
        states["jax"]["solver-escalation-share"]
    state, burn, total = states["port"]["solver-escalation-share"]
    assert state != "ok" and burn == pytest.approx(1.2) and total == 20


def test_tuned_version_gauge_as_in_jax():
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.observe.registry import registry as jax_registry

    for pf in (portfolio, jax_portfolio):
        pf.install_tuned_defaults({"restart_base": 12}, 5)
    assert registry().value("mtpu_router_tuned_version") == \
        jax_registry().value("mtpu_router_tuned_version") == 5


# ---------------------------------------------------------------------------
# failures are recorded
# ---------------------------------------------------------------------------
class _Raises:
    version = 9

    def decide(self, *a, **kw):
        raise RuntimeError("decide failed")


def test_corpus_records_a_router_that_raises(monkeypatch):
    from mythril_tpu_torch.routing import router as port_router

    rows = [r for r in chip_smoke.routing_corpus() if r[2] == "suicide"]
    for patch, site in ((lambda d: (_ for _ in ()).throw(OSError("load failed")),
                         "corpus-router-load"),
                        (lambda d: _Raises(), "corpus-route-decision")):
        monkeypatch.setattr(port_router, "load_router", patch)
        mark = DegradationLog().marker()
        (result,) = port_corpus.analyze_corpus(rows, router_dir="R", waves=1, device="cpu",
                                               **_corpus_kw())
        assert DegradationLog().counts_since(mark).get("router-failed") == 1, site
        assert result["complete"] and "routed" not in result


def test_engine_records_a_router_that_raises(monkeypatch, tmp_path):
    from mythril_tpu_torch.routing import router as port_router
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu_torch.service.jobs import Job

    monkeypatch.setattr(port_router, "load_router", lambda d: _Raises())
    mark = DegradationLog().marker()
    engine = AnalysisEngine(ServiceConfig(router_dir="R", device="cpu", stripes=1,
                                          lanes_per_stripe=4))
    try:
        job = engine.submit(Job("33ff"))
        assert job.routed is None and job.state == "queued"
    finally:
        engine.close()
    assert DegradationLog().counts_since(mark).get("router-failed") == 1


def test_unwritable_routing_log_is_recorded(tmp_path):
    out = tmp_path / "observe"
    out.mkdir()
    (out / "routing_features.jsonl").mkdir()  # a directory: the append fails
    observe.configure(out_dir=str(out))
    mark = DegradationLog().marker()
    rec = observe.routing_log().record("c", "h", {}, {"route": "host-walk"})
    assert rec["contract"] == "c"
    assert DegradationLog().counts_since(mark).get("routing-record-failed") == 1


# ---------------------------------------------------------------------------
# the pin (the JAX side of chip_smoke.py's routing phase)
# ---------------------------------------------------------------------------
def crafted_log(obs, link_fn, rows):
    """The committed routing log: for each contract of ROUTING_WALLS, its
    features with the corpus link block of `rows` (as analyze_corpus
    prices it; routed corpus rows only) and without (as serve admission
    does), each under both routes with the wall ROUTING_WALLS names,
    ROUTING_COPIES times: the router it trains sends metacoin and
    environments to the host walk predicted near 0 s (the 0.25 s budget
    floor), suicide to the host walk predicted at about 20 s,
    and exceptions and multi_contracts to the device waves."""
    linkset = link_fn(rows)
    records = []
    in_corpus = {name for _, _, name in rows}
    for code, _creation, name in rows + chip_smoke.routing_rows(
            [n for n in chip_smoke.ROUTING_WALLS if n not in in_corpus]):
        walls = chip_smoke.ROUTING_WALLS.get(name)
        if walls is None:
            continue
        digest = hashlib.sha256(bytes.fromhex(code)).hexdigest()
        forms = (("corpus", obs.routing_features_for(code, link=linkset.node_meta(
            "0x" + digest))),) if name in in_corpus else ()
        forms += (("serve", obs.routing_features_for(code)),)
        for form, features in forms:
            for route, wall in zip(("host-walk", "device-owned"), walls):
                records += [{
                    "schema_version": 4, "contract": name, "code_hash": digest,
                    "features": features,
                    "outcome": {"route": route, "wall_s": wall, "issues": 0, "states": 0,
                                "complete": True, "error": False},
                    "journey_id": f"{name}-{form}-{route}"}] * chip_smoke.ROUTING_COPIES
    return json.loads(json.dumps(records))


def pin_routing() -> None:
    """The JAX side of chip_smoke.py's routing phase: the crafted log
    (`crafted_log`, JAX features), its JAX artifact and `myth route
    eval/explain --json`; the fault suite captured by the JAX explorer
    with the device-first funnel (the product default) and its host
    replay; the JAX analyze_corpus(router_dir=) on routing_corpus() with
    the device axis on (the JAX prepass on its CPU devices), prepass first,
    STORE_WAVES waves a phase, the enumeration-only device solver, the
    static pass and answer on, specialization and blockjit off; the JAX
    engine's jobs under `serve --router` (engine-less)."""
    import conftest  # noqa: F401  (the suite's JAX settings)
    from mythril_tpu import observe as jax_observe
    from mythril_tpu import routing as jax_routing
    from mythril_tpu.analysis import corpus as jax_corpus
    from mythril_tpu.analysis import solverlab as jax_solverlab
    from mythril_tpu.analysis.static import link_corpus as jax_link_corpus
    from mythril_tpu.laser.batch import explore as jax_explore
    from mythril_tpu.laser.smt.solver import portfolio as jax_portfolio
    from mythril_tpu.observe import querylog as jax_querylog
    from mythril_tpu.service.engine import AnalysisEngine, ServiceConfig
    from mythril_tpu.service.jobs import Job
    from mythril_tpu.support.model import clear_cache
    from mythril_tpu.support.support_args import args as jax_args
    from test_torch_explore import enum_only_solver

    rows = chip_smoke.routing_corpus()
    doc = {"settings": {"waves": chip_smoke.STORE_WAVES, "kw": chip_smoke.ROUTING_KW,
                        "use_device": True, "schedule": "prepass first",
                        "solver": "enumeration only", "static_prune": True,
                        "static_answer": True, "specialize": False, "blockjit": False,
                        "walls": chip_smoke.ROUTING_WALLS, "copies": chip_smoke.ROUTING_COPIES,
                        "fault_suite": chip_smoke.FAULT_SUITE, "serve": chip_smoke.ROUTING_SERVE},
           "rows": [[hashlib.sha256(bytes.fromhex(c)).hexdigest(), n] for c, _, n in rows]}
    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for flag, value in (("static_prune", True), ("static_answer", True),
                            ("specialize", False), ("blockjit", False), ("store", False),
                            ("device_first", True), ("deterministic_solving", True)):
            mp.setattr(jax_args, flag, value)
        doc["log"] = [json.dumps(r, sort_keys=True)
                      for r in crafted_log(jax_observe, jax_link_corpus, rows)]
        log_path = tmp / "routing.jsonl"
        chip_smoke.write_routing_log(doc, log_path)
        out = json.loads(_jax_cli(["route", "train", "--log", str(log_path), "--out",
                                   str(tmp / "router"), "--json"]))
        artifact = Path(out["artifact"])
        doc["artifact"] = {"name": artifact.name,
                           "sha256": hashlib.sha256(artifact.read_bytes()).hexdigest(),
                           "checksum": json.loads(artifact.read_text())["checksum"]}
        doc["route"] = {mode: json.loads(_jax_cli(["route", mode, "--log", str(log_path),
                                                   "--router", str(tmp / "router"),
                                                   "--json"]))
                        for mode in ("eval", "explain")}
        # the fault suite
        clear_cache()
        jax_querylog.configure_capture(str(tmp / "fault"))
        try:
            jax_explore.DeviceCorpusExplorer(list(chip_smoke.FAULT_SUITE_CODES),
                                             **chip_smoke.FAULT_SUITE).run()
        finally:
            jax_querylog.configure_capture(None)
        fault = jax_querylog.load_corpus(str(tmp / "fault"))
        report = jax_solverlab.replay_corpus(fault, engines=["host"])
        doc["fault_suite"] = {"shas": sorted(a["sha"] for a in fault),
                              "host_verdicts": report["replay"]["host"]["verdicts"]}
        # the routed corpus
        base = jax_explore.DeviceCorpusExplorer

        class Capped(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **dict(kw, waves=chip_smoke.STORE_WAVES, budget_s=None))

        mp.setattr(jax_explore, "DeviceCorpusExplorer", Capped)
        mp.setattr(jax_explore, "device_solve_batch", enum_only_solver(jax_portfolio))
        mp.setattr(jax_corpus, "_effective_cpus", lambda: 1)
        jax_observe.routing_log().clear()
        t0 = time.perf_counter()
        results = jax_corpus.analyze_corpus(rows, router_dir=str(tmp / "router"),
                                            use_device=True, processes=1,
                                            **chip_smoke.ROUTING_KW)
        print("routed corpus", f"{time.perf_counter() - t0:.1f} s",
              [(r["name"], r.get("routed"), r.get("promoted"), r.get("wall_s"))
               for r in results])
        router = jax_routing.load_router(str(tmp / "router"))
        linkset = jax_link_corpus(rows)
        decisions = {}
        for (code, _c, name), result in zip(rows, results):
            if result.get("static_answered") or result.get("store_hit"):
                continue
            meta = linkset.node_meta("0x" + hashlib.sha256(bytes.fromhex(code)).hexdigest())
            decisions[name] = chip_smoke.routing_decision(router.decide(
                jax_observe.routing_features_for(code, link=meta),
                tiers=["host-walk", "device-waves"]))
        doc["corpus"] = {"decisions": decisions,
                         "results": chip_smoke.routing_results(results),
                         "records": chip_smoke.routing_records(jax_observe.routing_log().tail())}
        # the service, engine-less
        doc["serve"] = {"jobs": _served(str(tmp / "router"), AnalysisEngine, ServiceConfig,
                                        Job)}
        print("served", doc["serve"])
    PINNED.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PINNED}")


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).parent), str(ROOT)]
    if sys.argv[1:] == ["--pin-routing"]:
        pin_routing()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_routing.py --pin-routing")
