"""The port's analysis service (mythril_tpu_torch/service) against the JAX
package's, on the CPU.

- **Per-job reports.** Both engines at the JAX service tests' arena
  (tests/service/test_service_server.py: 2 stripes x 4 lanes, 64 steps,
  2 waves, the host walk off), with the JAX suite's flags (conftest:
  specialization, blockjit and the static answer off) set alike in the
  port, take WRITER, KILLABLE and BRANCHER with fixed job ids (the
  mutation RNG is seeded by the id) before they start, and give equal
  reports key for key under both schedules, pipelined and lock-step,
  except the timing fields (REPORT_TIMINGS, JOB_TIMINGS). With the host
  walk on, KILLABLE's issues equal the JAX walk's (SWC-106).
- **The service contract**, on the port alone: a deadline of 0 (one
  wave, `deadline-expired`), 429 on a full queue, 400 on junk, the code
  cache on a resubmission, arena warmup and readiness, the background
  bucket warmup, the HTTP routes, the /stats key set against the JAX
  engine's, and drain checkpoints that load in both packages.
- **The JAX suite's own cases**: tests/service/test_service_allocator.py
  and test_service_jobs.py, their source with the package renamed, run
  against the port's lane_allocator and jobs.
- **The command line**: every `serve` flag of a module the port does not
  have is refused with its module named; a `serve --port 0 --device
  cpu` subprocess answers a `submit` subprocess and drains on SIGTERM.
- **The pin.** chip_smoke.py's serve phase holds its reports to
  tests/test_torch_service_pinned.json, the JAX engine's reports on the
  CPU for the phase's submissions (chip_smoke.serve_jobs) at `serve`'s
  geometry ("full") and at the small arena ("small"), with
  specialization, blockjit and the static answer on: pipelined with the
  walks on, lock-step device-only ("_lockstep") and lock-step with the
  walks on ("_lockstep_walks"). The port runs the small parts here and
  must equal them. Regenerate with

    PYTHONPATH=. python tests/test_torch_service.py --pin

  (the JAX engine on the CPU, ~4 min: its block-bucket compiles).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_jax_memory import release_jax_executables  # noqa: F401

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PINNED = chip_smoke.SERVE_PIN
WRITER, KILLABLE, BRANCHER = chip_smoke.WRITER, chip_smoke.KILLABLE, chip_smoke.BRANCHER

#: tests/service/test_service_server.py's arena
CFG = dict(
    stripes=2,
    lanes_per_stripe=4,
    steps_per_wave=64,
    max_waves=2,
    queue_capacity=8,
    host_walk=False,
    execution_timeout=5,
    coalesce_wait_s=0.15,
    idle_wait_s=0.02,
)
#: the keys left out of the comparison, wall times all: the report's,
#: and the job dict's
REPORT_TIMINGS = ("timings",)
JOB_TIMINGS = ("age_s", "latency_s")
#: the JAX suite's flags (tests/conftest.py) and the pinned run's
SUITE_FLAGS = dict(specialize=False, blockjit=False, static_answer=False, static_prune=True)
PIN_FLAGS = dict(specialize=True, blockjit=True, static_answer=True, static_prune=True)
WAIT_S = 300.0


@contextmanager
def port_flags(**flags):
    from mythril_tpu_torch.support.support_args import args

    saved = {k: getattr(args, k) for k in flags}
    for k, v in flags.items():
        setattr(args, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(args, k, v)


@pytest.fixture
def suite_flags():
    with port_flags(**SUITE_FLAGS):
        yield


def job_id(i: int) -> str:
    return f"{i + 1:012x}"


def run_engine(engine, jobs, job_cls):
    """Submit `jobs` ((code, submit kwargs) in order, fixed ids) to the
    un-started `engine`, start it, and return each job's dict once it
    is terminal."""
    submitted = []
    for i, (code, kw) in enumerate(jobs):
        job = job_cls(code, **kw)
        job.id = job.journey_id = job_id(i)
        submitted.append(engine.submit(job))
    engine.start()
    try:
        for job in submitted:
            assert engine.queue.wait_terminal(job.id, WAIT_S).terminal, job.as_dict()
        return [job.as_dict() for job in submitted]
    finally:
        engine.drain()


def port_engine(**cfg):
    from mythril_tpu_torch.service.engine import AnalysisEngine, ServiceConfig

    return AnalysisEngine(ServiceConfig(device="cpu", **cfg))


def jax_engine(**cfg):
    from mythril_tpu.service.engine import AnalysisEngine, ServiceConfig

    return AnalysisEngine(ServiceConfig(store=False, router=False, **cfg))


def port_run(jobs, **cfg):
    from mythril_tpu_torch.service.jobs import Job

    return run_engine(port_engine(**cfg), jobs, Job)


def jax_run(jobs, **cfg):
    from mythril_tpu.service.jobs import Job

    return run_engine(jax_engine(**cfg), jobs, Job)


def comparable(job: dict) -> dict:
    out = {k: v for k, v in job.items() if k not in JOB_TIMINGS}
    out["report"] = {k: v for k, v in job["report"].items() if k not in REPORT_TIMINGS}
    return out


# ---------------------------------------------------------------------------
# per-job reports against the JAX engine
# ---------------------------------------------------------------------------
THREE = [(WRITER, {}), (KILLABLE, {}), (BRANCHER, {})]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "lockstep"])
def test_reports_equal_the_jax_engine(suite_flags, pipeline):
    port = port_run(THREE, pipeline=pipeline, **CFG)
    jax_jobs = jax_run(THREE, pipeline=pipeline, **CFG)
    for got, want in zip(port, jax_jobs):
        assert got["state"] == "done", got
        assert comparable(got) == comparable(want)
    # the branching contract covered both directions of its JUMPI
    assert port[2]["report"]["device"]["covered_branches"] == 2


def test_pipelined_equals_lockstep(suite_flags):
    piped = port_run(THREE, pipeline=True, **CFG)
    lock = port_run(THREE, pipeline=False, **CFG)
    assert [comparable(j) for j in piped] == [comparable(j) for j in lock]


def test_host_walk_issue_set_equals_the_jax_engine(suite_flags):
    """KILLABLE with the host walk on: the device outcome is injected
    into the walk, and the walk's issues equal the JAX engine's."""
    jobs = [(KILLABLE, {"host_walk": True})]
    port = port_run(jobs, **CFG)[0]
    jax_job = jax_run(jobs, **CFG)[0]
    assert port["state"] == jax_job["state"] == "done", (port, jax_job)
    assert port["report"]["host"]["error"] is None
    got = chip_smoke.issue_fingerprints(port["report"])
    assert got == chip_smoke.issue_fingerprints(jax_job["report"])
    assert [f[0] for f in got] == ["106"]
    assert port["report"]["device"] == jax_job["report"]["device"]


# ---------------------------------------------------------------------------
# the service contract on the port
# ---------------------------------------------------------------------------
@pytest.fixture
def server(suite_flags):
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(ServiceConfig(device="cpu", **CFG)).start()
    yield srv
    srv.close()


def client_of(srv, **kw):
    from mythril_tpu_torch.service.client import ServiceClient

    return ServiceClient(srv.url, **kw)


def test_deadline_zero_gives_one_wave_and_deadline_expired(server):
    client = client_of(server)
    job = client.report(client.submit(WRITER, deadline_s=0.0), wait_s=WAIT_S)
    assert job["state"] == "done", job
    assert "deadline-expired" in job["report"]["degraded"]
    assert job["report"]["device"]["waves"] == 1


def test_code_cache_hits_on_resubmission(server):
    client = client_of(server)
    assert client.report(client.submit(KILLABLE), wait_s=WAIT_S)["state"] == "done"
    before = client.stats()["warm"]["code_cache"]
    assert client.report(client.submit(KILLABLE), wait_s=WAIT_S)["state"] == "done"
    after = client.stats()["warm"]["code_cache"]
    assert after["hits"] > before["hits"] and after["misses"] == before["misses"]


def test_bad_requests_answer_400_and_unknown_jobs_404(server):
    from mythril_tpu_torch.service.client import ServiceError

    client = client_of(server)
    with pytest.raises(ServiceError) as bad:
        client.submit("0xzz")
    assert bad.value.status == 400
    with pytest.raises(ServiceError) as missing:
        client.job("f" * 12)
    assert missing.value.status == 404


def test_queue_full_answers_429(suite_flags):
    from mythril_tpu_torch.service.client import ServiceError
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    srv = AnalysisServer(
        ServiceConfig(device="cpu", **dict(CFG, queue_capacity=1)), start_engine=False
    ).start()
    try:
        client = client_of(srv, honor_retry_after=False)
        client.submit(WRITER)
        with pytest.raises(ServiceError) as refusal:
            client.submit(KILLABLE)
        assert refusal.value.status == 429
        assert refusal.value.retry_after == 1.0
        assert client.stats()["queue"]["rejected_full"] == 1
    finally:
        srv.close()


def test_routes_answer_as_the_jax_server(server):
    """/metrics (Prometheus text with the service's series), /trace (the
    flight recorder, and its Perfetto form), a job's journey at
    /v1/jobs/<id>/trace and the readiness probe."""
    import urllib.request

    client = client_of(server)
    job = client.report(client.submit(KILLABLE), wait_s=WAIT_S)
    with urllib.request.urlopen(server.url + "/metrics") as r:
        metrics = r.read().decode()
    assert "# TYPE mtpu_service_waves_total counter" in metrics
    assert "mtpu_service_job_latency_seconds_bucket" in metrics
    with urllib.request.urlopen(server.url + "/trace?format=perfetto") as r:
        doc = json.loads(r.read())
    assert any(e["name"] == "wave.device" for e in doc["traceEvents"])
    with urllib.request.urlopen(server.url + f"/v1/jobs/{job['job_id']}/trace") as r:
        journey = json.loads(r.read())
    assert journey["state"] == "done"
    assert journey["tiers"][:2] == ["admission", "queued"]
    assert "wave" in journey["tiers"] and journey["tiers"][-1] == "settle"
    assert client.healthz(ready=True)["ready"] is True


def test_stats_key_set_equals_the_jax_engine(suite_flags):
    """/stats: the JAX engine's key set, block by block (the blocks of
    the modules the port leaves out read as disabled). The kernel
    cache's two compile-plane counters are the one difference."""
    port = port_engine(**CFG)
    jax_eng = jax_engine(**CFG)
    try:
        got, want = port.stats(), jax_eng.stats()
        assert got["schema_version"] == want["schema_version"]
        assert set(got) == set(want)
        for key, block in want.items():
            if not isinstance(block, dict) or key in ("degradation", "device", "health"):
                continue
            missing = set(block) - set(got[key])
            if key == "kernel":
                missing -= {"plane_hits", "plane_stores"}
            assert not missing and set(got[key]) <= set(block), key
        assert set(got["health"]) == set(want["health"])
        assert got["store"]["enabled"] is False and got["journal"]["enabled"] is False
        assert got["mesh"]["devices"] == 1
    finally:
        port.drain()
        jax_eng.drain()


def test_arena_warmup_holds_readiness_until_it_lands(suite_flags):
    """With arena warmup on, readiness reports `arena-warming` until the
    all-halt wave of the dispatch shape has run (on the CPU: no kernel
    library to build)."""
    from mythril_tpu_torch.observe import slo

    engine = port_engine(arena_warmup=True, **CFG)
    try:
        payload = engine.health.healthz_payload()
        assert payload["ready"] is False
        assert slo.NOT_READY_WARMING in payload["not_ready_reasons"]
        engine.start()
        assert engine._warm_done.wait(60.0)
        assert engine.health.healthz_payload()["ready"] is True
    finally:
        engine.drain()


def test_background_warmup_warms_the_bucket_off_the_wave(monkeypatch):
    """specialize_warmup="background": the first wave of a bucket runs
    generic while a warmup thread lands the bucket's first run (under a
    warmup pin of the kernel cache, released after); later waves run the
    bucket."""
    from mythril_tpu_torch.laser.batch import specialize as spec
    from mythril_tpu_torch.service.jobs import Job

    cache = spec.kernel_cache()
    pins = []
    monkeypatch.setattr(cache, "pin_warmup", lambda k, f=cache.pin_warmup: pins.append(k) or f(k))
    with port_flags(**PIN_FLAGS):
        exceptions = dict((l, c) for l, c, _ in chip_smoke.serve_jobs())["exceptions"]
        engine = port_engine(**dict(CFG, max_waves=4, specialize_warmup="background"))
        jobs = run_engine(engine, [(exceptions, {})], Job)
    stats = engine.stats()["kernel"]
    assert jobs[0]["state"] == "done", jobs
    assert stats["warmups_launched"] == 1 and len(pins) == 1
    assert stats["generic_waves"] >= 1 and stats["spec_waves"] >= 1
    assert pins[0].warm_refs == 0
    assert stats["blockjit_blocks"] > 0


def test_failed_arena_warmup_redlines_the_replica(suite_flags, clean_faults, monkeypatch):
    """An arena warmup that fails (here its all-halt wave; on the card also
    a kernel library that does not build or load) is recorded and keeps
    the replica redlined with `arena-warmup-failed`, never ready."""
    from mythril_tpu_torch.observe import slo
    from mythril_tpu_torch.support.resilience import DegradationLog, DegradationReason

    engine = port_engine(arena_warmup=True, **CFG)

    def broken(n):
        raise RuntimeError("kernel library failed to build")

    monkeypatch.setattr(engine, "_halt_batch", broken)
    before = DegradationLog().marker()
    try:
        engine.start()
        assert engine._warm_done.wait(60.0)
        payload = engine.health.healthz_payload()
        assert payload["ready"] is False
        assert slo.REDLINE_WARMUP_FAILED in payload["reasons"]
        assert slo.NOT_READY_REDLINED in payload["not_ready_reasons"]
        since = DegradationLog().counts_since(before)
        assert since.get(DegradationReason.ARENA_WARMUP_FAILED) == 1
    finally:
        engine.drain()


def warm_failing_bucket(engine, monkeypatch, why):
    """Warm the bucket of exceptions.sol.o's phases on `engine`
    (un-started) with the kernel's run raising `why`; returns once the
    warmup thread has ended."""
    from mythril_tpu_torch.laser.batch import specialize as spec

    exceptions = dict((l, c) for l, c, _ in chip_smoke.serve_jobs())["exceptions"]
    phases = engine.code_cache.spec_for(bytes.fromhex(exceptions))["phases"]
    kernel = spec.kernel_cache().get(phases)

    def run(*a, **kw):
        raise why

    monkeypatch.setattr(kernel, "run", run)
    engine._warm_kernel_async(kernel, engine._run_key(engine.alloc.n_lanes, engine._table()))
    engine._warmup_threads[-1].join(60.0)
    return exceptions


def test_failed_bucket_warmup_fails_the_jobs(clean_faults, monkeypatch):
    """A bucket warmup that fails for a reason that is not the card's (a
    kernel that does not build, a bug) is recorded
    (specialize-failed), fed to the kernel breaker and raised on the next
    dispatch: the wave's jobs fail with it instead of running generic."""
    from mythril_tpu_torch.service.jobs import Job, JobState
    from mythril_tpu_torch.support import breaker
    from mythril_tpu_torch.support.resilience import DegradationLog, DegradationReason

    before = DegradationLog().marker()
    with port_flags(**PIN_FLAGS):
        engine = port_engine(**dict(CFG, specialize_warmup="background"))
        code = warm_failing_bucket(engine, monkeypatch, ValueError("bucket build failed"))
        assert DegradationLog().counts_since(before).get(DegradationReason.SPECIALIZE_FAILED) == 1
        assert breaker.breaker("kernel").failures == 1
        assert engine._kernel_warming == set()
        job = engine.submit(Job(code, host_walk=False))
        engine.start()
        try:
            job = engine.queue.wait_terminal(job.id, WAIT_S)
        finally:
            engine.drain()
    assert job.state == JobState.FAILED, job.as_dict()
    assert "bucket build failed" in job.error
    assert engine.waves_total == 0


def test_bucket_warmup_device_faults_open_the_kernel_breaker(clean_faults, monkeypatch):
    """A bucket warmup that faults on the card opens the kernel breaker
    (here at its first failure): /healthz reports `breaker-open:kernel`
    and the waves run the generic interpreter, so the job still settles
    done."""
    from mythril_tpu_torch.service.jobs import Job, JobState
    from mythril_tpu_torch.support import breaker

    breaker.configure("kernel", failure_threshold=1)
    with port_flags(**PIN_FLAGS):
        engine = port_engine(**dict(CFG, specialize_warmup="background"))
        code = warm_failing_bucket(
            engine, monkeypatch, RuntimeError("CUDA error: an illegal memory access"))
        assert engine._kernel_fault is None
        assert "breaker-open:kernel" in engine.health.healthz_payload()["reasons"]
        job = engine.submit(Job(code, host_walk=False))
        engine.start()
        try:
            job = engine.queue.wait_terminal(job.id, WAIT_S)
        finally:
            engine.drain()
    assert job.state == JobState.DONE, job.as_dict()
    stats = engine.stats()["kernel"]
    assert stats["spec_waves"] == 0 and stats["generic_waves"] >= 1


def _checkpoint_arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k != "meta"}


def test_drain_checkpoints_load_across_the_packages(tmp_path, suite_flags):
    """A queued job's drain checkpoint: the port's npz loads in the JAX
    package's load_checkpoint and the JAX engine's in the port's, both
    with the same arrays (the same seeded frontier, bit for bit)."""
    from mythril_tpu.laser.batch.checkpoint import load_checkpoint as jax_load
    from mythril_tpu.service.jobs import Job as JaxJob
    from mythril_tpu_torch.laser.batch.checkpoint import (
        checkpoint_shape,
        load_checkpoint as port_load,
    )
    from mythril_tpu_torch.service.jobs import Job as PortJob

    paths = {}
    for name, make, job_cls in (("port", port_engine, PortJob), ("jax", jax_engine, JaxJob)):
        engine = make(**dict(CFG, checkpoint_dir=str(tmp_path / name)))
        job = job_cls(BRANCHER)
        job.id = job.journey_id = job_id(0)
        engine.submit(job)
        engine.drain()
        assert job.state == "checkpointed", job.as_dict()
        paths[name] = job.checkpoint_path
    port_arrays, jax_arrays = (_checkpoint_arrays(paths[k]) for k in ("port", "jax"))
    assert port_arrays.keys() == jax_arrays.keys()
    for key, value in port_arrays.items():
        assert value.dtype == jax_arrays[key].dtype, key
        assert np.array_equal(value, jax_arrays[key]), key
    batch, code, step = jax_load(paths["port"])
    assert code is not None and step == CFG["steps_per_wave"]
    assert int(np.asarray(batch.calldatasize).max()) > 0
    batch, code, step = port_load(paths["jax"], expect_shape=checkpoint_shape(paths["port"]))
    assert step == CFG["steps_per_wave"] and code is not None


# ---------------------------------------------------------------------------
# faults, quarantine and concurrency
# ---------------------------------------------------------------------------
@pytest.fixture
def clean_faults():
    from mythril_tpu_torch.support import breaker, resilience

    breaker.reset_all()
    resilience.disarm_faults()
    yield
    breaker.reset_all()
    resilience.disarm_faults()


def test_faulted_wave_is_rebuilt_from_its_host_inputs(suite_flags, clean_faults):
    """A device fault surfacing at a wave's harvest sends the wave down
    the resilience ladder: rebuilt from the host inputs on its record
    (the dispatched batch was stepped in place) and run again on the
    engine's device; the jobs' reports equal an unfaulted run's."""
    from mythril_tpu_torch.support import resilience

    clean = port_run(THREE, **CFG)
    resilience.arm_fault("service.harvest", times=1,
                         exc=resilience.InjectedFault("device.harvest"))
    marker = resilience.DegradationLog().marker()
    faulted = port_run(THREE, **CFG)
    assert resilience.fault_fire_count("service.harvest") == 1
    counts = resilience.DegradationLog().counts_since(marker)
    assert counts.get(resilience.DegradationReason.ASYNC_DEVICE_FAULT) == 1, counts
    assert [comparable(j) for j in faulted] == [comparable(j) for j in clean]


def test_wave_faults_strike_then_quarantine(suite_flags, clean_faults):
    """A wave that dies past the whole ladder fails its jobs with a
    strike; the resubmission runs solo and, failing again, is
    quarantined; a third submission settles FAILED at admission with no
    wave (the JAX suite's escalation, tests/service/test_service_recovery.py)."""
    from mythril_tpu_torch.service.jobs import Job, JobState
    from mythril_tpu_torch.support import resilience

    engine = port_engine(**dict(CFG, stripes=1, quarantine_strikes=2)).start()
    try:
        for strike in (1, 2):
            resilience.arm_fault("service.dispatch", times=1,
                                 exc=resilience.InjectedFault("device.dispatch.poisoned"))
            resilience.arm_fault("device.dispatch", times=9999)
            job = engine.queue.wait_terminal(engine.submit(Job(KILLABLE)).id, WAIT_S)
            assert job.state == JobState.FAILED, job.as_dict()
            quarantined = resilience.DegradationReason.QUARANTINED in job.degraded
            assert quarantined == (strike == 2)
        resilience.disarm_faults()
        waves = engine.waves_total
        third = engine.submit(Job(KILLABLE))
        assert third.state == JobState.FAILED and engine.waves_total == waves
        stats = engine.stats()["quarantine"]
        assert stats["denylisted"] == 1 and stats["quarantined"] == 2
    finally:
        engine.drain(timeout_s=30.0)


def test_concurrent_submissions_each_settle_once(suite_flags):
    """More submitting threads than cores, the interpreter's switch
    interval cut short: every accepted job settles exactly once, and
    the queue's and the registry's counts agree."""
    from mythril_tpu_torch.observe.registry import registry
    from mythril_tpu_torch.service.engine import ServiceConfig
    from mythril_tpu_torch.service.server import AnalysisServer

    threads_n, per_thread = 2 * (os.cpu_count() or 4), 2
    settled = registry().counter("mtpu_service_jobs_settled_total")
    before = settled.labels(state="done").value
    interval = sys.getswitchinterval()
    srv = AnalysisServer(ServiceConfig(
        device="cpu", **dict(CFG, max_waves=1, queue_capacity=1024))).start()
    sys.setswitchinterval(1e-5)
    try:
        client = client_of(srv)
        ids, errors = [], []

        def submit():
            try:
                for _ in range(per_thread):
                    ids.append(client.submit(KILLABLE))
            except Exception as why:  # surfaced by the assertion below
                errors.append(why)

        threads = [threading.Thread(target=submit) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        jobs = [client.report(job_id, wait_s=WAIT_S) for job_id in ids]
    finally:
        sys.setswitchinterval(interval)
        srv.close()
    assert len(set(ids)) == len(ids) == threads_n * per_thread
    assert all(j["state"] == "done" and j["report"]["device"]["triggers"]
               == {"selfdestruct": 1} for j in jobs)
    stats = srv.engine.stats()
    assert stats["queue"]["accepted"] == len(ids)
    assert stats["queue"]["jobs"] == {"done": len(ids)}
    assert settled.labels(state="done").value - before == len(ids)


# ---------------------------------------------------------------------------
# the JAX suite's own cases, run against the port's modules
# ---------------------------------------------------------------------------
JAX_CASES = ("tests/service/test_service_allocator.py", "tests/service/test_service_jobs.py")


def port_copy(relpath: str) -> types.ModuleType:
    """The JAX test module at `relpath`, its source with the package
    renamed, as a module of its own: the same test code over the
    port's modules."""
    path = ROOT / relpath
    src = path.read_text().replace("mythril_tpu.", "mythril_tpu_torch.")
    src = src.replace("from mythril_tpu import", "from mythril_tpu_torch import")
    mod = types.ModuleType(f"port_copy_{path.stem}")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def jax_cases(files):
    return [(f, name) for f in files for name in sorted(vars(port_copy(f)))
            if name.startswith("test_")]


@pytest.mark.parametrize("relpath, name", jax_cases(JAX_CASES),
                         ids=lambda v: v.rsplit("/", 1)[-1])
def test_jax_service_case_on_the_port(relpath, name):
    mod = port_copy(relpath)
    imported = [v for v in vars(mod).values()
                if isinstance(v, type) and v.__module__.startswith("mythril_tpu")]
    assert imported and all(v.__module__.startswith("mythril_tpu_torch.") for v in imported)
    getattr(mod, name)()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
REFUSED = [
    (["--devices", "2"], {}, "parallel/mesh.py"),
    (["--journal", "J"], {}, "service/journal.py"),
    (["--recover"], {}, "service/journal.py"),
    (["--kernel-pack", "P"], {}, "compileplane/"),
    (["--kernel-cache", "K"], {}, "compileplane/"),
    ([], {"MYTHRIL_KERNEL_CACHE": "K"}, "compileplane/"),
]


@pytest.mark.parametrize("argv, env, module", REFUSED,
                         ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_serve_refuses_flags_of_unported_modules(argv, env, module, monkeypatch, capsys):
    from mythril_tpu_torch.interfaces import cli

    for key in ("MYTHRIL_STORE_DIR", "MYTHRIL_ROUTER_DIR", "MYTHRIL_KERNEL_CACHE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert cli.main(["serve", "--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert module in err and "not ported" in err, err


def test_serve_and_submit_take_the_jax_flags_and_defaults():
    """Every flag of the JAX `myth serve` and `myth submit` parses in the
    port with the JAX default; the port adds `--device` (both), and its
    `serve` runs lock-step only (`--no-pipeline` parses, as in JAX)."""
    from mythril_tpu.interfaces import cli as jax_cli
    from mythril_tpu_torch.interfaces import cli

    for command, extra in (("serve", ["--port", "0"]), ("submit", ["-c", "33ff"])):
        jax_args = vars(jax_cli.build_parser().parse_args([command, *extra]))
        port_args = vars(cli.build_parser().parse_args([command, *extra]))
        jax_only = {k: v for k, v in jax_args.items()
                    if k not in port_args and k not in ("epic", "v", "command")}
        assert jax_only == {}, jax_only
        for key, value in jax_args.items():
            if key in port_args and key not in ("command",):
                assert port_args[key] == value, (command, key)
    serve = cli.build_parser().parse_args(["serve"])
    assert (serve.no_pipeline, serve.device) == (False, "cuda")
    assert not hasattr(serve, "pipeline")


def test_submit_refuses_an_address(capsys):
    from mythril_tpu_torch.interfaces import cli

    assert cli.main(["submit", "--address", "0x00", "--rpc-url", "http://x"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_serve_subprocess_answers_a_submit(tmp_path):
    """`python -m mythril_tpu_torch serve --port 0 --device cpu` answers a
    `submit` subprocess and drains on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    serve = subprocess.Popen(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port", "0",
         "--device", "cpu", "--no-host-walk", "--no-arena-warmup",
         "--checkpoint-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    )
    try:
        line = serve.stdout.readline()
        assert "listening on http://" in line, (line, serve.stderr.read())
        url = line.split("listening on ")[1].split()[0]
        out = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "submit", "-c", KILLABLE,
             "--url", url, "--wait-s", "120"],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=180,
        )
        assert out.returncode == 0, out.stderr
        job = json.loads(out.stdout)
        assert job["state"] == "done"
        assert job["report"]["device"]["triggers"] == {"selfdestruct": 1}
        serve.send_signal(signal.SIGTERM)
        rest, _ = serve.communicate(timeout=60)
        assert "drained" in rest
        assert serve.returncode == 0
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()


# ---------------------------------------------------------------------------
# the pin (chip_smoke.py's serve phase)
# ---------------------------------------------------------------------------
def scenario(engine, job_cls, device_only=False):
    """chip_smoke.serve_jobs() through `engine` (un-started), in order,
    with fixed ids (`device_only`: every job with the host walk off):
    {label: chip_smoke.serve_fields(job)}."""
    labels, jobs = [], []
    for label, code, kw in chip_smoke.serve_jobs(device_only):
        labels.append(label)
        jobs.append((code, kw))
    done = run_engine(engine, jobs, job_cls)
    return {label: chip_smoke.serve_fields(job) for label, job in zip(labels, done)}


@pytest.mark.parametrize("part", ["small", "small_lockstep", "small_lockstep_walks"])
def test_port_equals_the_pinned_scenario(part):
    """The small arena's parts of the pin: the port on the CPU gives the
    JAX engine's reports, device fields and issues, job by job, with the
    walks on and pipelined ("small"), device-only lock-step
    ("small_lockstep"), and lock-step with the walks on, `serve`'s own
    schedule ("small_lockstep_walks")."""
    from mythril_tpu_torch.service.jobs import Job

    pin = json.loads(PINNED.read_text())[part]
    with port_flags(**PIN_FLAGS):
        got = scenario(port_engine(**pin["config"]), Job, device_only=pin["device_only"])
    assert chip_smoke.serve_differences(got, pin["jobs"]) == []
    assert got["hashkill_deadline"]["degraded"] == ["deadline-expired"]
    assert got["hashkill_deadline"]["waves"] == 1
    assert got["writer"]["static_answered"] and got["brancher"]["static_answered"]


def pin_main() -> None:
    """Regenerate PINNED from the JAX engine on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mythril_tpu.service.jobs import Job
    from mythril_tpu.support.support_args import args

    for key, value in PIN_FLAGS.items():
        setattr(args, key, value)
    out = {"settings": PIN_FLAGS}
    for part, config in (("small", chip_smoke.SERVE_SMALL), ("full", chip_smoke.SERVE_CONFIG)):
        for suffix, pipeline, device_only in (("", True, False), ("_lockstep", False, True),
                                              ("_lockstep_walks", False, False)):
            cfg = dict(config, pipeline=pipeline)
            t0 = time.time()
            out[part + suffix] = {
                "config": cfg, "device_only": device_only,
                "jobs": scenario(jax_engine(**cfg), Job, device_only=device_only),
            }
            print(f"{part}{suffix}: {time.time() - t0:.1f} s", file=sys.stderr)
    PINNED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--pin"]:
        pin_main()
    else:
        sys.exit(f"usage: {sys.argv[0]} --pin")
