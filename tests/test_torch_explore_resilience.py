"""The port explorer's fault containment and checkpoints.

- Fault containment (`support/resilience.py`, the port's copy): an
  armed `device.dispatch` fault at a wave's readback is attributed to
  that wave and retried cold from the retained host payload, on the
  first wave and on the in-flight second wave of the pipelined
  schedule; past the whole ladder the exploration degrades (a
  `wave-abandoned` record, frontiers reopened) instead of crashing;
  the retry rebuilds the wave on the explorer's own device, never the
  CPU's. `is_device_fault` takes torch's CUDA faults (OOM, a "CUDA
  error" RuntimeError) and leaves a ValueError to propagate.
  `run_resilient` retries, splits and raises as the JAX one does.
- The device-solve breaker (`support/breaker.py`): faulting flip solves
  trip it open, later waves skip the device stage, and a probe after
  the recovery clock closes or re-opens it.
- Checkpoints (`laser/batch/checkpoint.py`, FORMAT_VERSION 4): a wave
  checkpoint written by the port's explorer loads through the JAX
  package's `load_checkpoint` and replays through its `replay_wave`,
  and one written by the JAX explorer loads and replays in the port,
  with equal fields and equal journals.
"""

import numpy as np
import pytest
import torch

from mythril_tpu_torch.exceptions import DeviceDispatchError, InjectedFault
from mythril_tpu_torch.laser.batch import checkpoint as port_ckpt
from mythril_tpu_torch.laser.batch import explore as port_explore
from mythril_tpu_torch.laser.batch.run import run, run_resilient
from mythril_tpu_torch.laser.batch.state import StateBatch, make_batch, make_code_table
from mythril_tpu_torch.support import resilience

torch.set_num_threads(1)

WRITER = "6001600055600060015500"
BRANCHER = "600035600757005b600160005500"
GATED = "60003560f81c604214600d57005b600160005500"


@pytest.fixture(scope="module", autouse=True)
def ladder_off():
    """The port's host ladder off (a zero cap): the device-solve tests
    count the funnel's retries of a query the ladder leaves open."""
    from mythril_tpu_torch.support.support_args import args

    saved = args.sprint_cap_s
    args.sprint_cap_s = 0.0
    yield
    args.sprint_cap_s = saved


@pytest.fixture(autouse=True)
def _clean_supervisor():
    resilience.disarm_faults()
    resilience.DegradationLog().reset()
    yield
    resilience.disarm_faults()
    resilience.DegradationLog().reset()


def explore(codes, pipeline, **kw):
    for key, value in dict(lanes_per_contract=8, waves=3, steps_per_wave=64,
                           transaction_count=1).items():
        kw.setdefault(key, value)
    ex = port_explore.DeviceCorpusExplorer(codes, pipeline=pipeline, device="cpu", **kw)
    return ex, ex.run()


def _journals(view, lanes):
    return {(pc, taken) for lane in range(lanes) for pc, taken, _ in view.journal(lane)}


# -- classification -----------------------------------------------------------
def _accelerator_error():
    accel = getattr(torch, "AcceleratorError", None)
    if not isinstance(accel, type):
        return None
    try:
        return accel("CUDA error: an illegal memory access was encountered")
    except TypeError:
        return None


@pytest.mark.parametrize("exc, fault", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (InjectedFault("device.dispatch"), True),
    (InjectedFault("solver.cdcl"), False),
    (ValueError("CUDA error: not from the card"), False),
    (RuntimeError("shape mismatch"), False),
    (KeyError("CUDA error"), False),
], ids=["oom", "illegal-address", "device-assert", "injected", "injected-solver",
        "valueerror", "runtimeerror", "keyerror"])
def test_is_device_fault_classifies_torch_faults(exc, fault):
    assert resilience.is_device_fault(exc) is fault


def test_is_device_fault_takes_accelerator_error_where_torch_has_it():
    exc = _accelerator_error()
    if exc is None:
        pytest.skip("this torch has no constructible torch.AcceleratorError")
    assert resilience.is_device_fault(exc)


# -- the explorer's ladder ------------------------------------------------------
@pytest.mark.parametrize("skip", [0, 1], ids=["first-wave", "inflight-second-wave"])
def test_readback_fault_is_attributed_and_retried(skip):
    """skip=0 faults wave 0's harvest; skip=1 lets it through and faults
    the in-flight wave 1: the retry rebuilds exactly that wave, and the
    record names it."""
    resilience.arm_fault("device.dispatch", times=1, skip=skip)
    ex, out = explore([BRANCHER], True)
    log = resilience.DegradationLog()
    assert log.counts.get("async-device-fault") == 1
    (rec,) = [e for e in log.events if e["reason"] == "async-device-fault"]
    assert rec["site"] == f"wave#{skip}"
    assert out["stats"]["device_faults"] == 0  # recovered, not abandoned
    assert out["stats"]["waves"] >= 2
    clean = explore([BRANCHER], True)[1]
    assert out["contracts"][0]["covered_branches"] == clean["contracts"][0]["covered_branches"]


def test_retry_rebuilds_the_wave_cold_on_the_explorers_device(monkeypatch):
    built = []
    real = port_explore.make_batch

    def spy(n, *args, **kw):
        built.append(kw.get("device"))
        return real(n, *args, **kw)

    monkeypatch.setattr(port_explore, "make_batch", spy)
    resilience.arm_fault("device.dispatch", times=1, skip=1)
    ex, out = explore([BRANCHER], True, waves=2)
    assert resilience.DegradationLog().counts.get("async-device-fault") == 1
    # waves 0 and 1 built cold (nothing to reseed into yet), then wave 1
    # rebuilt cold by the retry: every build on the explorer's device
    assert built == [ex.device] * 3
    assert out["stats"]["waves"] == 2


@pytest.mark.parametrize("pipeline", [False, True], ids=["lockstep", "pipelined"])
def test_exhausted_ladder_degrades_not_crashes(pipeline):
    resilience.arm_fault("device.dispatch", times=99)
    ex, out = explore([WRITER], pipeline, waves=2)
    assert out["stats"]["device_faults"] == 1
    assert not out["contracts"][0]["device_complete"]
    assert resilience.DegradationLog().counts.get("wave-abandoned") == 1


def test_sticky_cuda_error_leaves_the_ladder_and_degrades():
    """A sticky CUDA error fails every retry again: it leaves the ladder
    as DeviceDispatchError and the exploration degrades."""
    resilience.arm_fault("device.dispatch", times=99, exc=RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    _, out = explore([WRITER], True, waves=2)
    assert out["stats"]["device_faults"] == 1
    counts = resilience.DegradationLog().counts
    assert counts.get("wave-abandoned") == 1 and counts.get("device-dispatch-failed") == 2


def test_logic_errors_do_not_enter_the_ladder():
    resilience.arm_fault("device.dispatch", times=1, exc=ValueError("a bug"))
    with pytest.raises(ValueError, match="a bug"):
        explore([WRITER], True, waves=2)
    assert resilience.DegradationLog().counts == {}


def test_explorer_deadline_stops_at_wave_boundary():
    ex, out = explore([WRITER], True, waves=4, transaction_count=2,
                      deadline=resilience.Deadline(0.0))
    assert out["stats"]["waves"] == 0
    assert out["stats"]["halt_reason"] == "deadline-expired"
    assert not out["contracts"][0]["device_complete"]


# -- the device-solve breaker ----------------------------------------------------
def test_device_solve_faults_trip_the_breaker_and_later_waves_skip_the_stage(monkeypatch):
    """GATED's flip query comes back every wave (the zero-cap ladder
    keeps it retriable). Two faulting solves trip the breaker open; the two
    later reseeds route around the device stage; each fault is one
    degradation record, and the run ends with its coverage."""
    from mythril_tpu_torch.laser.smt.solver import portfolio
    from mythril_tpu_torch.support import breaker

    calls = []

    def sick(queries, **_kw):
        calls.append(len(queries))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(portfolio, "device_solve_batch", sick)
    br = breaker.configure(breaker.TIER_DEVICE_SOLVE, failure_threshold=2, recovery_s=3600)
    try:
        ex, out = explore([GATED], False, lanes_per_contract=4, waves=5, seed=5)
    finally:
        breaker.reset_all()
    assert calls == [1, 1]
    assert (br.state, br.trips, br.failures) == (breaker.STATE_OPEN, 1, 2)
    log = resilience.DegradationLog()
    assert log.counts == {"device-dispatch-failed": 2}
    assert [r["lowered"] for r in ex.reseed_log] == [1, 1, 1, 1]
    assert [r["solve_ms"] for r in ex.reseed_log[2:]] == [0.0, 0.0]
    assert ex.ladder_deferred == 4
    assert out["stats"]["waves"] == 5 and out["stats"]["device_sat"] == 0
    assert (11, False) in {tuple(b) for b in out["contracts"][0]["covered_branches"]}


@pytest.mark.parametrize("probe_ok, state", [(True, "closed"), (False, "open")],
                         ids=["probe-succeeds", "probe-fails"])
def test_breaker_half_open_probe_closes_or_reopens(probe_ok, state):
    from mythril_tpu_torch.support import breaker

    now = [0.0]
    br = breaker.CircuitBreaker(breaker.TIER_DEVICE_SOLVE, failure_threshold=1,
                                recovery_s=10.0, clock=lambda: now[0])
    br.record_failure("first")
    assert (br.state, br.allow()) == ("open", False)
    now[0] = 10.0
    assert (br.state, br.allow()) == ("half-open", True)
    if probe_ok:
        br.record_success()
    else:
        br.record_failure("probe")
    assert br.state == state and br.trips == (1 if probe_ok else 2)


# -- run_resilient ----------------------------------------------------------------
def _demo():
    code = bytes.fromhex("600160005401600055600035601057005b00")
    batch = make_batch(4, code_ids=np.zeros(4, np.int32),
                       calldata=[bytes([i]) * 32 for i in range(4)], device="cpu")
    return batch, make_code_table([code], device="cpu")


def test_run_resilient_retries_then_splits_then_raises():
    batch, code = _demo()
    direct, steps = run(batch, code, max_steps=64)
    resilience.arm_fault("device.dispatch", times=1)
    out, got = run_resilient(batch, code, max_steps=64)
    assert got == steps and torch.equal(out.status, direct.status)
    assert resilience.DegradationLog().counts == {"device-dispatch-failed": 1}
    # the whole-batch ladder (3 attempts) fails, the halves pass
    resilience.arm_fault("device.dispatch", times=3)
    out, got = run_resilient(batch, code, max_steps=64, unroll=2)
    want, want_steps = run(batch, code, max_steps=64, unroll=2)
    assert got == want_steps
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert resilience.DegradationLog().counts["device-split-dispatch"] == 1
    resilience.arm_fault("device.dispatch", times=99)
    with pytest.raises(DeviceDispatchError):
        run_resilient(batch, code, max_steps=64, retries=1, allow_split=False)


# -- checkpoints across the packages ----------------------------------------------
def _field_arrays(batch):
    return {name: np.asarray(getattr(batch, name)) for name in StateBatch._fields}


def test_port_checkpoint_loads_and_replays_in_jax(tmp_path):
    import jax

    from mythril_tpu.laser.batch import checkpoint as jax_ckpt
    from mythril_tpu.laser.batch.explore import replay_wave as jax_replay

    path = str(tmp_path / "port_wave.npz")
    ex, out = explore([BRANCHER], False, waves=1, checkpoint_path=path)
    assert out["stats"]["wave_checkpoints"] == 1
    assert jax_ckpt.checkpoint_shape(path) == port_ckpt.checkpoint_shape(path)
    jb, jcode, jsteps = jax_ckpt.load_checkpoint(path)
    pb, pcode, psteps = port_ckpt.load_checkpoint(path)
    assert jsteps == psteps == 64
    for name, arr in _field_arrays(pb).items():
        got = np.asarray(getattr(jb, name))
        assert got.dtype == arr.dtype and np.array_equal(got, arr), name
    for name in ("ops", "jumpdest", "length"):
        assert np.array_equal(np.asarray(getattr(jcode, name)), getattr(pcode, name))
    jview, _, _ = jax_replay(path)
    pview, _, _ = port_explore.replay_wave(path, device="cpu")
    covered = {tuple(b) for b in out["contracts"][0]["covered_branches"]}
    assert _journals(jview, 8) == _journals(pview, 8) == covered
    assert jax.device_get(jview.status).tolist() == pview.status.tolist()


def test_jax_checkpoint_loads_and_replays_in_the_port(tmp_path, monkeypatch):
    from mythril_tpu.laser.batch import checkpoint as jax_ckpt
    from mythril_tpu.laser.batch import explore as jax_explore
    from mythril_tpu.support.support_args import args as jax_args

    monkeypatch.setattr(jax_args, "static_prune", False)
    monkeypatch.setattr(jax_args, "specialize", False)
    path = str(tmp_path / "jax_wave.npz")
    jex = jax_explore.DeviceCorpusExplorer(
        [BRANCHER], lanes_per_contract=8, waves=1, steps_per_wave=64,
        transaction_count=1, checkpoint_path=path, pipeline=False)
    out = jex.run()
    assert out["stats"]["wave_checkpoints"] == 1
    jb, _, _ = jax_ckpt.load_checkpoint(path)
    pb, _, steps = port_ckpt.load_checkpoint(path, expect_shape={"lanes": 8})
    assert steps == 64
    for name, arr in _field_arrays(pb).items():
        assert np.array_equal(np.asarray(getattr(jb, name)), arr), name
    with pytest.raises(ValueError, match="different arena shape"):
        port_ckpt.load_checkpoint(path, expect_shape={"lanes": 16})
    view, _, _ = port_explore.replay_wave(path, device="cpu")
    assert _journals(view, 8) == {tuple(b) for b in out["contracts"][0]["covered_branches"]}


def test_pipelined_checkpoints_flush_every_wave_and_replay(tmp_path):
    path = str(tmp_path / "wave.npz")
    ex, out = explore([BRANCHER], True, waves=2, checkpoint_path=path)
    assert out["stats"]["wave_checkpoints"] == out["stats"]["waves"]
    assert port_ckpt.checkpoint_shape(path)["lanes"] == 8
    view, _, steps = port_explore.replay_wave(path, device="cpu")
    assert steps > 0
    assert _journals(view, 8) <= {tuple(b) for b in out["contracts"][0]["covered_branches"]}
