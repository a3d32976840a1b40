"""VMTests replay on the port against the JAX package's, field by field.

One `build_batch` over every case of vmSha3Test, vmBitwiseLogicOperation
and vmPushDupSwapTest plus 16 seeded cases from each other suite, run
for 256 steps by both engines: every StateBatch field must be equal, and
the port's `run_cases(hybrid=False)` verdicts must equal the JAX
`run_cases(hybrid=False)` verdicts on the same subset.

The pinned full-corpus verdicts that chip_smoke.py holds the card
against (mythril_tpu_torch/laser/vmtests_device_verdicts.json) come from
the JAX package. Regenerate them with

    python tests/test_torch_conformance.py --pin
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu.laser import conformance as jconf
from mythril_tpu.laser.batch.run import run as jax_run
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser import conformance as tconf
from mythril_tpu_torch.laser.batch.run import run as port_run

# small tensors: torch's intra-op threads would only contend with the
# other test workers
torch.set_num_threads(1)

MAX_STEPS = 256
FULL_SUITES = ("vmSha3Test", "vmBitwiseLogicOperation", "vmPushDupSwapTest")
PINNED = Path(tconf.__file__).with_name("vmtests_device_verdicts.json")
PIN_SETTINGS = {"max_steps": 4096, "straggler_steps": 0, "hybrid": False}


def _subset(cases):
    rng = np.random.default_rng(2024)
    picked = []
    for suite in tconf.SUITES:
        rows = [c for c in cases if c.suite == suite]
        if suite not in FULL_SUITES and len(rows) > 16:
            rows = [rows[i] for i in sorted(rng.choice(len(rows), 16, replace=False))]
        picked += rows
    return picked


@pytest.fixture(scope="module")
def cases():
    port_cases, port_skips = tconf.load_vmtests()
    jax_cases, jax_skips = jconf.load_vmtests(tconf.VMTESTS_ROOT)
    assert port_cases == jax_cases and port_skips == jax_skips
    return _subset(port_cases)


@pytest.fixture(scope="module")
def finals(cases):
    jbatch, jtable = jconf.build_batch(cases)
    jfinal, jsteps = jax_run(jbatch, jtable, max_steps=MAX_STEPS, track_coverage=False)
    pbatch, ptable = tconf.build_batch(cases, device="cpu")
    pfinal, psteps = port_run(pbatch, ptable, max_steps=MAX_STEPS, track_coverage=False)
    return (interop.batch_to_numpy(pbatch), jax.device_get(jbatch),
            interop.batch_to_numpy(pfinal), jax.device_get(jfinal),
            psteps, int(jsteps))


def test_subset_covers_every_suite(cases):
    assert {c.suite for c in cases} == {s for s in tconf.SUITES
                                        if (tconf.VMTESTS_ROOT / s).is_dir()}
    assert len(cases) > 200


def test_build_batch_matches_jax(finals):
    pinit, jinit = finals[0], finals[1]
    for name in jinit._fields:
        want = np.asarray(getattr(jinit, name))
        got = getattr(pinit, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("field", ["status", "pc", "sp", "stack", "mem",
                                   "msize_words", "storage", "gas", "rest"])
def test_final_state_matches_jax(finals, field):
    port, ref, psteps, jsteps = finals[2:]
    assert psteps == jsteps
    names = {
        "storage": ("storage_keys", "storage_vals", "storage_cnt"),
        "gas": ("gas_min", "gas_max", "gas_budget"),
    }.get(field, (field,))
    if field == "rest":
        named = {"status", "pc", "sp", "stack", "mem", "msize_words",
                 "storage_keys", "storage_vals", "storage_cnt",
                 "gas_min", "gas_max", "gas_budget"}
        names = tuple(n for n in ref._fields if n not in named)
    for name in names:
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_verdicts_match_jax(cases):
    jax_verdicts = jconf.run_cases(cases, max_steps=MAX_STEPS, hybrid=False,
                                   straggler_steps=0)
    port_verdicts = tconf.run_cases(cases, max_steps=MAX_STEPS, hybrid=False,
                                    straggler_steps=0, device="cpu")
    assert port_verdicts == jax_verdicts
    assert not [v for v in port_verdicts.values() if v.startswith("fail")]


def test_hybrid_is_not_ported_yet(cases):
    """The hybrid replay is ported, and the default: on lanes the device
    finishes it changes no verdict (tests/test_torch_walk_vmtests.py
    holds the lanes it takes over)."""
    plain = tconf.run_cases(cases[:4], hybrid=False, straggler_steps=0, device="cpu")
    assert tconf.run_cases(cases[:4], straggler_steps=0, device="cpu") == plain
    assert set(plain.values()) == {"pass"}


def test_pinned_verdicts_cover_the_corpus():
    pinned = json.loads(PINNED.read_text())
    assert pinned["settings"] == PIN_SETTINGS
    names = {c.name for c in tconf.load_vmtests()[0]}
    assert set(pinned["verdicts"]) == names
    assert not [v for v in pinned["verdicts"].values() if v.startswith("fail")]


def _pin():
    cases, _ = jconf.load_vmtests(tconf.VMTESTS_ROOT)
    verdicts = jconf.run_cases(cases, **PIN_SETTINGS)
    PINNED.write_text(json.dumps({"settings": PIN_SETTINGS, "verdicts": verdicts},
                                 indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(verdicts)} verdicts to {PINNED}")


if __name__ == "__main__" and "--pin" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _pin()
