"""The VMTests the device cannot finish alone, through the port's hybrid
replay on the CPU.

mythril_tpu_torch/laser/vmtests_device_verdicts.json pins the device's
verdicts (the JAX package's, `hybrid=False`, no straggler re-run): 529
pass and 7 skip. `run_cases` with its defaults (`hybrid=True`, the
straggler re-run) must pass all seven, as the JAX package's hybrid
manifest (tests/laser/vmtests_manifest.json) does: the four forever-OOG
loops and the two stack-limit loops finish in the long re-run, and
sha3_bigOffset2 (SHA3 past the device's memory) finishes on the host
engine (laser/batch/takeover.py). All seven run as one batch (about
50 s on one CPU core: the forever-OOG loops take some 25k steps).
"""

import json
from pathlib import Path

import pytest
import torch

from mythril_tpu_torch.laser import conformance as tconf

torch.set_num_threads(1)

PINNED = json.loads((Path(tconf.__file__).with_name(
    "vmtests_device_verdicts.json")).read_text())["verdicts"]
SKIPPED = sorted(name for name, verdict in PINNED.items() if verdict != "pass")


@pytest.fixture(scope="module")
def hybrid_verdicts():
    cases, _ = tconf.load_vmtests()
    return tconf.run_cases([c for c in cases if c.name in SKIPPED], device="cpu")


def test_the_device_skips_seven():
    assert len(PINNED) == 536 and len(SKIPPED) == 7


@pytest.mark.parametrize("name", SKIPPED)
def test_device_skip_passes_in_the_hybrid_replay(name, hybrid_verdicts):
    assert hybrid_verdicts[name] == "pass"


def test_the_jax_manifest_passes_them_too():
    manifest = json.loads((Path(__file__).parent / "laser" / "vmtests_manifest.json").read_text())
    assert manifest["total_pass"] == 536
