"""The port stands alone: no jax, nothing of the JAX package.

A subprocess imports `mythril_tpu_torch`, runs a 4-lane CPU `run` and a
4-lane symbolic wave (`sym_run`, `ArenaView`, `reseed_wave`), and
checks that `jax` never entered `sys.modules` and that no module of the
JAX package did either. A source scan finds no import of either in the
port's files or in chip_smoke.py. Without a CUDA device, an entry point
called with no device raises instead of carrying on on the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import sys
from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
from mythril_tpu_torch.laser.batch.state import storage_dict
from mythril_tpu_torch.laser import conformance  # noqa: F401
from mythril_tpu_torch import interop  # noqa: F401
from mythril_tpu_torch.support import accel
code = bytes([0x60, 0x05, 0x60, 0x03, 0x02, 0x60, 0x00, 0x55, 0x00])
out, steps = run(make_batch(4, device="cpu"), make_code_table([code], device="cpu"))
assert [storage_dict(out, i) for i in range(4)] == [{0: 15}] * 4, out
accel.probe()
from mythril_tpu_torch.laser import symbolic_wave
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.batch.symbolic import reseed_wave, sym_run
symb, table = symbolic_wave.make_wave(2, 2, device="cpu")
out, steps, active = sym_run(symb, table, max_steps=64)
view = ArenaView(out)
assert steps > 0 and view.count > 0, (steps, view.count)
reseed_wave(out, *(t.numpy() for t in (symb.base.code_id, symb.base.calldata,
    symb.base.calldatasize, symb.base.callvalue, symb.base.balance,
    symb.base.storage_keys, symb.base.storage_vals, symb.base.storage_cnt)),
    symb.base.storage_cnt.numpy() > 0)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "mythril_tpu" or m.startswith("mythril_tpu."))
print("BAD", bad)
"""

# an import statement (or importlib call) naming jax, or the JAX package
# (mythril_tpu not followed by _torch)
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|mythril_tpu\b(?!_torch))"
    r"|import_module\(\s*['\"](?:jax|mythril_tpu(?!_torch))",
    re.MULTILINE,
)


def test_port_runs_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def _sources():
    return sorted((ROOT / "mythril_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import lax", "import jax.numpy as jnp",
                 "from mythril_tpu.ops import u256", "import mythril_tpu",
                 "importlib.import_module('mythril_tpu.ops')"):
        assert FORBIDDEN.search(line), line
    for line in ("from mythril_tpu_torch.ops import u256", "import torch",
                 "# the JAX package's mythril_tpu/ops/u256.py"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_without_device_raise_where_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mythril_tpu_torch import interop
    from mythril_tpu_torch.laser import symbolic_wave
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table
    from mythril_tpu_torch.laser.conformance import run_cases
    from mythril_tpu_torch.ops.keccak import keccak256

    wave_np = interop.symbatch_to_numpy(symbolic_wave.make_wave(1, 2, device="cpu")[0])
    for call in (lambda: make_batch(2), lambda: make_code_table([b"\x00"]),
                 lambda: run_cases([]), lambda: keccak256(b""),
                 lambda: symbolic_wave.make_wave(1, 2),
                 lambda: interop.symbatch_from_numpy(wave_np)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_probe_reports_without_choosing():
    from mythril_tpu_torch.support import accel

    info = accel.probe()
    assert info["cuda"] == torch.cuda.is_available()
    assert set(info) >= {"cuda", "capability", "sm90a", "kernels_built"}
