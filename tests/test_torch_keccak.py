"""The port's keccak against the JAX package's and the pure-Python oracle.

The plain `keccak_f` is held against `mythril_tpu.ops.keccak.keccak_f`,
the Pallas kernel's bit-exact XLA twin (the Pallas interpret mode is too
slow on the CPU), on seeded random states; `keccak256` against the JAX
`keccak256` and `mythril_tpu.support.keccak` at the lengths around the
136-byte rate. The CUDA wrapper on a CPU tensor takes the plain path and
launches nothing. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

import jax.numpy as jnp

from mythril_tpu.ops import keccak as jk
from mythril_tpu.support.keccak import keccak256 as oracle_jax_pkg
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import keccak as tk
from mythril_tpu_torch.ops import keccak_cuda
from mythril_tpu_torch.support import keccak as port_oracle

# small tensors: torch's intra-op threads would only contend with the
# other test workers
torch.set_num_threads(1)

LENGTHS = [0, 1, 32, 64, 135, 136, 137, 300]


def _random_lohi(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (n, 25), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, (n, 25), dtype=np.uint64).astype(np.uint32))


def test_keccak_f_matches_jax_twin():
    lo, hi = _random_lohi(0, 64)
    lo[0], hi[0] = 0, 0  # the all-zero state
    ref_lo, ref_hi = jk.keccak_f(jnp.asarray(lo), jnp.asarray(hi))
    out = tk.keccak_f(interop.lanes_from_lohi(lo, hi, device="cpu"))
    got_lo, got_hi = interop.lanes_to_lohi(out)
    np.testing.assert_array_equal(got_lo, np.asarray(ref_lo))
    np.testing.assert_array_equal(got_hi, np.asarray(ref_hi))


def test_keccak_f_matches_python_oracle():
    lo, hi = _random_lohi(1, 4)
    lanes = interop.lanes_from_lohi(lo, hi, device="cpu")
    out = tk.keccak_f(lanes).numpy().view(np.uint64)
    for i in range(4):
        want = port_oracle.keccak_f([int(x) for x in lanes[i].numpy().view(np.uint64)])
        assert [int(x) for x in out[i]] == want


def test_lane_conversions_round_trip():
    lo, hi = _random_lohi(2, 8)
    back_lo, back_hi = interop.lanes_to_lohi(interop.lanes_from_lohi(lo, hi, device="cpu"))
    np.testing.assert_array_equal(back_lo, lo)
    np.testing.assert_array_equal(back_hi, hi)


@pytest.mark.parametrize("length", LENGTHS)
def test_keccak256_matches_jax_and_oracles(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = tk.keccak256(torch.from_numpy(msgs)).numpy()
    ref = np.asarray(jk.keccak256(jnp.asarray(msgs)))
    np.testing.assert_array_equal(got, ref)
    for i in range(3):
        data = msgs[i].tobytes()
        assert got[i].tobytes() == port_oracle.keccak256(data) == oracle_jax_pkg(data)


def test_keccak256_word_and_bytes_entry():
    word = tk.keccak256_word(b"", device="cpu")
    assert word.dtype == torch.int32 and word.shape == (16,)
    want = port_oracle.keccak256_int(b"")
    assert sum(int(v) << (16 * i) for i, v in enumerate(word.tolist())) == want
    np.testing.assert_array_equal(
        word.numpy(), np.asarray(jk.keccak256_word(jnp.zeros((0,), jnp.uint8))))


def test_cuda_wrapper_on_cpu_takes_plain_path_without_launch():
    lo, hi = _random_lohi(3, 5)
    lanes = interop.lanes_from_lohi(lo, hi, device="cpu")
    before = keccak_cuda.LAUNCHES
    out = keccak_cuda.keccak_f(lanes)
    assert keccak_cuda.LAUNCHES == before
    assert torch.equal(out, tk.keccak_f(lanes))


def test_cuda_wrapper_rejects_wrong_dtype_and_shape():
    with pytest.raises(ValueError):
        keccak_cuda.keccak_f(torch.zeros((2, 25), dtype=torch.int32))
    with pytest.raises(ValueError):
        keccak_cuda.keccak_f(torch.zeros((2, 24), dtype=torch.int64))


def test_keccak256_bytes_without_device_raises_where_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.keccak256(b"abc")
