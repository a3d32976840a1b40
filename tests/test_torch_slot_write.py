"""The port's per-lane slot write against the JAX package's one-hot merges.

`slot_write_plain` (the plain version the CUDA kernel is held to on the
card) must equal, bit for bit:

- the JAX shadow pass's `symbolic._scatter2`, one and two writes in
  sequence, on [N, S] int32 and uint8 tables;
- the JAX step's nested one-hot stack write (step.py, the consolidated
  stack write: the result slot wins over SWAP's deep slot), rebuilt in
  numpy, on [N, S] and [N, S, W] buffers of every dtype.

Inputs are seeded numpy arrays with about a quarter of the masks off,
indices that run past both ends of the slot axis, and second writes
that land on the first write's slot. The wrapper runs the plain version
on a CPU tensor without counting a launch, and rejects what the kernel
does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.batch.symbolic import _scatter2
from mythril_tpu_torch.ops import slot_write as sw

torch.set_num_threads(1)

N, S, W = 64, 12, 16
NP_OF = {torch.uint8: np.uint8, torch.int32: np.int32, torch.int64: np.int64}


def _inputs(seed, dtype, row):
    """(buf, [(idx, mask, val)] * 2) as numpy; the second write hits the
    first one's slot on about half the lanes."""
    rng = np.random.default_rng(seed)
    npdt = NP_OF[dtype]
    hi = np.iinfo(npdt).max
    lo = np.iinfo(npdt).min

    def values(shape):
        return rng.integers(lo, hi, shape, dtype=npdt, endpoint=True)

    buf = values((N, S) + row)
    writes = []
    for _ in range(2):
        idx = rng.integers(-3, S + 3, N).astype(np.int64)
        mask = rng.random(N) > 0.25
        writes.append([idx, mask, values((N,) + row)])
    same = rng.random(N) > 0.5
    writes[1][0] = np.where(same, writes[0][0], writes[1][0])
    return buf, writes


def _one_hot_nested(buf, writes):
    """The JAX step's nested select: where(oh_second, v2, where(oh_first,
    v1, buf)) over every slot of every lane."""
    slots = np.arange(buf.shape[1])[None, :]
    out = buf
    for idx, mask, val in writes:
        oh = (slots == idx[:, None]) & mask[:, None]
        oh = oh.reshape(oh.shape + (1,) * (buf.ndim - 2))
        out = np.where(oh, val[:, None], out)
    return out


def _port(buf, writes, fn=sw.slot_write_plain):
    t = torch.tensor(buf)
    args = [torch.tensor(x) for w in writes for x in w]
    out = fn(t, *args)
    assert out is t  # in place
    return t.numpy()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64],
                         ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("row", [(), (W,)], ids=["NS", "NSW"])
@pytest.mark.parametrize("n_writes", [1, 2])
def test_plain_equals_one_hot_nesting(dtype, row, n_writes):
    buf, writes = _inputs(7 + n_writes, dtype, row)
    writes = writes[:n_writes]
    got = _port(buf, writes)
    np.testing.assert_array_equal(got, _one_hot_nested(buf, writes))
    assert got.dtype == buf.dtype


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8],
                         ids=lambda d: str(d).split(".")[-1])
def test_plain_equals_jax_scatter2(dtype):
    buf, writes = _inputs(3, dtype, ())
    want = jnp.asarray(buf)
    for k, (idx, mask, val) in enumerate(writes, start=1):
        want = _scatter2(want, jnp.asarray(idx.astype(np.int32)),
                         jnp.asarray(val), jnp.asarray(mask))
        np.testing.assert_array_equal(_port(buf, writes[:k]), np.asarray(want))


def test_out_of_range_writes_nothing_and_second_write_wins():
    buf = np.zeros((3, 4), np.int32)
    idx = np.array([-1, 4, 2])
    mask = np.ones(3, bool)
    got = _port(buf, [[idx, mask, np.array([5, 6, 7], np.int32)],
                      [np.array([0, 0, 2]), np.array([False, True, True]),
                       np.array([8, 9, 10], np.int32)]])
    np.testing.assert_array_equal(got, [[0, 0, 0, 0], [9, 0, 0, 0], [0, 0, 10, 0]])


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    buf, writes = _inputs(11, torch.int32, (W,))
    before = sw.LAUNCHES
    got = _port(buf, writes, fn=sw.slot_write)
    assert sw.LAUNCHES == before
    np.testing.assert_array_equal(got, _one_hot_nested(buf, writes))


def test_wrapper_takes_a_strided_value():
    rng = np.random.default_rng(5)
    buf = torch.zeros((N, S, W), dtype=torch.int32)
    peeked = torch.tensor(rng.integers(0, 1 << 16, (N, 5, W), dtype=np.int32))
    idx = torch.tensor(rng.integers(0, S, N))
    mask = torch.tensor(rng.random(N) > 0.3)
    sw.slot_write(buf, idx, mask, peeked[:, 2])
    want = _one_hot_nested(np.zeros((N, S, W), np.int32),
                           [[idx.numpy(), mask.numpy(), peeked[:, 2].numpy()]])
    np.testing.assert_array_equal(buf.numpy(), want)


def _bad_calls():
    buf = torch.zeros((4, 3, 2), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int64)
    mask = torch.ones(4, dtype=torch.bool)
    val = torch.zeros((4, 2), dtype=torch.int32)
    return {
        "float buffer": (buf.float(), idx, mask, val.float()),
        "1-d buffer": (torch.zeros(4, dtype=torch.int32), idx, mask, val[:, 0]),
        "int32 index": (buf, idx.int(), mask, val),
        "int mask": (buf, idx, mask.int(), val),
        "value dtype": (buf, idx, mask, val.long()),
        "value shape": (buf, idx, mask, val[:, :1]),
        "lane count": (buf, idx[:3], mask[:3], val[:3]),
        "half a second write": (buf, idx, mask, val, idx),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        sw.slot_write(*_bad_calls()[case])
