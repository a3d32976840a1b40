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


# ---- slot_write_many: tables that share one (idx, mask) --------------------

def _many_inputs(seed):
    """(idx, mask, [(buf, val)]) as numpy: uint8, int32 and int64 tables of
    7, 12 and 64 slots with rows of 1, 3 and 16 elements; indices run past
    both ends of the narrow tables."""
    rng = np.random.default_rng(seed)

    def values(shape, npdt):
        info = np.iinfo(npdt)
        return rng.integers(info.min, info.max, shape, dtype=npdt, endpoint=True)

    idx = rng.integers(-3, 15, N).astype(np.int64)
    mask = rng.random(N) > 0.25
    tables = [(values((N, 12), np.int32), values((N,), np.int32)),
              (values((N, 12, W), np.int32), values((N, W), np.int32)),
              (values((N, 12), np.int64), values((N,), np.int64)),
              (values((N, 64), np.uint8), values((N,), np.uint8)),
              (values((N, 7, 3), np.int32), values((N, 3), np.int32)),
              (values((N, 12, 8), np.uint8), values((N, 8), np.uint8))]
    return idx, mask, tables


def _torch_tables(tables):
    return [(torch.tensor(b), torch.tensor(v)) for b, v in tables]


@pytest.mark.parametrize("fn", ["slot_write_many_plain", "slot_write_many"])
def test_many_equals_one_table_at_a_time_and_the_one_hot_merge(fn):
    idx, mask, tables = _many_inputs(21)
    got = _torch_tables(tables)
    getattr(sw, fn)(torch.tensor(idx), torch.tensor(mask), got)
    for (buf, val), (out, _) in zip(tables, got):
        one = _port(buf, [[idx, mask, val]])
        np.testing.assert_array_equal(out.numpy(), one)
        np.testing.assert_array_equal(out.numpy(), _one_hot_nested(buf, [[idx, mask, val]]))


def test_many_wrapper_on_cpu_counts_nothing():
    idx, mask, tables = _many_inputs(22)
    before = (sw.LAUNCHES, sw.MANY_LAUNCHES)
    sw.slot_write_many(torch.tensor(idx), torch.tensor(mask), _torch_tables(tables))
    assert (sw.LAUNCHES, sw.MANY_LAUNCHES) == before


@pytest.mark.parametrize("lanes", [0, 4])
@pytest.mark.parametrize("many", [False, True])
def test_launch_counts_only_where_it_launches(monkeypatch, lanes, many):
    """Both counters rise at the one launch site, once per launch; a call
    with no lanes launches nothing and counts nothing."""
    launched = []
    monkeypatch.setattr(sw.build, "launch", lambda *args: launched.append(args))
    monkeypatch.setattr(sw, "_kernel_fn", lambda: None)
    buf = torch.zeros((lanes, 3, 2), dtype=torch.int32)
    idx = torch.zeros(lanes, dtype=torch.int64)
    mask = torch.ones(lanes, dtype=torch.bool)
    val = torch.zeros((lanes, 2), dtype=torch.int32)
    before = (sw.LAUNCHES, sw.MANY_LAUNCHES)
    sw._launch(idx, mask, None, None, [(buf, val, None)], 2, many=many)
    rose = int(lanes > 0)
    assert len(launched) == rose
    assert (sw.LAUNCHES, sw.MANY_LAUNCHES) == (before[0] + rose, before[1] + rose * many)


def _bad_many_calls():
    buf = torch.zeros((4, 3, 2), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int64)
    mask = torch.ones(4, dtype=torch.bool)
    val = torch.zeros((4, 2), dtype=torch.int32)
    return {
        "no table": (idx, mask, []),
        "nine tables": (idx, mask, [(buf, val)] * 9),
        "lane count": (idx, mask, [(buf, val), (buf[:3], val[:3])]),
        "value dtype": (idx, mask, [(buf, val.long())]),
        "float buffer": (idx, mask, [(buf.float(), val.float())]),
        "int32 index": (idx.int(), mask, [(buf, val)]),
        "int mask": (idx, mask.int(), [(buf, val)]),
    }


@pytest.mark.parametrize("case", sorted(_bad_many_calls()))
def test_many_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        sw.slot_write_many(*_bad_many_calls()[case])


def _unpack_desc(buf, val, val2=None):
    names = ("buf", "val", "val2", "b_lane", "b_slot", "b_vec", "v_lane", "v_vec",
             "v2_lane", "v2_vec", "slots", "vecs", "width")
    return dict(zip(names, sw._DESC.unpack(sw._desc(buf, val, val2))))


def test_descriptor_moves_contiguous_rows_in_the_widest_vector():
    """The kernel's vector width: a 64 B int32 stack row moves as four
    16 B vectors; a 12 B row as three 4 B ones; a value whose row is
    strided (a column of a gather) element by element; a second write
    carries its own strides."""
    stack = torch.zeros((N, S, W), dtype=torch.int32)
    d = _unpack_desc(stack, torch.zeros((N, W), dtype=torch.int32))
    assert (d["width"], d["vecs"], d["b_vec"], d["v_vec"]) == (16, 4, 16, 16)
    assert (d["b_lane"], d["b_slot"], d["v_lane"], d["slots"]) == (S * W * 4, W * 4, W * 4, S)
    d = _unpack_desc(torch.zeros((N, 7, 3), dtype=torch.int32),
                     torch.zeros((N, 3), dtype=torch.int32))
    assert (d["width"], d["vecs"]) == (4, 3)
    d = _unpack_desc(torch.zeros((N, S), dtype=torch.int64), torch.zeros(N, dtype=torch.int64))
    assert (d["width"], d["vecs"], d["v_lane"]) == (8, 1, 8)
    gathered = torch.zeros((N, W, 5), dtype=torch.int32)
    d = _unpack_desc(stack, gathered[:, :, 1])
    assert (d["width"], d["vecs"], d["b_vec"], d["v_vec"], d["v_lane"]) == (4, W, 4, 20, W * 20)
    second = torch.zeros((N, 5, W), dtype=torch.int32)[:, 2]
    d = _unpack_desc(stack, torch.zeros((N, W), dtype=torch.int32), second)
    assert (d["width"], d["v2_lane"], d["v2_vec"]) == (16, 5 * W * 4, 16)
    assert d["val2"] == second.data_ptr()
