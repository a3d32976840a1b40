"""The port's batch construction against the JAX package's.

`make_batch` and `make_code_table` (device="cpu") against the JAX
`make_batch(..., as_numpy=True)` and `make_code_table`, with storage
seeds, per-lane callvalue and balance, metadata-tailed code, and
non-default capacities; plus the `interop` round trips and the host
views. Tolerance: exact equality, dtypes included.
"""

import numpy as np
import pytest
import torch

from mythril_tpu.laser.batch import state as jstate
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser.batch import state as tstate

# small tensors: torch's intra-op threads would only contend with the
# other test workers
torch.set_num_threads(1)

# runtime code with a solc CBOR metadata tail (bzzr key, 2-byte length)
META = b"\xa1\x65bzzr0\x58\x20" + bytes(range(32)) + b"\x00\x29"
CODES = [
    bytes([0x60, 0x01, 0x60, 0x02, 0x01, 0x5B, 0x00]),
    bytes([0x7F]) + bytes(range(32)) + bytes([0x5B, 0x56]) + META,
    bytes([0x5B, 0x60, 0x5B, 0x5B]),
]

SEEDS = [{1: 2, 2**255: 7}, None, {5: 0, 6: 2**256 - 1}, {}]
CALLVALUES = [0, 1, 2**200, 2**256 - 1]


def _compare(port_batch, ref):
    np_port = interop.batch_to_numpy(port_batch)
    for name in jstate.StateBatch._fields:
        got, want = getattr(np_port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("code_cap", [None, 64])
def test_make_code_table_matches_jax(code_cap):
    ref = jstate.make_code_table(CODES, code_cap=code_cap)
    got = tstate.make_code_table(CODES, code_cap=code_cap, device="cpu")
    for name, g, r in zip(("ops", "jumpdest", "length"), got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("variant", ["defaults", "seeded", "caps"])
def test_make_batch_matches_jax(variant):
    rng = np.random.default_rng(7)
    calldata = [rng.integers(0, 256, k, dtype=np.uint8).tobytes()
                for k in (0, 4, 36, 600)]
    kwargs = {
        "defaults": {},
        "seeded": dict(code_ids=[0, 2, 1, 0], calldata=calldata,
                       callvalue=CALLVALUES, balance=[5, 0, 2**100, 1],
                       storage_seed=SEEDS, gas_budget=12345,
                       empty_world=np.array([1, 0, 1, 0], np.uint8)),
        "caps": dict(mem_cap=256, calldata_cap=64, storage_cap=8, stack_cap=1024,
                     calldata=calldata, callvalue=9, empty_world=False),
    }[variant]
    ref = jstate.make_batch(4, as_numpy=True, **kwargs)
    _compare(tstate.make_batch(4, device="cpu", **kwargs), ref)


def test_make_batch_numpy_is_the_jax_layout():
    kwargs = dict(callvalue=CALLVALUES, storage_seed=SEEDS)
    ref = jstate.make_batch(4, as_numpy=True, **kwargs)
    got = tstate.make_batch_numpy(4, **kwargs)
    for name in jstate.StateBatch._fields:
        g, r = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_interop_round_trip_is_exact_including_uint32_top_bits():
    fields = jstate.make_batch(3, as_numpy=True, storage_seed=SEEDS[:3])
    fields = fields._replace(
        gas_min=np.array([0, 2**32 - 1, 2**31], np.uint32),
        gas_budget=np.array([2**32 - 1, 1, 2**31 + 5], np.uint32),
        pc_seen=np.full_like(fields.pc_seen, 0x80000001),
    )
    batch = interop.batch_from_numpy(fields, device="cpu")
    assert batch.pc_seen.dtype == torch.int32 and batch.gas_min.dtype == torch.int64
    assert int(batch.gas_min[1]) == 2**32 - 1
    _compare(batch, fields)


def test_batch_from_numpy_copies_its_input():
    fields = jstate.make_batch(2, as_numpy=True)
    batch = interop.batch_from_numpy(fields, device="cpu")
    batch.pc_seen[0, 0] = 1
    batch.stack[0, 0, 0] = 1
    assert fields.pc_seen[0, 0] == 0 and fields.stack[0, 0, 0] == 0


def test_code_table_from_numpy_matches_make_code_table():
    ref = jstate.make_code_table(CODES, code_cap=64)
    got = interop.code_table_from_numpy(tuple(np.asarray(x) for x in ref), device="cpu")
    mine = tstate.make_code_table(CODES, code_cap=64, device="cpu")
    for g, m in zip(got, mine):
        assert torch.equal(g, m)


def test_host_views_match_jax():
    fields = jstate.make_batch(4, as_numpy=True, storage_seed=SEEDS)
    fields.stack[1, :3] = np.stack([jstate.u256.from_int(v) for v in (1, 2**255, 3)])
    fields = fields._replace(sp=np.array([0, 3, 0, 0], np.int32))
    fields.mem[2, 10:14] = [1, 2, 3, 4]
    batch = interop.batch_from_numpy(fields, device="cpu")
    for lane in range(4):
        assert tstate.storage_dict(batch, lane) == jstate.storage_dict(fields, lane)
        assert tstate.stack_list(batch, lane) == jstate.stack_list(fields, lane)
        assert tstate.mem_bytes(batch, lane, 8, 8) == jstate.mem_bytes(fields, lane, 8, 8)
    tables = (batch.storage_keys, batch.storage_vals, batch.storage_cnt)
    assert tstate.storage_dict_from(tables, 0) == {1: 2, 2**255: 7}


def test_constants_and_status_codes_match_jax():
    for name in ("STACK_CAP", "MEM_CAP", "STORAGE_CAP", "CALLDATA_CAP", "SHA_RATE",
                 "SHA_MAX_BLOCKS", "HASH_CAP", "PC_BITMAP_WORDS", "BRANCH_CAP"):
        assert getattr(tstate, name) == getattr(jstate, name), name
    for name in dir(jstate.Status):
        if not name.startswith("_"):
            assert getattr(tstate.Status, name) == getattr(jstate.Status, name), name
    assert tstate.StateBatch._fields == jstate.StateBatch._fields
    assert tstate.CodeTable._fields == jstate.CodeTable._fields
