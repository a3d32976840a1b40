"""The port's SHA3 sponge against the JAX package's keccak and step.

`keccak_sponge_plain` (the plain version the CUDA sponge kernel is held
to on the card) must give, for every lane where `ok` is set, the u256
word of keccak-256 over ``mem[lane, off:off+len]``, equal to the JAX
package's `keccak256_word`, its `support/keccak.py` oracle and the
port's own oracle:

- at lengths around the 136-byte rate and the 1087-byte hash cap, at
  unaligned offsets and at windows that end at the row's end;
- with a length of 0 at an offset far past the row (`BIGOFF`) or
  negative, which must read nothing and hash ``b""``;
- zero outside `ok`, and zero for lengths the step never hashes.

One JAX `step` and one port `step` over a batch parked at SHA3 (lengths
1087 and 1088 among the lanes) must agree in every StateBatch field. The
CUDA wrapper on CPU tensors runs the plain version, counts no launch and
rejects what the kernel does not take. Inputs are seeded numpy arrays;
the tolerance is exact equality.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu.laser.batch.state import StateBatch as JaxBatch
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu.laser.batch.step import step as jax_step
from mythril_tpu.ops import keccak as jk
from mythril_tpu.support.keccak import keccak256 as oracle_jax_pkg
from mythril_tpu_torch import interop
from mythril_tpu_torch.ops import keccak as tk
from mythril_tpu_torch.ops import keccak_cuda
from mythril_tpu_torch.support.keccak import keccak256_int

torch.set_num_threads(1)

port_step = importlib.import_module("mythril_tpu_torch.laser.batch.step")

CAP = 1200  # bytes per row: 1087-byte windows fit at offsets up to 113
LENGTHS = [0, 1, 31, 32, 135, 136, 137, 271, 272, 1087]
BIGOFF = port_step.BIGOFF


def _word_int(limbs):
    return sum(int(v) << (16 * k) for k, v in enumerate(limbs))


def _sponge(mem, off, length, ok):
    return tk.keccak_sponge_plain(torch.from_numpy(mem), torch.tensor(off, dtype=torch.int32),
                                  torch.tensor(length, dtype=torch.int32),
                                  torch.tensor(ok)).numpy()


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_matches_jax_and_oracles(length):
    """Offsets 0, 1, 3, 7 and the window ending at the row's end."""
    rng = np.random.default_rng(length)
    offs = [0, 1, 3, 7, CAP - length]
    mem = rng.integers(0, 256, (len(offs), CAP), dtype=np.uint8)
    got = _sponge(mem, offs, [length] * len(offs), np.ones(len(offs), bool))
    assert got.dtype == np.int32 and got.shape == (len(offs), 16)
    msgs = np.stack([mem[i, o:o + length] for i, o in enumerate(offs)])
    np.testing.assert_array_equal(got, np.asarray(jk.keccak256_word(jnp.asarray(msgs))))
    for i, o in enumerate(offs):
        data = mem[i, o:o + length].tobytes()
        assert _word_int(got[i]) == keccak256_int(data)
        assert _word_int(got[i]).to_bytes(32, "big") == oracle_jax_pkg(data)


def test_length_zero_reads_nothing_at_any_offset():
    offs = [BIGOFF, -1, -(1 << 31), CAP, CAP + 5, (1 << 31) - 1]
    mem = np.full((len(offs), CAP), 0xAB, np.uint8)
    got = _sponge(mem, offs, [0] * len(offs), np.ones(len(offs), bool))
    for row in got:
        assert _word_int(row) == keccak256_int(b"")


def test_zero_outside_ok_and_for_lengths_the_step_never_hashes():
    rng = np.random.default_rng(9)
    mem = rng.integers(0, 256, (6, CAP), dtype=np.uint8)
    length = [64, 64, 1088, -1, -200, 64]
    ok = np.array([False, True, True, True, True, False])
    got = _sponge(mem, [3] * 6, length, ok)
    assert _word_int(got[1]) == keccak256_int(mem[1, 3:67].tobytes())
    np.testing.assert_array_equal(got[[0, 2, 3, 4, 5]], 0)


def test_bytes_past_the_row_read_as_zero():
    """The plain version's clamp and mask: a window that runs past the
    row hashes the bytes inside it followed by zeros."""
    rng = np.random.default_rng(10)
    mem = rng.integers(0, 256, (1, CAP), dtype=np.uint8)
    got = _sponge(mem, [CAP - 10], [40], np.ones(1, bool))
    assert _word_int(got[0]) == keccak256_int(mem[0, CAP - 10:].tobytes() + bytes(30))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(11)
    mem = torch.from_numpy(rng.integers(0, 256, (8, CAP), dtype=np.uint8))
    off = torch.tensor(rng.integers(0, 100, 8), dtype=torch.int32)
    length = torch.tensor(rng.integers(0, 1088, 8), dtype=torch.int32)
    ok = torch.tensor(rng.random(8) > 0.3)
    before = (keccak_cuda.LAUNCHES, keccak_cuda.SPONGE_LAUNCHES)
    got = keccak_cuda.keccak_sponge(mem, off, length, ok)
    assert (keccak_cuda.LAUNCHES, keccak_cuda.SPONGE_LAUNCHES) == before
    assert torch.equal(got, tk.keccak_sponge_plain(mem, off, length, ok))


def _bad_calls():
    mem = torch.zeros((4, 64), dtype=torch.uint8)
    off = torch.zeros(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    return {
        "int32 memory": (mem.int(), off, off, ok),
        "1-d memory": (mem[0], off, off, ok),
        "int64 offset": (mem, off.long(), off, ok),
        "int64 length": (mem, off, off.long(), ok),
        "int ok": (mem, off, off, ok.int()),
        "lane count": (mem, off[:3], off, ok),
        "2-d length": (mem, off, off[:, None], ok),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        keccak_cuda.keccak_sponge(*_bad_calls()[case])


# ---- one step of SHA3, JAX against the port -------------------------------

# (offset, length) per lane: 1087 ending at the row's end, 1088 (past the
# hash cap: UNSUPPORTED), unaligned windows, length 0 at offsets far past
# the row, and a window past the row (memory expansion sends it to the
# host)
STEP_LANES = [(CAP - 1087, 1087), (0, 1088), (3, 1087), (5, 271), (7, 136),
              (BIGOFF, 0), (1 << 40, 0), (CAP - 100, 200), (0, 0), (1, 32)]


def _word(value):
    return [(value >> (16 * k)) & 0xFFFF for k in range(16)]


def _sha3_batch():
    n = len(STEP_LANES)
    rng = np.random.default_rng(12)
    fields = jax_make_batch(n, mem_cap=CAP, as_numpy=True)
    stack = fields.stack.copy()
    for lane, (off, length) in enumerate(STEP_LANES):
        stack[lane, 0] = _word(length)  # SHA3 pops the offset (top), then the length
        stack[lane, 1] = _word(off)
    return fields._replace(
        stack=stack, sp=np.full(n, 2, np.int32),
        mem=rng.integers(0, 256, (n, CAP), dtype=np.uint8),
        msize_words=np.full(n, CAP // 32, np.int32))


def test_one_sha3_step_matches_jax_in_every_field():
    fields = _sha3_batch()
    table = jax_make_code_table([bytes([0x20, 0x00])])  # SHA3; STOP
    ref = jax.device_get(jax.jit(jax_step)(JaxBatch(*(jnp.asarray(x) for x in fields)),
                                           table))
    port = interop.batch_to_numpy(port_step.step(
        interop.batch_from_numpy(fields, device="cpu"),
        interop.code_table_from_numpy(tuple(np.asarray(x) for x in table), device="cpu")))
    for name in JaxBatch._fields:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the lanes hashed on the device hold the oracle's digest; 1088 went
    # to the host
    assert port.status[1] == port_step.Status.UNSUPPORTED
    for lane, (off, length) in enumerate(STEP_LANES):
        if port.status[lane] != port_step.Status.RUNNING:
            continue
        data = fields.mem[lane, off:off + length].tobytes() if length else b""
        assert _word_int(port.stack[lane, 0]) == keccak256_int(data), lane


# ---- the path's calls into the kernel wrappers ----------------------------

# SHA3 over 64 bytes of memory, SSTORE of the digest to slot 1, then a
# taken JUMPI to a JUMPDEST and STOP
WRAPPER_PROGRAM = bytes([0x60, 0x40, 0x60, 0x00, 0x20, 0x60, 0x01, 0x55,
                         0x60, 0x01, 0x60, 0x0D, 0x57, 0x5B, 0x00])


def test_run_calls_each_wrapper_once_for_its_phase(monkeypatch):
    """`run` on the CPU hashes through one `keccak_sponge` call for the
    SHA3 step and writes the tables that share an index (storage keys and
    values; the branch journal's pc and taken) through one
    `slot_write_many` call each, as it launches on the card."""
    from mythril_tpu_torch.laser.batch import make_batch, make_code_table, run
    from mythril_tpu_torch.laser.batch.state import storage_dict

    calls = []

    def counted(name, fn):
        def wrapper(*args):
            calls.append((name, len(args[2]) if name == "slot_write_many" else None))
            return fn(*args)
        return wrapper

    monkeypatch.setattr(keccak_cuda, "keccak_sponge",
                        counted("keccak_sponge", keccak_cuda.keccak_sponge))
    monkeypatch.setattr(port_step, "slot_write_many",
                        counted("slot_write_many", port_step.slot_write_many))
    lanes = 4
    batch = make_batch(lanes, device="cpu")
    code = make_code_table([WRAPPER_PROGRAM], device="cpu")
    out, _ = run(batch, code, max_steps=16)
    assert calls == [("keccak_sponge", None), ("slot_write_many", 2), ("slot_write_many", 2)]
    digest = keccak256_int(bytes(64))
    for lane in range(lanes):
        assert out.status[lane] == port_step.Status.STOPPED
        assert storage_dict(out, lane) == {1: digest}
