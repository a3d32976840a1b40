"""The port's `run` against the JAX package's `run`, every StateBatch field.

Four program sets share ONE batch (one JAX compile): the hand-assembled
programs of tests/laser/test_batch_vm.py, 48 seeded random straight-line
programs in the style of tests/laser/test_engine_differential.py, SHA3
over 0, 135, 136, 1087 and 1088 bytes (1088 exceeds HASH_CAP and must
hand the lane to the host as UNSUPPORTED), and uint32/int32 edges (gas
wrapping past 2**32, offsets in [2**31, 2**32)). A fourth set is the
benchmark's demo loop at 64 lanes for 64 steps, with and without the
coverage bitmap. Inputs are numpy arrays fed to both engines; the
tolerance is exact equality, field by field, dtype included.
"""

import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_memory import release_jax_executables  # noqa: F401

from mythril_tpu.disassembler.asm import assemble, push
from mythril_tpu.laser.batch.run import run as jax_run
from mythril_tpu.laser.batch.state import StateBatch as JaxBatch
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser.batch.run import run as port_run
from mythril_tpu_torch.laser.batch.state import TORCH_DTYPES, Status, storage_dict
from mythril_tpu_torch.support.keccak import keccak256_int

# small tensors: torch's intra-op threads would only contend with the
# other test workers
torch.set_num_threads(1)

# the module (the package's `step` attribute is the function)
port_step = importlib.import_module("mythril_tpu_torch.laser.batch.step")

M = 1 << 256
MAX_STEPS = 320
CODE_CAP = 256


def _ss(slot, valsrc):
    return valsrc + [push(slot), "SSTORE"]


def _batch_vm_programs():
    """(code, calldata, callvalue, gas_budget, empty_world) per lane, the
    programs of tests/laser/test_batch_vm.py."""
    minus2 = M - 2
    cd = bytes.fromhex("a9059cbb") + (0x1234).to_bytes(32, "big")
    loop = [push(0), push(10), "JUMPDEST", "DUP1", "ISZERO", push(0x15),
            "JUMPI", "DUP1", "SWAP2", "ADD", "SWAP1", push(1), "SWAP1", "SUB",
            push(0x04), "JUMP", "JUMPDEST", "POP", push(0), "SSTORE", "STOP"]
    srcs = [
        (_ss(0, [push(3), push(4), "ADD"]) + _ss(1, [push(3), push(10), "SUB"])
         + _ss(2, [push(6), push(7), "MUL"]) + _ss(3, [push(3), push(100), "DIV"])
         + _ss(4, [push(7), push(100), "MOD"]) + _ss(5, [push(10), push(2), "EXP"])
         + _ss(6, [push(5), push(3), push(4), "ADDMOD"])
         + _ss(7, [push(5), push(3), push(4), "MULMOD"]) + ["STOP"], b""),
        ([push(1), push(2), push(3), "SWAP2", "DUP3", "STOP"], b""),
        (_ss(0, [push(2), push(1), "LT"]) + _ss(1, [push(1), push(2), "LT"])
         + _ss(2, [push(0xF0), push(0x0F), "OR"]) + _ss(3, [push(1), "NOT"])
         + _ss(4, [push(0), "ISZERO"]) + _ss(5, [push(2), push(1), "SHL"])
         + ["STOP"], b""),
        ([push(0xDEADBEEF), push(0x20), "MSTORE"] + _ss(0, [push(0x20), "MLOAD"])
         + _ss(1, ["MSIZE"]) + [push(0xAB), push(0x5F), "MSTORE8"]
         + _ss(2, [push(0x40), "MLOAD"]) + ["STOP"], b""),
        (loop, b""),
        (_ss(0, [push(0), "CALLDATALOAD", push(0xE0), "SHR"])
         + _ss(1, [push(4), "CALLDATALOAD"]) + _ss(2, ["CALLDATASIZE"])
         + _ss(3, [push(32), push(4), push(0), "CALLDATACOPY", push(0), "MLOAD"])
         + ["STOP"], cd),
        (_ss(0, [push(64), push(0), "SHA3"]) + ["STOP"], b""),
        ([push(0x0102030405060708), push(0x20), "MSTORE"]
         + _ss(0, [push(0x40), push(0), "SHA3"]) + ["STOP"], b""),
        ([push(0xCAFE), push(0), "MSTORE", push(32), push(0), "RETURN"], b""),
        ([push(0), push(0), "REVERT"], b""),
        ([push(1), "JUMP", "STOP"], b""),
        (["ADD", "STOP"], b""),
        (bytes([0xFE]), b""),
        (bytes([0x21]), b""),
        ([push(0)] * 3 + ["CREATE"], b""),
        ([push(0)] * 7 + ["CALL", "STOP"], b""),
        ([push(0)] * 5 + ["ADDRESS"] + [push(0)] + ["CALL"], b""),
        ([push(1), "POP"], b""),
        (_ss(0, ["CALLVALUE"]) + _ss(1, ["CALLER"]) + _ss(2, ["ADDRESS"])
         + _ss(3, ["TIMESTAMP"]) + _ss(4, ["NUMBER"]) + _ss(5, ["CHAINID"])
         + _ss(6, ["CODESIZE"]) + ["STOP"], b""),
        (_ss(0, [push(minus2), push(7), "SDIV"]) + _ss(1, [push(3), push(minus2), "SMOD"])
         + _ss(2, [push(minus2), push(1), "SLT"]) + _ss(3, [push(1), push(minus2), "SLT"])
         + ["STOP"], b""),
        ([push(1), push(2), "ADD", push(0), "SSTORE", "STOP"], b""),
        ([push(7), push(5), "SSTORE", push(9), push(5), "SSTORE"]
         + _ss(1, [push(5), "SLOAD"]) + _ss(2, [push(99), "SLOAD"]) + ["STOP"], b""),
        (_ss(0, [push(2), push(5), "ADD"]) + ["STOP"], b""),
        (_ss(0, [push(0), "CALLDATALOAD"]) + ["STOP"], (11).to_bytes(32, "big")),
        ([push(0), "JUMP"], b""),
        ([push(0), "POP", "PC"], b""),
    ]
    lanes = [(assemble(s) if not isinstance(s, bytes) else s, d, 0, 8_000_000, 1)
             for s, d in srcs]
    lanes[18] = lanes[18][:2] + (123,) + lanes[18][3:]  # env opcodes: callvalue
    # an MSTORE just below 2**31 must run out of gas, not wrap
    lanes.append((bytes.fromhex("6001") + bytes([0x63, 0x7F, 0xFF, 0xFF, 0xE1])
                  + bytes.fromhex("5200"), b"", 0, 1000, 1))
    extcode = bytes([0x30, 0x3B, 0x60, 0x00, 0x55, 0x61, 0xBE, 0xEF, 0x3B, 0x60,
                     0x01, 0x55, 0x60, 0x00, 0x60, 0x00, 0x60, 0x00, 0x3E, 0x00])
    lanes.append((extcode, b"", 0, 8_000_000, 1))
    lanes.append((extcode, b"", 0, 8_000_000, 0))
    lanes.append((bytes([0x60, 0x01, 0x60, 0x00, 0x60, 0x00, 0x3E, 0x00]),
                  b"", 0, 8_000_000, 1))
    return lanes


ARITH = [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x0A, 0x0B, 0x10,
         0x11, 0x12, 0x13, 0x14, 0x16, 0x17, 0x18, 0x1A, 0x1B, 0x1C, 0x1D]
TERNARY = [0x08, 0x09]  # addmod, mulmod
UNARY = [0x15, 0x19]  # iszero, not


def random_program(rng: random.Random, n_ops: int = 24) -> bytes:
    """Straight-line program with an exact stack-depth model, draining
    the stack into storage slots at the end."""
    code = bytearray()
    depth = 0
    for _ in range(n_ops):
        choice = rng.random()
        if depth >= 2 and choice < 0.45:
            code.append(rng.choice(ARITH))
            depth -= 1
        elif depth >= 3 and choice < 0.55:
            code.append(rng.choice(TERNARY))
            depth -= 2
        elif depth >= 1 and choice < 0.65:
            code.append(rng.choice(UNARY))
        elif depth >= 1 and choice < 0.72 and depth < 14:
            code.append(0x80 + rng.randrange(min(depth, 4)))  # DUPn
            depth += 1
        else:
            n = rng.randrange(1, 5)
            code.append(0x60 + n - 1)  # PUSHn
            code += rng.randbytes(n)
            depth += 1
    slot = 0
    while depth > 0:
        code += bytes([0x60, slot, 0x55])  # PUSH1 slot; SSTORE
        depth -= 1
        slot += 1
    code.append(0x00)  # STOP
    return bytes(code)


SHA_LENGTHS = [0, 135, 136, 1087, 1088]


def _sha3_program(length: int) -> bytes:
    """Fill memory with nonzero words, then SHA3(0, length) -> slot 0."""
    src = []
    for off in (0, 100, 131, 500, 1000, 1056):
        src += [push(0x0102030405060708090A0B0C0D0E0F10 + off), push(off), "MSTORE"]
    return assemble(src + _ss(0, [push(length), push(0), "SHA3"]) + ["STOP"])


U32 = 2**32


def _wrap_programs():
    """uint32/int32 edges: gas_min wrapping past 2**32 (lanes start near
    it), offsets in [2**31, 2**32) that must count as huge, and the
    float32 memory-gas estimate at its boundary."""
    cd = bytes(range(1, 33))
    big4 = push  # every big4 value is >= 2**31: a PUSH4
    progs = [
        # (source, calldata, gas_budget, starting gas_min)
        ([push(1), push(0), "SSTORE", "STOP"], b"", U32 - 1, U32 - 3),
        (["GAS", push(0), "SSTORE", "STOP"], b"", U32 - 1, U32 - 1),
        ([push(0x42), big4(0x80000000), "MSTORE", "STOP"], b"", 8_000_000, 0),
        ([big4(0x80000001), "CALLDATALOAD", push(0), "SSTORE", "STOP"], cd, 8_000_000, 0),
        ([big4(0xFFFFFFE0), "CALLDATALOAD", push(0), "SSTORE", "STOP"], cd, 8_000_000, 0),
        ([push(0), big4(0x80000000), "SHA3", push(0), "SSTORE", "STOP"], b"", 8_000_000, 0),
        ([push(0), big4(0xFFFFFFFF), "RETURN"], b"", 8_000_000, 0),
        ([push(32), big4(0x80000000), push(0), "CALLDATACOPY", push(0), "MLOAD",
          push(0), "SSTORE", "STOP"], cd, 8_000_000, 0),
        ([big4(0x80000000), push(0), "LOG0", "STOP"], b"", 8_000_000, 0),
        ([big4(0x80000005), "JUMP", "JUMPDEST", "STOP"], b"", 8_000_000, 0),
    ]
    # an MSTORE far past the memory cap, with budgets on both sides of
    # the float32 expansion-gas estimate: OOG above it, ERR_MEM below
    words = 1_000_001
    wf = np.float32(words)
    est = int((np.float32(3.0) * wf + wf * wf / np.float32(512.0)) - np.float32(0.0))
    # (gas_left = budget - 8; float32 spacing there is 128)
    for budget in (est - 300, est - 56, est + 7, est + 8, est + 9, est + 300):
        progs.append(([push(0x42), push(32 * words - 32), "MSTORE", "STOP"], b"",
                      budget, 0))
    return [(assemble(src), d, 0, budget, 1, gmin) for src, d, budget, gmin in progs]


def _sets():
    rng = random.Random(1234)
    sets = {
        "batch_vm": _batch_vm_programs(),
        "random": [(random_program(rng), b"", 0, 8_000_000, 1) for _ in range(48)],
        "sha3": [(_sha3_program(n), b"", 0, 8_000_000, 1) for n in SHA_LENGTHS],
        "wrap": _wrap_programs(),
    }
    slices, lanes, start = {}, [], 0
    for name, rows in sets.items():
        slices[name] = slice(start, start + len(rows))
        lanes += rows
        start += len(rows)
    return slices, lanes


SLICES, LANES = _sets()


def _inputs(lanes, code_cap):
    codes = [lane[0] for lane in lanes]
    table = jax_make_code_table(codes, code_cap=code_cap)
    fields = jax_make_batch(
        len(lanes), code_ids=np.arange(len(lanes)),
        calldata=[lane[1] for lane in lanes],
        callvalue=[lane[2] for lane in lanes],
        empty_world=np.array([lane[4] for lane in lanes], np.uint8),
        as_numpy=True)
    fields = fields._replace(
        gas_budget=np.array([lane[3] for lane in lanes], np.uint32),
        gas_min=np.array([lane[5] if len(lane) > 5 else 0 for lane in lanes], np.uint32),
        gas_max=np.array([lane[5] if len(lane) > 5 else 0 for lane in lanes], np.uint32))
    return fields, tuple(np.asarray(x) for x in table)


def run_both(fields, table, max_steps, track_coverage=True):
    """(port final as numpy, JAX final as numpy, port steps, JAX steps)."""
    jfinal, jsteps = jax_run(
        JaxBatch(*(jnp.asarray(x) for x in fields)),
        type(jax_make_code_table([b"\x00"]))(*(jnp.asarray(x) for x in table)),
        max_steps=max_steps, track_coverage=track_coverage)
    pfinal, psteps = port_run(
        interop.batch_from_numpy(fields, device="cpu"),
        interop.code_table_from_numpy(table, device="cpu"),
        max_steps=max_steps, track_coverage=track_coverage)
    return (interop.batch_to_numpy(pfinal), jax.device_get(jfinal),
            psteps, int(jsteps))


def assert_fields_equal(port, ref, lanes=slice(None)):
    for name in JaxBatch._fields:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got[lanes], want[lanes], err_msg=name)


@pytest.fixture(scope="module")
def mixed():
    fields, table = _inputs(LANES, CODE_CAP)
    return fields, table, run_both(fields, table, MAX_STEPS)


@pytest.mark.parametrize("set_name", sorted(SLICES))
def test_run_matches_jax_on_program_set(set_name, mixed):
    _, _, (port, ref, psteps, jsteps) = mixed
    assert psteps == jsteps
    assert_fields_equal(port, ref, SLICES[set_name])


def test_every_lane_halted_inside_the_budget(mixed):
    _, _, (port, _, psteps, _) = mixed
    assert psteps < MAX_STEPS
    assert not (port.status == Status.RUNNING).any()


def test_memory_gas_boundary_lanes_straddle_oog(mixed):
    """The float32 estimate decides OOG vs ERR_MEM on both sides."""
    _, _, (port, _, _, _) = mixed
    tail = port.status[SLICES["wrap"]][-6:].tolist()
    assert Status.ERR_OOG in tail and Status.ERR_MEM in tail, tail


def test_sha3_lengths_hash_like_the_oracle(mixed):
    fields, _, (port, _, _, _) = mixed
    sl = SLICES["sha3"]
    for k, length in enumerate(SHA_LENGTHS):
        lane = sl.start + k
        if length > 1087:
            assert int(port.status[lane]) == Status.UNSUPPORTED
            continue
        assert int(port.status[lane]) == Status.STOPPED
        mem = bytes(port.mem[lane, :length].tolist())
        assert storage_dict(port, lane).get(0) == keccak256_int(mem)


def test_phases_forced_open_change_nothing(mixed, monkeypatch):
    """Every handler is mask-correct: running all of them every step
    gives the same final state as gating them."""
    fields, table, (port, _, psteps, _) = mixed
    monkeypatch.setattr(port_step, "_present", lambda op, ex: frozenset(range(256)))
    forced, steps = port_run(
        interop.batch_from_numpy(fields, device="cpu"),
        interop.code_table_from_numpy(table, device="cpu"),
        max_steps=MAX_STEPS)
    assert steps == psteps
    assert_fields_equal(interop.batch_to_numpy(forced), port)


def test_run_keeps_every_field_dtype():
    """The port's own tensors keep the dtypes of `state.TORCH_DTYPES`
    through every handler (interop would hide a drift: it converts)."""
    fields, table = _inputs(LANES[SLICES["batch_vm"]], CODE_CAP)
    final, _ = port_run(interop.batch_from_numpy(fields, device="cpu"),
                        interop.code_table_from_numpy(table, device="cpu"),
                        max_steps=MAX_STEPS)
    assert {n: t.dtype for n, t in zip(final._fields, final)} == TORCH_DTYPES


def test_run_leaves_its_input_batch_unchanged():
    fields, table = _inputs(LANES[:4], CODE_CAP)
    batch = interop.batch_from_numpy(fields, device="cpu")
    before = [t.clone() for t in batch]
    port_run(batch, interop.code_table_from_numpy(table, device="cpu"), max_steps=8)
    assert all(torch.equal(x, y) for x, y in zip(before, batch))


DEMO = bytes([
    0x5B, 0x60, 0x00, 0x35, 0x60, 0x03, 0x02, 0x60, 0x07, 0x01, 0x60, 0x00,
    0x55, 0x60, 0x00, 0x54, 0x33, 0x14, 0x50, 0x42, 0x50, 0x60, 0x00, 0x56,
])


@pytest.mark.parametrize("track_coverage", [True, False])
def test_demo_loop_matches_jax(track_coverage):
    rng = np.random.default_rng(0)
    lanes = [(DEMO, rng.integers(0, 256, 36, dtype=np.uint8).tobytes(), 0,
              8_000_000, 1) for _ in range(64)]
    fields, table = _inputs(lanes, None)
    port, ref, psteps, jsteps = run_both(fields, table, 64, track_coverage)
    assert psteps == jsteps == 64
    assert_fields_equal(port, ref)
    assert (port.pc_seen != 0).any() == track_coverage
