"""The port's symbolic shadow wave against the JAX package's, every field.

One batch of hand-assembled programs, one per lane, exercises each
shadow handler: calldata taint through MSTORE/MLOAD, MSTORE8, the
CALLDATACOPY and CODECOPY windows (also past mem_cap), SHA3 over tainted
and clean windows and with lengths whose low 32 bits wrap the int32
negative, windows wider than the shadow's per-lane window, SSTORE/SLOAD tids with misses and a full journal, JUMPI
condition terms, ADD/SUB/MUL wraps and sites with the bank's dedup and
overflow at EVENT_CAP, the CALL family in an empty world with the
balance taint, the environment leaves, BLOCKHASH provenance through
ISZERO/NOT, and seeded random straight-line programs over tainted
words. Both engines run the batch twice, from an empty arena and from
`ar_count = ARENA_CAP - 3` (arena overflow), with one code table and one
lane count so JAX compiles `sym_run` once. Inputs are numpy arrays fed
to both; the tolerance is exact equality, field by field, dtype
included. `reseed_wave` is held to the JAX `reseed_wave` the same way.
"""

import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.batch.state import StateBatch as JaxBatch
from mythril_tpu.laser.batch.state import make_batch as jax_make_batch
from mythril_tpu.laser.batch.state import make_code_table as jax_make_code_table
from mythril_tpu.laser.batch.symbolic import SymBatch as JaxSym
from mythril_tpu.laser.batch.symbolic import make_sym_batch as jax_make_sym_batch
from mythril_tpu.laser.batch.symbolic import reseed_wave as jax_reseed_wave
from mythril_tpu.laser.batch.symbolic import sym_run as jax_sym_run
from mythril_tpu_torch import interop
from mythril_tpu_torch.laser.batch import symbolic as sym
from mythril_tpu_torch.laser.batch.state import make_batch, Status
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support import hostsync
from mythril_tpu_torch.support.opcodes import OPCODES

torch.set_num_threads(1)

port_step = importlib.import_module("mythril_tpu_torch.laser.batch.step")

MAX_STEPS = 400
MEM_CAP = 1024
STORAGE_CAP = 8
CD_LEN = 68
TOP = (1 << 256) - 1


def asm(items) -> bytes:
    """Opcode names; ints (smallest PUSH); ("push", n, v) for a PUSHn;
    ("label", name) for a JUMPDEST; ("ref", name) for a PUSH2 of it."""
    def size(it):
        if isinstance(it, str):
            return 1
        if isinstance(it, int):
            return 1 + max(1, (it.bit_length() + 7) // 8)
        return {"push": 1 + (it[1] if it[0] == "push" else 0), "label": 1, "ref": 3}[it[0]]

    where, pos = {}, 0
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            where[it[1]] = pos
        pos += size(it)
    out = bytearray()
    for it in items:
        if isinstance(it, str):
            out.append(OPCODES[it][0])
        elif isinstance(it, int):
            n = max(1, (it.bit_length() + 7) // 8)
            out += bytes([0x5F + n]) + it.to_bytes(n, "big")
        elif it[0] == "push":
            out += bytes([0x5F + it[1]]) + it[2].to_bytes(it[1], "big")
        elif it[0] == "label":
            out.append(OPCODES["JUMPDEST"][0])
        else:
            out += bytes([0x61]) + where[it[1]].to_bytes(2, "big")
    return bytes(out)


def byte_of(off):
    """A tainted small value: calldata byte `off` (CALLDATALOAD >> 248)."""
    return [off, "CALLDATALOAD", 0xF8, "SHR"]


def call(kind, gas, value=None, addr=0x1234567890ABCDEF):
    args = [0, 0, 0, 0] + ([] if value is None else value) + [addr, gas, kind]
    return args


PROGRAMS = {
    "taint_mstore_mload": [
        0, "CALLDATALOAD", 0x20, "MSTORE", 0x20, "MLOAD", 1, "ADD", 0, "SSTORE",
        0x30, "MLOAD", 1, "SSTORE", *byte_of(4), "MLOAD", 2, "SSTORE",
        *byte_of(5), 0x20, "ADD", "MLOAD", 3, "SSTORE", "STOP"],
    "mstore_tainted_offset": [
        0, "CALLDATALOAD", *byte_of(4), "MSTORE", 0, "MLOAD", 0, "SSTORE",
        5, *byte_of(6), "MSTORE", 0x80, "MLOAD", 1, "SSTORE", "STOP"],
    "mstore8": [
        0, "CALLDATALOAD", 5, "MSTORE8", 0x41, 6, "MSTORE8", 0, "MLOAD", 0, "SSTORE",
        0x41, *byte_of(7), "MSTORE8", "STOP"],
    "copy_windows": [
        0x20, 4, 0x10, "CALLDATACOPY", 0x10, "MLOAD", 0, "SSTORE",
        8, 0, 0x18, "CODECOPY", 0x10, "MLOAD", 1, "SSTORE",
        0x20, 0, 0x10, "CODECOPY", 0x10, "MLOAD", 2, "SSTORE",
        ("push", 4, 0xFFFFFFF0), 4, 0x100, "CALLDATACOPY", "STOP"],
    "calldatacopy_past_mem_cap": [64, 0, MEM_CAP - 24, "CALLDATACOPY", "STOP"],
    "codecopy_past_mem_cap": [
        30, 0, MEM_CAP - 34, "CALLDATACOPY", 100, 0, MEM_CAP - 24, "CODECOPY", "STOP"],
    "mstore_past_mem_cap": [0, "CALLDATALOAD", MEM_CAP - 14, "MSTORE", "STOP"],
    "sha3_windows": [
        0, "CALLDATALOAD", 0, "MSTORE", 0x40, 0, "SHA3", 0, "SSTORE",
        0x20, 0x40, "SHA3", 1, "SSTORE", *byte_of(4), 0x40, "SHA3", 2, "SSTORE",
        0x20, *byte_of(5), "SHA3", 3, "SSTORE", "STOP"],
    "sha3_len_wraps_negative": [
        0, "CALLDATALOAD", 0, "MSTORE", ("push", 4, 0x80000010), 0, "SHA3", 0, "SSTORE",
        "STOP"],
    "sha3_len_low_bits_16": [
        0, "CALLDATALOAD", 0, "MSTORE", ("push", 5, (1 << 32) + 16), 0, "SHA3", 0,
        "SSTORE", "STOP"],
    # windows of 100-900 bytes: wider than a narrowed sym.WINDOW
    "wide_windows": [
        0, "CALLDATALOAD", 160, "MSTORE", 200, 0, "SHA3", 0, "SSTORE",
        300, 0, 400, "CALLDATACOPY", 200, 500, "SHA3", 1, "SSTORE",
        100, 0, 600, "CODECOPY", 100, 600, "SHA3", 2, "SSTORE",
        ("push", 5, (1 << 32) + 900), 0, "SHA3", 3, "SSTORE", "STOP"],
    "storage": [
        0, "CALLDATALOAD", 7, "SSTORE", 7, "SLOAD", 1, "ADD", 8, "SSTORE",
        9, "SLOAD", 1, "ADD", 10, "SSTORE", 0, "CALLDATALOAD", "SLOAD", "POP",
        5, 0, "CALLDATALOAD", "SSTORE", 1, 7, "SSTORE", 7, "SLOAD", 11, "SSTORE", "STOP"],
    "sload_all_miss": [1, 1, "SSTORE", 2, 2, "SSTORE", 3, "SLOAD", 4, "SSTORE", "STOP"],
    "storage_full": [
        x for k in range(STORAGE_CAP + 1) for x in (*byte_of(k), 0x100 + k, "SSTORE")
    ] + ["STOP"],
    "jumpi": [
        *byte_of(0), 0x80, "LT", ("ref", "a"), "JUMPI", 0, 0, "SSTORE", ("label", "a"),
        4, "CALLDATALOAD", "ISZERO", ("ref", "b"), "JUMPI", 1, 1, "SSTORE",
        ("label", "b"), 1, ("ref", "c"), "JUMPI", ("label", "c"), "STOP"],
    "wraps_and_sites": [
        2, TOP, "ADD", "POP", 2, 1, "SUB", "POP", TOP, 1 << 200, "MUL", "POP",
        1, *byte_of(0), "ADD", "POP", *byte_of(1), 0, "SUB", 0, "SSTORE",
        *byte_of(2), 3, "MUL", "POP", 9, "SLOAD", 1, "ADD", "POP",
        *byte_of(3), ("push", 32, TOP), "ADD", "POP", "STOP"],
    "event_dedup_and_overflow": [
        3, ("label", "loop"), 2, TOP, "ADD", "POP", 1, "SWAP1", "SUB", "DUP1",
        ("ref", "loop"), "JUMPI", "POP",
    ] + [x for k in range(sym.EVENT_CAP + 1) for x in (k + 2, TOP, "ADD", "POP")] + ["STOP"],
    "calls": [
        *call("CALL", 0x10000, byte_of(4)), 0, "SSTORE", "SELFBALANCE", 1, "SSTORE",
        7, "SLOAD", "POP", *call("STATICCALL", 2000), "POP",
        *call("DELEGATECALL", 0x9000), "POP",
        *call("CALLCODE", 0x5000, [0]), "POP", *call("CALL", 1000, [1]), "POP",
        "ADDRESS", "BALANCE", 2, "SSTORE", "STOP"],
    "env_leaves": [
        "ORIGIN", "CALLER", "EQ", ("ref", "a"), "JUMPI", ("label", "a"),
        "TIMESTAMP", 1, "ADD", 0, "SSTORE",
        "NUMBER", "COINBASE", "DIFFICULTY", "GASLIMIT", "ADD", "ADD", "ADD", 1, "SSTORE",
        1, "BLOCKHASH", "ISZERO", "NOT", "ISZERO", ("ref", "b"), "JUMPI", ("label", "b"),
        9, "SLOAD", "ISZERO", 2, "SSTORE", "STOP"],
    "ternary_cdl_extcodesize_dup_swap_return": [
        *byte_of(0), "DUP1", "DUP1", "ADDMOD", "POP", *byte_of(4), "CALLDATALOAD", "POP",
        0, "CALLDATALOAD", "EXTCODESIZE", "POP",
        0, "CALLDATALOAD", 1, 2, "SWAP2", "DUP3", "ADD", 0, "SSTORE", "POP", "POP",
        0, "CALLDATALOAD", 0, "MSTORE", 0x20, 0, "RETURN"],
    "unary_div_exp_nodes": [
        0, "CALLDATALOAD", "ISZERO", "NOT", 0, "SSTORE", 3, 0, "CALLDATALOAD", "DIV",
        2, "EXP", 1, "SSTORE", 7, *byte_of(1), "MOD", 2, "SSTORE", "STOP"],
}

ARITH = ["ADD", "SUB", "MUL", "DIV", "MOD", "SDIV", "SMOD", "EXP", "SIGNEXTEND",
         "LT", "GT", "SLT", "SGT", "EQ", "AND", "OR", "XOR", "BYTE", "SHL", "SHR", "SAR"]


def random_program(rng: random.Random, n_ops: int = 20):
    """Straight-line arithmetic over three tainted calldata words and
    pushed constants, drained into storage."""
    items = [0, "CALLDATALOAD", 0x20, "CALLDATALOAD", *byte_of(0x24)]
    depth = 3
    for _ in range(n_ops):
        r = rng.random()
        if depth >= 2 and r < 0.5:
            items.append(rng.choice(ARITH))
            depth -= 1
        elif depth >= 3 and r < 0.55:
            items.append(rng.choice(["ADDMOD", "MULMOD"]))
            depth -= 2
        elif depth >= 1 and r < 0.65:
            items.append(rng.choice(["ISZERO", "NOT"]))
        elif depth >= 2 and r < 0.75:
            items.append(f"SWAP{rng.randrange(1, min(depth, 4))}")
        elif depth < 12 and r < 0.85:
            items.append(f"DUP{rng.randrange(1, min(depth, 4) + 1)}")
            depth += 1
        else:
            items.append(rng.getrandbits(rng.choice([8, 64, 255])))
            depth += 1
    for slot in range(depth):
        items += [slot, "SSTORE"]
    return items + ["STOP"]


_rng = random.Random(4321)
for _k in range(8):
    PROGRAMS[f"random_{_k}"] = random_program(_rng)

NAMES = sorted(PROGRAMS)
NO_DIVISION = [name for name in NAMES if not name.startswith(("random", "unary"))
               and name != "ternary_cdl_extcodesize_dup_swap_return"]


def _calldata(n):
    rng = np.random.default_rng(99)
    return [rng.integers(0, 256, CD_LEN, dtype=np.uint8).tobytes() for _ in range(n)]


def _inputs(names):
    codes = [asm(PROGRAMS[name]) for name in names]
    table = tuple(np.asarray(x) for x in jax_make_code_table(codes, code_cap=512))
    fields = jax_make_batch(len(names), code_ids=np.arange(len(names)),
                            calldata=_calldata(len(names)), mem_cap=MEM_CAP,
                            storage_cap=STORAGE_CAP, as_numpy=True)
    return fields, table


def _jax_table(table):
    return type(jax_make_code_table([b"\x00"]))(*(jnp.asarray(x) for x in table))


def run_jax(fields, table, ar_count=0):
    symb = jax_make_sym_batch(JaxBatch(*(jnp.asarray(x) for x in fields)))
    symb = symb._replace(ar_count=jnp.int32(ar_count))
    out, steps, active = jax_sym_run(symb, _jax_table(table), max_steps=MAX_STEPS)
    return jax.device_get(out), int(steps), int(active)


def run_port(fields, table, ar_count=0, fn=sym.sym_run):
    base = interop.batch_from_numpy(fields, device="cpu")
    symb = sym.make_sym_batch(base)
    symb = symb._replace(ar_count=torch.tensor(ar_count, dtype=torch.int32))
    out, steps, active = fn(symb, interop.code_table_from_numpy(table, device="cpu"),
                            max_steps=MAX_STEPS)
    return interop.symbatch_to_numpy(out), steps, int(active)


def assert_sym_equal(port, ref, lanes=slice(None)):
    for name in JaxBatch._fields:
        got, want = getattr(port.base, name), np.asarray(getattr(ref.base, name))
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got[lanes], want[lanes], err_msg=f"base.{name}")
    for name in JaxSym._fields[1:]:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        if name.startswith("ar_"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_array_equal(got[lanes], want[lanes], err_msg=name)


@pytest.fixture(scope="module")
def inputs():
    return _inputs(NAMES)


@pytest.fixture(scope="module")
def runs_from(inputs):
    """start -> (start, port run, JAX run), each computed once."""
    fields, table = inputs
    done = {}

    def get(start):
        if start not in done:
            done[start] = (start, run_port(fields, table, start), run_jax(fields, table, start))
        return done[start]

    return get


@pytest.fixture(params=[0, sym.ARENA_CAP - 3], ids=["arena", "arena_overflow"])
def runs(request, runs_from):
    return runs_from(request.param)


@pytest.mark.parametrize("name", NAMES)
def test_sym_run_matches_jax_on_program(name, runs):
    _, (port, psteps, pactive), (ref, jsteps, jactive) = runs
    assert (psteps, pactive) == (jsteps, jactive)
    lane = NAMES.index(name)
    assert_sym_equal(port, ref, slice(lane, lane + 1))


def test_arena_rows_and_count_match_jax(runs):
    start, (port, _, _), (ref, _, _) = runs
    for name in ("ar_op", "ar_a", "ar_b", "ar_va", "ar_vb", "ar_count"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)))
    if start:
        assert int(port.ar_count) == sym.ARENA_CAP
        assert (port.stack_tid == sym.OPAQUE).any()
    else:
        assert 0 < int(port.ar_count) < sym.ARENA_CAP


def test_every_lane_halted_and_the_handlers_fired(runs):
    start, (port, steps, _), _ = runs
    assert steps < MAX_STEPS
    assert not (port.base.status == Status.RUNNING).any()
    if start:
        return
    kinds = set(port.ev_kind[port.ev_kind != 0].tolist())
    assert kinds >= {sym.EV_WRAP_ADD, sym.EV_WRAP_SUB, sym.EV_WRAP_MUL, sym.EV_CALL,
                     sym.EV_CALLCODE, sym.EV_DELEGATECALL, sym.EV_STATICCALL,
                     sym.EV_SSTORE_AFTER_CALL, sym.EV_SLOAD_AFTER_CALL, sym.EV_SITE_ADD,
                     sym.EV_SLOAD_MISS, sym.EV_SITE_OPAQUE}, kinds
    lane = NAMES.index("event_dedup_and_overflow")
    assert port.ev_overflow[lane] == 1 and port.ev_cnt[lane] == sym.EVENT_CAP
    assert port.balance_tid[NAMES.index("calls")] == sym.OPAQUE
    assert port.br_tid[NAMES.index("env_leaves"), 1] == -3
    for name in ("sha3_len_wraps_negative", "sha3_len_low_bits_16",
                 "calldatacopy_past_mem_cap", "mstore_past_mem_cap", "wide_windows"):
        assert port.base.status[NAMES.index(name)] in (Status.ERR_OOG, Status.ERR_MEM), name
    # the wrapped int32 length taints nothing; 2**32 + 16 hashes 16 bytes
    assert port.stack_tid[NAMES.index("sha3_len_wraps_negative"), 0] == 0
    assert port.stack_tid[NAMES.index("sha3_len_low_bits_16"), 0] == sym.OPAQUE
    # a lane out of gas still writes its SHA3's tid: 900 bytes reach the
    # tainted word at 160
    assert port.stack_tid[NAMES.index("wide_windows"), 0] == sym.OPAQUE
    assert (port.mem_tid[NAMES.index("calldatacopy_past_mem_cap"), MEM_CAP - 24:]
            == sym.OPAQUE).all()


def test_sym_run_keeps_every_field_dtype_and_shape(inputs):
    fields, table = inputs
    symb = sym.make_sym_batch(interop.batch_from_numpy(fields, device="cpu"))
    out, _, _ = sym.sym_run(symb, interop.code_table_from_numpy(table, device="cpu"),
                            max_steps=MAX_STEPS)
    for x, y in zip(list(symb.base) + list(symb[1:]), list(out.base) + list(out[1:])):
        assert (x.dtype, x.shape) == (y.dtype, y.shape)


def test_sload_all_miss_row_reads_slot_zero():
    """argmax over an all-miss row: no hit reads journal entry 0's tid
    position and banks a miss with the concrete key."""
    fields, table = _inputs(["sload_all_miss"])
    port, _, _ = run_port(fields, table)
    assert port.ev_kind[0, 0] == sym.EV_SLOAD_MISS
    assert u256.to_int(port.ev_a[0, 0]) == 3
    ref, _, _ = run_jax(fields, table)
    assert_sym_equal(port, ref)


def test_sym_run_inplace_equals_sym_run_and_sym_run_copies(inputs):
    fields, table = inputs
    base = interop.batch_from_numpy(fields, device="cpu")
    symb = sym.make_sym_batch(base)
    before = [t.clone() for t in list(symb.base) + list(symb[1:])]
    code = interop.code_table_from_numpy(table, device="cpu")
    out, steps, active = sym.sym_run(symb, code, max_steps=MAX_STEPS)
    assert all(torch.equal(x, y) for x, y in zip(before, list(symb.base) + list(symb[1:])))
    out2, steps2, active2 = sym.sym_run_inplace(symb, code, max_steps=MAX_STEPS)
    assert (steps, int(active)) == (steps2, int(active2))
    assert all(torch.equal(x, y) for x, y in zip(list(out.base) + list(out[1:]),
                                                 list(out2.base) + list(out2[1:])))


def test_phases_forced_open_change_nothing(inputs, runs_from, monkeypatch):
    _, (port, steps, _), _ = runs_from(0)
    fields, table = inputs
    # every opcode and the wide-window flag: the full-width path
    monkeypatch.setattr(port_step, "_present",
                        lambda op, ex, flag=None: frozenset(range(port_step.FLAG + 1)))
    forced, fsteps, _ = run_port(fields, table)
    assert fsteps == steps
    assert_sym_equal(forced, port)


def test_narrow_window_takes_the_full_width_path_where_a_window_is_wider(
        inputs, runs_from, monkeypatch):
    """With WINDOW cut to 64 bytes (MEM_CAP is below the default, so every
    window is narrow), the steps where a copy or SHA3 spans more take the
    full-width path and the others the window: still equal to JAX."""
    _, _, (ref, steps, active) = runs_from(0)
    fields, table = inputs
    flagged = []
    present = port_step._present

    def spy(op, ex, flag=None):
        got = present(op, ex, flag)
        flagged.append(port_step.FLAG in got)
        return got

    monkeypatch.setattr(sym, "WINDOW", 64)
    monkeypatch.setattr(port_step, "_present", spy)
    port, psteps, pactive = run_port(fields, table)
    assert (psteps, pactive) == (steps, active)
    assert_sym_equal(port, ref)
    assert 0 < sum(flagged) < len(flagged)


def test_shadow_adds_no_host_read():
    """Two host reads per sym_step (the histogram and the any-RUNNING
    test) plus the final any-RUNNING test, on programs that never divide."""
    fields, table = _inputs(NO_DIVISION)
    hostsync.COUNT = 0
    _, steps, _ = run_port(fields, table)
    assert hostsync.COUNT == 2 * steps + 1


def test_specialised_phases_are_not_ported(inputs):
    fields, table = inputs
    symb = sym.make_sym_batch(interop.batch_from_numpy(fields, device="cpu"))
    code = interop.code_table_from_numpy(table, device="cpu")
    with pytest.raises(NotImplementedError):
        sym.sym_step(symb, code, phases=object())
    with pytest.raises(NotImplementedError):
        sym.sym_run(symb, code, phases=object())


def _seed_delta(n, rng):
    w, cd_w = 4, 128
    skeys = np.zeros((n, w, u256.LIMBS), np.uint32)
    svals = np.zeros((n, w, u256.LIMBS), np.uint32)
    scnt = rng.integers(0, w + 1, n).astype(np.int32)
    journals = []
    for i in range(n):
        journal = {int(rng.integers(0, 1 << 40)) + j: int(rng.integers(1, 1 << 60))
                   for j in range(int(scnt[i]))}
        for j, (slot, value) in enumerate(journal.items()):
            skeys[i, j] = u256.from_int(slot)
            svals[i, j] = u256.from_int(value)
        journals.append(journal)
    calldata = [rng.integers(0, 256, int(rng.integers(0, cd_w + 1)), dtype=np.uint8).tobytes()
                for _ in range(n)]
    cd = np.zeros((n, cd_w), np.uint8)
    for i, data in enumerate(calldata):
        cd[i, :len(data)] = np.frombuffer(data, np.uint8)
    cds = np.array([len(d) for d in calldata], np.int32)
    values = [int(v) for v in rng.integers(0, 1 << 62, n)]
    balances = [int(v) for v in rng.integers(0, 1 << 62, n)]
    cv = np.stack([u256.from_int(v) for v in values]).astype(np.uint32)
    bal = np.stack([u256.from_int(v) for v in balances]).astype(np.uint32)
    code_ids = rng.permutation(n).astype(np.int32)
    synthetic = rng.random(n) > 0.5
    delta = (code_ids, cd, cds, cv, bal, skeys, svals, scnt, synthetic)
    return delta, dict(code_ids=code_ids, calldata=calldata, callvalue=values,
                       balance=balances, storage_seed=journals)


def test_reseed_wave_matches_jax_and_a_fresh_batch(runs_from):
    _, (port_spent, _, _), (jax_spent, _, _) = runs_from(0)
    n = len(NAMES)
    delta, fresh_args = _seed_delta(n, np.random.default_rng(17))
    want = jax.device_get(jax_reseed_wave(
        jax.tree_util.tree_map(jnp.asarray, jax_spent), *(jnp.asarray(x) for x in delta)))
    spent = interop.symbatch_from_numpy(port_spent, device="cpu")
    got = sym.reseed_wave(spent, *delta)
    assert_sym_equal(interop.symbatch_to_numpy(got), want)
    # the functional form leaves the spent wave as it was
    assert_sym_equal(interop.symbatch_to_numpy(spent), port_spent)
    inplace = sym.reseed_wave_inplace(spent, *delta)
    assert_sym_equal(interop.symbatch_to_numpy(inplace), want)
    # a fresh batch of the same seeds, synthetic journals masked as the
    # explorer's cold build does
    fresh = sym.make_sym_batch(make_batch(n, mem_cap=MEM_CAP, storage_cap=STORAGE_CAP,
                                          device="cpu", **fresh_args))
    seeded = torch.arange(STORAGE_CAP)[None, :] < fresh.base.storage_cnt[:, None]
    fresh.sval_tid.masked_fill_(torch.tensor(delta[-1])[:, None] & seeded, sym.OPAQUE)
    assert_sym_equal(interop.symbatch_to_numpy(inplace), interop.symbatch_to_numpy(fresh))
