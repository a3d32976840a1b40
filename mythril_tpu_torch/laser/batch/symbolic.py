"""The symbolic shadow wave, in eager PyTorch: taint ids and the
expression arena beside the concrete step.

The port of the JAX package's laser/batch/symbolic.py, with its
semantics reproduced bit for bit. Every lane's stack slot, memory byte,
storage-journal entry and JUMPI decision carries a term id beside its
concrete value; ops over symbolic operands append one arena row per
lane per step, at rows ranked by a cumsum over the lanes in order.
Beside the arena every lane banks detection events (wraps, arithmetic
sites, calls, state access after a call, SLOAD misses) and its RETURN
window.

Term ids: 0 is concrete; > 0 is arena row + 1; < 0 is opaque, with
provenance bits -(1 + bits): bit 1 tx.origin, bit 2 a predictable block
attribute.

What changes against the JAX kernel is how the work is scheduled, as in
the concrete step (step.py):

- *one histogram.* `sym_step` reads the opcode-presence set once
  (`step._present`, one host read) and hands it to `step`; every shadow
  handler runs only if its opcode is in it. Each handler is
  mask-correct, so a skipped handler changes nothing.
- *in place.* The shadow tables (stack, memory, storage and branch
  tids, the evidence banks, the arena) are updated in place: per-lane
  slot writes go through `ops.slot_write` (one kernel launch each on the
  card; the tables that share an index, storage tids and the eight
  evidence banks, share one), MSTORE's window is a 32-byte scatter and
  the arena takes its rows by index. `sym_step` therefore updates the buffers of the
  SymBatch it is given; `sym_run` copies its input once and
  `sym_run_inplace` does not.
- *windows, not whole rows.* The copy windows and the SHA3 taint test
  touch WINDOW bytes per lane (a scatter, a gather), not the
  [N, mem_cap] masks the JAX kernel fuses. A step in which some lane's
  window is wider (a SHA3 past the hash cap, which the concrete step
  demotes or halts out of gas, or a long copy) takes the full-width
  path; the flag rides the histogram's read.
- *no host reads* beyond the histogram: `ar_count` stays on the card,
  and arena rows past ARENA_CAP are dropped by a mask (the JAX kernel's
  `mode="drop"`).

PhaseSet specialisation (`phases`) is not ported: `phases` must be None.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.run import _any_running
from mythril_tpu_torch.laser.batch.state import HASH_CAP, CodeTable, StateBatch, Status
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.ops.slot_write import slot_write, slot_write_many
from mythril_tpu_torch.support.opcodes import OPCODES

# the module (the package's `step` attribute is the function); its
# `_present` is looked up at call time so that a test can force every
# handler open
_stepmod = importlib.import_module("mythril_tpu_torch.laser.batch.step")

W = u256.LIMBS
OPAQUE = -1

#: arena rows per batch (shared by all lanes of a wave)
ARENA_CAP = 32768

#: banked detection events per lane
EVENT_CAP = 12

#: memory bytes per lane that a copy window or the SHA3 taint test
#: touches on the common path: the device's hash cap (`step` demotes a
#: longer SHA3 or halts it out of gas)
WINDOW = HASH_CAP + 1

#: event kinds (ev_kind values)
EV_WRAP_ADD = 1
EV_WRAP_SUB = 2
EV_WRAP_MUL = 3
EV_CALL = 4
EV_CALLCODE = 5
EV_DELEGATECALL = 6
EV_STATICCALL = 7
EV_SSTORE_AFTER_CALL = 8
EV_SLOAD_AFTER_CALL = 9
#: tainted arithmetic that did not wrap on this lane (a steering target)
EV_SITE_ADD = 10
EV_SITE_SUB = 11
EV_SITE_MUL = 12
#: SLOAD of a never-written slot (concrete key in ev_a)
EV_SLOAD_MISS = 13
#: arithmetic over opaque operands that did not wrap
EV_SITE_OPAQUE = 15

_B = {name: entry[0] for name, entry in OPCODES.items()}

#: ops compiled to arena nodes when an operand is symbolic, arity 2
NODE_BINOPS = [
    "ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD", "EXP", "SIGNEXTEND",
    "LT", "GT", "SLT", "SGT", "EQ", "AND", "OR", "XOR", "BYTE", "SHL",
    "SHR", "SAR",
]
#: unary node ops
NODE_UNOPS = ["ISZERO", "NOT"]
#: ternary ops degrade to opaque when tainted
TERNARY_OPS = ["ADDMOD", "MULMOD"]
#: empty-world calls: a tainted gas/callee/value makes the push opaque
CALL_OPS = ["CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"]
#: push-only environment sources that become arena leaf nodes
ENV_LEAF_OPS = [
    "ORIGIN", "TIMESTAMP", "NUMBER", "COINBASE", "DIFFICULTY", "GASLIMIT",
]


def _table(names) -> np.ndarray:
    out = np.zeros(256, bool)
    for name in names:
        out[_B[name]] = True
    return out


_IS_BIN = _table(NODE_BINOPS)
_IS_UN = _table(NODE_UNOPS)
_IS_TER = _table(TERNARY_OPS)
_IS_CALL = _table(CALL_OPS)
_IS_ENV_LEAF = _table(ENV_LEAF_OPS)
_POPS = np.zeros(256, np.int32)
_PUSHES = np.zeros(256, np.int32)
_VALID = np.zeros(256, bool)
for _name, (_byte, _pops, _pushes, _gmin, _gmax) in OPCODES.items():
    _POPS[_byte] = _pops
    _PUSHES[_byte] = _pushes
    _VALID[_byte] = True
#: CALL-family byte -> event kind (0 = not a call)
_CALL_KIND = np.zeros(256, np.int32)
for _name, _kind in zip(CALL_OPS, (EV_CALL, EV_CALLCODE, EV_DELEGATECALL, EV_STATICCALL)):
    _CALL_KIND[_B[_name]] = _kind
#: calls that carry a value operand (stack slot 3)
_CALL_HAS_VALUE = _table(["CALL", "CALLCODE"])

#: merged per-opcode shadow metadata: [pops, pushes, valid, is_bin,
#: is_un, is_ter, is_call, call_kind, is_env_leaf, call_has_value]
_SYM_META = np.stack(
    [_POPS, _PUSHES, _VALID.astype(np.int32), _IS_BIN.astype(np.int32),
     _IS_UN.astype(np.int32), _IS_TER.astype(np.int32),
     _IS_CALL.astype(np.int32), _CALL_KIND, _IS_ENV_LEAF.astype(np.int32),
     _CALL_HAS_VALUE.astype(np.int32)],
    axis=1,
)

CALLDATALOAD, CALLDATACOPY, CODECOPY = _B["CALLDATALOAD"], _B["CALLDATACOPY"], _B["CODECOPY"]
SHA3 = _B["SHA3"]
MLOAD, MSTORE, MSTORE8 = _B["MLOAD"], _B["MSTORE"], _B["MSTORE8"]
SLOAD, SSTORE = _B["SLOAD"], _B["SSTORE"]
JUMPI = _B["JUMPI"]
CALL_B, SELFBALANCE_B = _B["CALL"], _B["SELFBALANCE"]
EXTCODESIZE_B = _B["EXTCODESIZE"]
ADD_B, SUB_B, MUL_B = _B["ADD"], _B["SUB"], _B["MUL"]
ADDMOD_B, MULMOD_B = _B["ADDMOD"], _B["MULMOD"]
RETURN_B = _B["RETURN"]
BLOCKHASH_B = _B["BLOCKHASH"]
_CALL_BYTES = tuple(_B[name] for name in CALL_OPS)
_ENV_LEAF_BYTES = tuple(_B[name] for name in ENV_LEAF_OPS)
#: ops that can append an arena row
_ARENA_BYTES = tuple(
    _B[name] for name in NODE_BINOPS + NODE_UNOPS + ["CALLDATALOAD"] + ENV_LEAF_OPS)
_DUP_BYTES = tuple(range(0x80, 0x90))
_SWAP_BYTES = tuple(range(0x90, 0xA0))

_CONSTS: dict = {}


def _sym_meta(device) -> torch.Tensor:
    t = _CONSTS.get(device)
    if t is None:
        t = _CONSTS[device] = torch.as_tensor(_SYM_META, device=device)
    return t


class SymBatch(NamedTuple):
    """A StateBatch plus the symbolic shadow state.

    The JAX package's fields, order and shapes. Dtypes follow the port's
    rule (state.py): the uint32 limb fields `ev_a`, `ev_b`, `ar_va`,
    `ar_vb` are int32 (values below 2**16), the uint32 `ev_gas` is int64
    (values below 2**32), and `ar_count` is a 0-d int32 tensor on the
    batch's device. `interop.symbatch_to_numpy` restores the JAX dtypes."""

    base: StateBatch
    stack_tid: torch.Tensor  # i32[N, STACK_CAP]
    mem_tid: torch.Tensor  # i32[N, MEM_CAP]
    skey_tid: torch.Tensor  # i32[N, STORAGE_CAP]
    sval_tid: torch.Tensor  # i32[N, STORAGE_CAP]
    br_tid: torch.Tensor  # i32[N, BRANCH_CAP] condition term per decision
    balance_tid: torch.Tensor  # i32[N]; 0 or OPAQUE (tainted transfers)
    # per-lane detection-evidence banks
    ev_pc: torch.Tensor  # i32[N, EVENT_CAP]
    ev_kind: torch.Tensor  # i32[N, EVENT_CAP] EV_* kind
    ev_tid: torch.Tensor  # i32[N, EVENT_CAP] wrap result / call target tid
    ev_vtid: torch.Tensor  # i32[N, EVENT_CAP] call value tid (wraps: 0)
    ev_a: torch.Tensor  # i32[N, EVENT_CAP, W] operand a / call target value
    ev_b: torch.Tensor  # i32[N, EVENT_CAP, W] operand b / call value
    ev_aux: torch.Tensor  # i32[N, EVENT_CAP] br_cnt at a call site
    ev_gas: torch.Tensor  # i64[N, EVENT_CAP] call gas operand, saturated
    ev_cnt: torch.Tensor  # i32[N]
    ev_overflow: torch.Tensor  # i32[N] a distinct event was dropped
    call_seen: torch.Tensor  # i32[N] lane executed a gas-forwarding call
    ret_off: torch.Tensor  # i32[N] RETURN window offset (-1: none)
    ret_len: torch.Tensor  # i32[N]
    # the shared expression arena
    ar_op: torch.Tensor  # i32[ARENA_CAP]
    ar_a: torch.Tensor  # i32[ARENA_CAP] operand-a term id (0 = concrete)
    ar_b: torch.Tensor  # i32[ARENA_CAP]
    ar_va: torch.Tensor  # i32[ARENA_CAP, W] operand-a concrete value
    ar_vb: torch.Tensor  # i32[ARENA_CAP, W]
    ar_count: torch.Tensor  # i32 scalar


def make_sym_batch(base: StateBatch) -> SymBatch:
    """A fresh shadow over `base`, on `base`'s device."""
    n = base.pc.shape[0]
    dev = base.pc.device
    i32 = torch.int32

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SymBatch(
        base=base,
        stack_tid=zeros(n, base.stack.shape[1]),
        mem_tid=zeros(n, base.mem.shape[1]),
        skey_tid=zeros(n, base.storage_keys.shape[1]),
        sval_tid=zeros(n, base.storage_keys.shape[1]),
        br_tid=zeros(n, base.br_pc.shape[1]),
        balance_tid=zeros(n),
        ev_pc=zeros(n, EVENT_CAP),
        ev_kind=zeros(n, EVENT_CAP),
        ev_tid=zeros(n, EVENT_CAP),
        ev_vtid=zeros(n, EVENT_CAP),
        ev_a=zeros(n, EVENT_CAP, W),
        ev_b=zeros(n, EVENT_CAP, W),
        ev_aux=zeros(n, EVENT_CAP),
        ev_gas=zeros(n, EVENT_CAP, dtype=torch.int64),
        ev_cnt=zeros(n),
        ev_overflow=zeros(n),
        call_seen=zeros(n),
        ret_off=torch.full((n,), -1, dtype=i32, device=dev),
        ret_len=torch.full((n,), -1, dtype=i32, device=dev),
        ar_op=zeros(ARENA_CAP),
        ar_a=zeros(ARENA_CAP),
        ar_b=zeros(ARENA_CAP),
        ar_va=zeros(ARENA_CAP, W),
        ar_vb=zeros(ARENA_CAP, W),
        ar_count=zeros(),
    )


def clone_sym_batch(symb: SymBatch) -> SymBatch:
    """A copy of every tensor of `symb`."""
    return SymBatch(StateBatch(*(t.clone() for t in symb.base)),
                    *(t.clone() for t in symb[1:]))


def _window(off, length, mask, cap):
    """bool[N, cap]: byte j lies in [off, off + length) of a masked lane.
    `off` is an int32 offset >= 0, `length` an int32 that may be negative
    (an empty window), as the JAX kernel's int32 `rel < len` test."""
    j = torch.arange(cap, device=off.device)
    lo = torch.where(mask, off.to(torch.int64), cap)
    hi = off.to(torch.int64) + length.to(torch.int64)
    return (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])


def _arena_append(symb: SymBatch, mk_row, columns):
    """Append one arena row per lane in `mk_row`, in place: `columns` are
    (table, value per lane). Returns (ok, node_tid): the lanes whose row
    fit below ARENA_CAP and every lane's would-be term id.

    Rows are ar_count + the lane's rank among the `mk_row` lanes, in lane
    order; rows past ARENA_CAP are dropped. The lanes that write keep
    their rows; every other lane takes one of the rows after them, so
    the N indices, taken mod ARENA_CAP, are distinct (N <= ARENA_CAP) and
    one index_put per table is deterministic; a lane that does not write
    writes back what is there."""
    mk_i = mk_row.to(torch.int64)
    rows = symb.ar_count.to(torch.int64) + torch.cumsum(mk_i, 0) - mk_i
    ok = mk_row & (rows < ARENA_CAP)
    ok_i = ok.to(torch.int64)
    not_i = 1 - ok_i
    r = torch.where(ok, torch.cumsum(ok_i, 0) - ok_i,
                    ok_i.sum() + torch.cumsum(not_i, 0) - not_i)
    idx = (symb.ar_count.to(torch.int64) + r) % ARENA_CAP
    for table, val in columns:
        table.index_put_((idx,), _stepmod._m(ok, val, table[idx]))
    return ok, (rows + 1).to(torch.int32)


def sym_step(symb: SymBatch, code: CodeTable, phases=None) -> SymBatch:
    """One instruction on every lane, with the symbolic shadow pass.

    Updates the concrete buffers (see `step.step`) and the shadow tables
    of `symb` in place; returns the SymBatch with its other fields
    replaced. `phases` must be None (the generic kernel)."""
    if phases is not None:
        raise NotImplementedError(
            "PhaseSet specialisation is not ported; sym_step takes phases=None")
    pre = symb.base
    n = pre.pc.shape[0]
    if n > ARENA_CAP:
        raise ValueError(f"sym_step takes at most ARENA_CAP={ARENA_CAP} lanes, got {n}")
    dev = pre.pc.device
    mem_cap = pre.mem.shape[1]
    stack_cap = pre.stack.shape[1]
    lanes = torch.arange(n, device=dev)
    m_ = _stepmod._m
    i32 = torch.int32

    # --- decode this step's instruction (mirrors step's fetch) --------
    code_id = pre.code_id.clamp(0, code.ops.shape[0] - 1).long()
    oob = pre.pc >= code.length[code_id]
    pc_safe = pre.pc.clamp(0, code.ops.shape[1] - 33).long()
    op = code.ops[code_id, pc_safe].to(i32)
    meta = _sym_meta(dev)[op.long()]
    pops = meta[:, 0]
    pushes = meta[:, 1]
    live = (pre.status == Status.RUNNING) & ~oob
    ex = (live & (meta[:, 2] != 0) & (pre.sp >= pops)
          & (pre.sp + pushes - pops <= stack_cap))

    # --- pre-step reads: the step updates stack and storage in place ---
    dup_n = op - 0x80
    swap_n = op - 0x8F
    peek_ks = torch.stack([torch.zeros_like(op), torch.ones_like(op),
                           torch.full_like(op, 2), dup_n, swap_n], dim=1)
    peek_idx = (pre.sp[:, None] - 1 - peek_ks).clamp(0, stack_cap - 1).long()
    vals = pre.stack[lanes[:, None], peek_idx[:, :3]]  # [n, 3, W]
    a_val, b_val, c_val = vals[:, 0], vals[:, 1], vals[:, 2]
    tids = symb.stack_tid[lanes[:, None], peek_idx]  # [n, 5]
    a_tid, b_tid, c_tid = tids[:, 0], tids[:, 1], tids[:, 2]
    dup_tid, swap_deep_tid = tids[:, 3], tids[:, 4]

    # SHA3 hashes b bytes and the copies write c bytes, from offset a; the
    # span is the int32 wrap of the low 32 bits, overflow flag ignored,
    # as in the JAX kernel
    off_i, off_big = _stepmod._word_to_i32(a_val)
    is_sha = op == SHA3
    span_i, _ = _stepmod._word_to_i32(torch.where(is_sha[:, None], b_val, c_val))
    win = min(WINDOW, mem_cap)
    wide = None
    if win < mem_cap:
        span_end = torch.clamp(off_i.to(torch.int64) + span_i, max=mem_cap)
        wide = (ex & ~off_big & (is_sha | (op == CALLDATACOPY) | (op == CODECOPY))
                & (span_end - off_i > win))
    # the one host read: a superset of the opcodes the concrete step's
    # executing lanes run, so it gates the step as well, and whether
    # some lane's window is wider than WINDOW
    present = _stepmod._present(op, ex, wide)

    def on(*ops):
        return any(o in present for o in ops)

    sload_m = ex & (op == SLOAD)
    sstore_m = ex & (op == SSTORE)
    any_hit = None
    if on(SLOAD, SSTORE):
        s_cap = pre.storage_keys.shape[1]
        slots = torch.arange(s_cap, device=dev)
        hit = (torch.all(pre.storage_keys == a_val[:, None, :], dim=-1)
               & (slots < pre.storage_cnt[:, None]))
        any_hit = torch.any(hit, dim=-1)
        # the latest matching entry; 0 when none (the JAX argmax's first
        # maximum of an all-zero row)
        last = (torch.where(hit, slots + 1, 0).amax(-1) - 1).clamp(min=0)
        # a miss reads initial storage, which the host models as symbolic
        sload_tid = torch.where(any_hit, symb.sval_tid[lanes, last], OPAQUE)
        sload_tid = torch.where(a_tid != 0, OPAQUE, sload_tid)
        s_slot = torch.where(any_hit, last, pre.storage_cnt.clamp(0, s_cap - 1).long())

    # --- run the concrete kernel --------------------------------------
    post = _stepmod.step(pre, code, present=present)
    # a lane the kernel demoted mid-step (UNSUPPORTED/ERR_MEM) executed
    # nothing: neither the shadow nor the evidence banks may record it
    executed = (post.status != Status.UNSUPPORTED) & (post.status != Status.ERR_MEM)

    # --- classify the symbolic effect ---------------------------------
    is_un = meta[:, 4] != 0
    bin_sym = ex & (meta[:, 3] != 0) & ((a_tid != 0) | (b_tid != 0))
    un_sym = ex & is_un & (a_tid != 0)
    cdl_clean = ex & (op == CALLDATALOAD) & (a_tid == 0)
    bin_ok = (a_tid >= 0) & (b_tid >= 0)
    un_ok = a_tid >= 0
    # taint-involved binops always get a row, opaque operand or not
    mk_node = bin_sym | (un_sym & un_ok) | cdl_clean
    mk_env = ex & (meta[:, 8] != 0)
    mk_opaque = un_sym & ~un_ok
    tainted_top3 = (a_tid != 0) | (b_tid != 0) | (c_tid != 0)
    if on(ADDMOD_B, MULMOD_B):
        mk_opaque = mk_opaque | (ex & (meta[:, 5] != 0) & tainted_top3)
    if on(CALLDATALOAD):
        mk_opaque = mk_opaque | (ex & (op == CALLDATALOAD) & (a_tid != 0))
    if on(*_CALL_BYTES):
        mk_opaque = mk_opaque | (ex & (meta[:, 6] != 0)
                                 & (tainted_top3 | (symb.balance_tid != 0)))
    if on(EXTCODESIZE_B):
        mk_opaque = mk_opaque | (ex & (op == EXTCODESIZE_B) & (a_tid != 0))
    balance_tid = symb.balance_tid
    if on(CALL_B):
        # an outgoing CALL of a tainted value taints the balance itself
        balance_tid = torch.where(
            ex & (op == CALL_B) & ((c_tid != 0) | (balance_tid != 0)),
            OPAQUE, balance_tid)

    # --- memory taints -------------------------------------------------
    off_sym = a_tid != 0
    mem_tid = symb.mem_tid
    mload_prop = None
    if on(MLOAD):
        # a uniform 32-byte window of one tid propagates; mixed or
        # symbolically addressed reads are opaque
        mload_m = ex & (op == MLOAD) & ~off_big
        widx = off_i.clamp(0, mem_cap - 32).long()[:, None] + torch.arange(32, device=dev)
        wtids = torch.gather(mem_tid, 1, widx)
        w_first = wtids[:, 0]
        w_uniform = torch.all(wtids == w_first[:, None], dim=1)
        w_any = torch.any(wtids != 0, dim=1)
        mload_prop = mload_m & w_uniform & ~off_sym
        mload_opq = mload_m & ((~w_uniform & w_any) | (off_sym & w_any))
        mk_opaque = mk_opaque | mload_opq | (ex & (op == MLOAD) & off_big)
    if on(MSTORE):
        # the value tid over the 32-byte window (opaque when the
        # destination is symbolic), clipped to mem_cap; the scattered
        # window is distinct slots, each written with its final value
        mstore_m = ex & (op == MSTORE) & ~off_big
        st_tid = torch.where(off_sym & (b_tid != 0), OPAQUE, b_tid)
        widx = off_i.clamp(0, mem_cap - 32).long()[:, None] + torch.arange(32, device=dev)
        rel = widx - off_i[:, None]
        inw = (rel >= 0) & (rel < 32) & mstore_m[:, None]
        mem_tid.scatter_(1, widx, torch.where(inw, st_tid[:, None],
                                              torch.gather(mem_tid, 1, widx)))
    if on(MSTORE8):
        m8_m = ex & (op == MSTORE8) & ~off_big
        slot_write(mem_tid, off_i.long(), m8_m, torch.where(b_tid != 0, OPAQUE, 0).to(i32))
    full_width = _stepmod.FLAG in present
    if on(CALLDATACOPY, CODECOPY, SHA3) and not full_width:
        # each lane's span lies in the WINDOW bytes from `lo`; gathered
        # after the MSTOREs, and a SHA3 lane's row is not written below
        lo = off_i.clamp(0, mem_cap - win)
        cols = torch.arange(win, device=dev, dtype=i32)
        span_idx = (lo[:, None] + cols).long()
        rel = (lo - off_i)[:, None] + cols
        in_span = (rel >= 0) & (rel < span_i[:, None])
        span_tids = torch.gather(mem_tid, 1, span_idx)
    if on(CALLDATACOPY, CODECOPY):
        # CALLDATACOPY makes the window opaque bytes; CODECOPY writes
        # concrete code bytes, which clears stale taint
        if full_width:
            for copy_op, fill in ((CALLDATACOPY, OPAQUE), (CODECOPY, 0)):
                if on(copy_op):
                    copy_m = ex & (op == copy_op) & ~off_big
                    mem_tid.masked_fill_(_window(off_i, span_i, copy_m, mem_cap), fill)
        else:
            copy_m = ex & ((op == CALLDATACOPY) | (op == CODECOPY)) & ~off_big
            fill = torch.where(op == CALLDATACOPY, OPAQUE, 0).to(i32)
            mem_tid.scatter_(1, span_idx, torch.where(in_span & copy_m[:, None],
                                                      fill[:, None], span_tids))
    if on(SHA3):
        # a tainted window (or tainted bounds) makes the digest opaque
        sha_m = ex & is_sha & ~off_big
        if full_width:
            hashed = _window(off_i, span_i, sha_m, mem_cap) & (mem_tid != 0)
        else:
            hashed = in_span & (span_tids != 0)
        sha_tainted = sha_m & (torch.any(hashed, dim=1) | off_sym | (b_tid != 0))
        mk_opaque = mk_opaque | sha_tainted

    # --- storage taints ------------------------------------------------
    if on(SSTORE):
        slot_write_many(s_slot, sstore_m, [(symb.sval_tid, b_tid), (symb.skey_tid, a_tid)])

    # --- arena append --------------------------------------------------
    mk_row = mk_node | mk_env
    ar_count = symb.ar_count
    if on(*_ARENA_BYTES):
        env_val = torch.zeros_like(a_val)
        for byte_, name in zip(_ENV_LEAF_BYTES, ENV_LEAF_OPS):
            if on(byte_):
                env_val = m_(op == byte_, getattr(pre, name.lower()), env_val)
        ok, node_tid = _arena_append(symb, mk_row, (
            (symb.ar_op, op),
            (symb.ar_a, torch.where(mk_env, 0, a_tid)),
            (symb.ar_b, torch.where(mk_env, 0, b_tid)),
            (symb.ar_va, m_(mk_env, env_val, a_val)),
            (symb.ar_vb, m_(mk_env, torch.zeros_like(b_val), b_val)),
        ))
        ar_count = torch.clamp(ar_count + mk_row.sum().to(i32), max=ARENA_CAP)
    else:
        ok = torch.zeros_like(mk_row)
        node_tid = torch.zeros_like(op)
    overflowed = mk_row & ~ok

    # --- result tid ----------------------------------------------------
    res_tid = torch.where(mk_row, node_tid, 0).to(i32)
    res_tid = torch.where(mk_opaque | overflowed, OPAQUE, res_tid)
    # unary results of opaque operands keep the operand's provenance bits
    neg_bits_a = torch.where(a_tid < 0, (-a_tid - 1).clamp(0, 3), 0)
    res_tid = torch.where(un_sym & ~un_ok, -(1 + neg_bits_a), res_tid).to(i32)
    if on(BLOCKHASH_B):
        # predictable-var provenance without a leaf
        res_tid = torch.where(ex & (op == BLOCKHASH_B), -3, res_tid)
    if mload_prop is not None:
        res_tid = torch.where(mload_prop, w_first, res_tid)
    if on(SLOAD):
        res_tid = torch.where(sload_m, sload_tid, res_tid)
    if on(SELFBALANCE_B):
        res_tid = torch.where(ex & (op == SELFBALANCE_B) & (balance_tid != 0),
                              OPAQUE, res_tid)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    if on(*_DUP_BYTES):
        res_tid = torch.where(ex & is_dup, dup_tid, res_tid)
    if on(*_SWAP_BYTES):
        res_tid = torch.where(ex & is_swap, swap_deep_tid, res_tid)

    # --- stack tid write (mirrors the consolidated stack write) --------
    res_idx = torch.where(is_dup, pre.sp, torch.where(is_swap, pre.sp - 1, pre.sp - pops))
    res_idx = res_idx.clamp(0, stack_cap - 1).long()
    res_write = (res_idx, ex & executed & (pushes > 0), res_tid)
    if on(*_SWAP_BYTES):
        # SWAP's second slot: the old top's tid sinks to the deep position
        # (the second write, as in the JAX kernel's order)
        swap_idx = (pre.sp - 1 - swap_n).clamp(0, stack_cap - 1).long()
        slot_write(symb.stack_tid, *res_write, swap_idx, ex & is_swap, a_tid)
    else:
        slot_write(symb.stack_tid, *res_write)

    # --- branch journal tids -------------------------------------------
    if on(JUMPI):
        br_cap = pre.br_pc.shape[1]
        record = ex & (op == JUMPI) & (pre.br_cnt < br_cap)
        slot_write(symb.br_tid, pre.br_cnt.clamp(0, br_cap - 1).long(), record, b_tid)

    # --- evidence banks ------------------------------------------------
    call_seen, ev_cnt, ev_overflow = symb.call_seen, symb.ev_cnt, symb.ev_overflow
    if on(ADD_B, SUB_B, MUL_B, SLOAD, SSTORE, *_CALL_BYTES):
        false = torch.zeros_like(ex)
        wrap_evt = site_evt = opaque_site = call_evt = state_acc = sload_miss = false
        wrap_kind = torch.zeros_like(op)
        if on(ADD_B, SUB_B, MUL_B):
            # a concrete wrap banks regardless of term-ness; sites without
            # one bank as steering targets (node-gated) or opaque sites
            wrap_add = (op == ADD_B) & u256.ult(u256.bit_not(a_val), b_val)
            wrap_sub = (op == SUB_B) & u256.ult(a_val, b_val)
            hi_a = torch.any(a_val[:, W // 2:] != 0, dim=-1)
            hi_b = torch.any(b_val[:, W // 2:] != 0, dim=-1)
            nz_a = torch.any(a_val != 0, dim=-1)
            nz_b = torch.any(b_val != 0, dim=-1)
            wrap_mul = (op == MUL_B) & (hi_a | hi_b) & nz_a & nz_b
            arith_exec = ((op == ADD_B) | (op == SUB_B) | (op == MUL_B)) & ex & executed
            wrapped = wrap_add | wrap_sub | wrap_mul
            wrap_evt = wrapped & arith_exec
            site_evt = arith_exec & bin_sym & bin_ok & ok & ~wrapped
            opaque_site = arith_exec & ~wrapped & ((a_tid < 0) | (b_tid < 0))
            wrap_kind = torch.where(op == ADD_B, EV_WRAP_ADD,
                                    torch.where(op == SUB_B, EV_WRAP_SUB, EV_WRAP_MUL)).to(i32)
            wrap_kind = torch.where(site_evt, wrap_kind + 9, wrap_kind)
            wrap_kind = torch.where(opaque_site, EV_SITE_OPAQUE, wrap_kind)
        # the gas operand saturated to 32 bits (banked with every event)
        gas32 = a_val[:, 0].to(torch.int64) | (a_val[:, 1].to(torch.int64) << 16)
        gas_sat = torch.where(torch.any(a_val[:, 2:] != 0, dim=-1), 0xFFFFFFFF, gas32)
        call_kind = torch.zeros_like(op)
        has_value = false
        if on(*_CALL_BYTES):
            call_kind = meta[:, 7]
            has_value = meta[:, 9] != 0
            call_evt = ex & executed & (call_kind != 0)
            call_seen = torch.where(call_evt & (gas_sat > 2300), 1, call_seen).to(i32)
        if on(SLOAD, SSTORE):
            # state access after a gas-forwarding call (reentrancy surface)
            state_acc = (ex & executed & (symb.call_seen != 0)
                         & ((op == SSTORE) | (op == SLOAD)))
        if on(SLOAD):
            sload_miss = ex & executed & sload_m & ~any_hit

        evt = wrap_evt | site_evt | opaque_site | call_evt | state_acc | sload_miss
        kind = torch.where(call_evt, call_kind, wrap_kind)
        kind = torch.where(state_acc & (op == SSTORE), EV_SSTORE_AFTER_CALL, kind)
        kind = torch.where(state_acc & (op == SLOAD), EV_SLOAD_AFTER_CALL, kind)
        # an after-call SLOAD outranks the miss hint (one event per step)
        kind = torch.where(sload_miss & ~state_acc, EV_SLOAD_MISS, kind).to(i32)
        ev_tid_new = torch.where(mk_node & ok, node_tid, 0)
        ev_tid_new = torch.where(call_evt, b_tid, ev_tid_new)
        ev_tid_new = torch.where(state_acc | sload_miss, 0, ev_tid_new).to(i32)
        ev_vtid_new = torch.where(call_evt & has_value, c_tid, 0).to(i32)
        a_field = m_(call_evt, b_val, a_val)
        b_field = m_(call_evt, m_(has_value, c_val, torch.zeros_like(c_val)), b_val)
        # one witness per (pc, kind) per lane
        seen = torch.any(
            (symb.ev_pc == pre.pc[:, None]) & (symb.ev_kind == kind[:, None])
            & (torch.arange(EVENT_CAP, device=dev)[None, :] < ev_cnt[:, None]),
            dim=1)
        fresh = evt & ~seen
        bank = fresh & (ev_cnt < EVENT_CAP)
        # a distinct event hitting a full bank is lost evidence
        ev_overflow = torch.where(fresh & (ev_cnt >= EVENT_CAP), 1, ev_overflow).to(i32)
        ev_slot = ev_cnt.clamp(0, EVENT_CAP - 1).long()
        slot_write_many(ev_slot, bank, [
            (symb.ev_pc, pre.pc), (symb.ev_kind, kind),
            (symb.ev_tid, ev_tid_new), (symb.ev_vtid, ev_vtid_new),
            (symb.ev_a, a_field), (symb.ev_b, b_field),
            (symb.ev_aux, pre.br_cnt), (symb.ev_gas, gas_sat)])
        ev_cnt = ev_cnt + bank.to(i32)

    # --- RETURN window -------------------------------------------------
    ret_off, ret_len = symb.ret_off, symb.ret_len
    if on(RETURN_B):
        ret_m = ex & executed & (op == RETURN_B)
        len_ret, len_big = _stepmod._word_to_i32(b_val)
        ret_known = ret_m & ~off_big & ~len_big
        ret_off = torch.where(ret_known, off_i, torch.where(ret_m, -1, ret_off))
        ret_len = torch.where(ret_known, len_ret, torch.where(ret_m, -1, ret_len))

    return symb._replace(
        base=post,
        balance_tid=balance_tid,
        ev_cnt=ev_cnt,
        ev_overflow=ev_overflow,
        call_seen=call_seen,
        ret_off=ret_off,
        ret_len=ret_len,
        ar_count=ar_count,
    )


def sym_run_inplace(symb: SymBatch, code: CodeTable, max_steps: int = 2048,
                    phases=None):
    """Run every lane to halt (or budget) with the symbolic shadow,
    stepping the buffers of `symb` in place (no entry copy: the port's
    form of the JAX package's donated `sym_run_donated`). The caller
    must use the returned batch and not read `symb` again.

    Returns (out, steps, active_lane_steps): `steps` is the loop trip
    count, `active_lane_steps` (a 0-d int64 tensor on the batch's device)
    counts only lanes that were RUNNING when each step executed. The
    loop is Python: one any-RUNNING host read per iteration, as in
    `run`."""
    if phases is not None:
        raise NotImplementedError(
            "PhaseSet specialisation is not ported; sym_run takes phases=None")
    active = torch.zeros((), dtype=torch.int64, device=symb.base.pc.device)
    steps = 0
    while steps < max_steps and _any_running(symb.base):
        active += (symb.base.status == Status.RUNNING).sum()
        symb = sym_step(symb, code)
        steps += 1
    return symb, steps, active


def sym_run(symb: SymBatch, code: CodeTable, max_steps: int = 2048, phases=None):
    """`sym_run_inplace` on a copy: the caller's batch is left as it was."""
    return sym_run_inplace(clone_sym_batch(symb), code, max_steps, phases)


def _upload(x, dtype, device) -> torch.Tensor:
    """A host array (numpy, any int dtype with values that fit) or a
    tensor as `dtype` on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(
            {torch.int32: np.int32, torch.uint8: np.uint8, torch.bool: np.bool_}[dtype])))
    return x.to(device=device, dtype=dtype)


def reseed_wave_inplace(symb: SymBatch, code_ids, calldata, calldatasize, callvalue,
                        balance, skeys, svals, scnt, synthetic) -> SymBatch:
    """Build the next wave's seeded SymBatch in the spent wave's buffers.

    The port's form of the JAX package's donated `reseed_wave_donated`:
    the state, the shadow tables and the arena are re-zeroed in place
    (`zero_`/`fill_`), the environment words (block context, caller,
    address, gas budget, empty_world) are kept, and only the per-wave
    seed delta is uploaded: code ids, calldata (`[N, w]`, w <= the
    calldata cap), sizes, call values and balances (uint32 limb words),
    and a storage-journal slab (`skeys`/`svals` `[N, w, LIMBS]`, w <= the
    storage cap). `synthetic` marks lanes whose seeded journal is a
    sample of symbolic initial storage: their seeded value tids become
    opaque. Host arrays take the JAX dtypes. `symb` must not be read
    again except through the returned batch (the same tensors)."""
    base = symb.base
    dev = base.pc.device
    i32 = torch.int32
    for t in (base.pc, base.stack, base.sp, base.mem, base.msize_words,
              base.storage_keys, base.storage_vals, base.status, base.gas_min,
              base.gas_max, base.ret_offset, base.ret_len, base.pc_seen,
              base.br_taken, base.br_cnt, base.calldata):
        t.zero_()
    base.br_pc.fill_(-1)
    skeys, svals = _upload(skeys, i32, dev), _upload(svals, i32, dev)
    base.storage_keys[:, :skeys.shape[1]] = skeys
    base.storage_vals[:, :svals.shape[1]] = svals
    cd = _upload(calldata, torch.uint8, dev)
    base.calldata[:, :cd.shape[1]] = cd
    base.code_id.copy_(_upload(code_ids, i32, dev))
    base.storage_cnt.copy_(_upload(scnt, i32, dev))
    base.callvalue.copy_(_upload(callvalue, i32, dev))
    base.balance.copy_(_upload(balance, i32, dev))
    base.calldatasize.copy_(_upload(calldatasize, i32, dev))
    for t in symb[1:]:
        t.zero_()
    symb.ret_off.fill_(-1)
    symb.ret_len.fill_(-1)
    seeded = (torch.arange(symb.sval_tid.shape[1], device=dev)[None, :]
              < base.storage_cnt[:, None])
    symb.sval_tid.masked_fill_(_upload(synthetic, torch.bool, dev)[:, None] & seeded, OPAQUE)
    return symb


def reseed_wave(symb: SymBatch, *seed) -> SymBatch:
    """`reseed_wave_inplace` on a copy: the spent wave is left as it was."""
    return reseed_wave_inplace(clone_sym_batch(symb), *seed)
