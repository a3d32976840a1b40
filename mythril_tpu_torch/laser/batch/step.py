"""The batched EVM state-transition step, in eager PyTorch.

One call executes one instruction on every live lane of a StateBatch,
with the JAX package's step semantics (laser/batch/step.py there, the
generic kernel: every phase present, coverage on or off) reproduced
bit for bit. What changes is how the work is scheduled:

- *gate by presence.* The JAX kernel computes every cheap handler for
  every lane and merges by opcode mask, and skips its expensive phases
  with `lax.cond` when no lane needs them. Here one host read per step
  fetches the histogram of opcodes that live lanes execute, and every
  handler, cheap or not, runs only if its opcode is in it. Each handler
  is mask-correct (a lane outside its mask is left unchanged), so a
  skipped handler changes nothing: the result is the same whether a
  phase runs or not.
- *write in place.* The stack, memory, storage journal, branch journal
  and coverage bitmap are updated by scattering each lane's one written
  slot (or window) instead of a `where` over the whole buffer (at 16384
  lanes the stack alone is 134 MB). The slot writes go through
  `ops.slot_write`, one kernel launch each on the card (the stack's
  result and SWAP slots share one, and so do the tables that share an
  index: storage keys and values, branch pc and taken flag);
  CALLDATACOPY/CODECOPY write the
  whole memory in place, as the JAX step does. `step` therefore updates
  those buffers of the batch it is given; `run` copies its input once.
- *one sponge launch.* SHA3 hashes every lane's window in one call of
  `ops.keccak_cuda.keccak_sponge` (one kernel launch on the card, where
  each lane absorbs its own blocks; the plain version on the CPU absorbs
  SPONGE_MAX_BLOCKS blocks masked per lane, as the JAX step does).
- *uint32 by hand.* Gas sums wrap mod 2**32 explicitly (the gas fields
  are int64 holding uint32 values), int32 offsets wrap as int32, and
  every gather and scatter index is clamped and its result masked,
  where JAX clamps silently and PyTorch would raise.

Unknown opcodes mark the lane INVALID; opcodes outside the device set
(CREATE family, EXTCODECOPY/HASH, subroutines, and calls that may reach
code) mark UNSUPPORTED so that a host engine can take the lane over.

`phases` (a `PhaseSet`, built by laser/batch/specialize.py from a
contract's opcode signature) prunes handler phases as in the JAX
package: an opcode whose phase is pruned is unhandled, and a lane that
reaches it is parked UNSUPPORTED at the instruction, never advanced.
Its handler then never runs, as the presence gate never sees it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.state import (
    HASH_CAP,
    CodeTable,
    StateBatch,
    Status,
)
from mythril_tpu_torch.ops import keccak_cuda, u256
from mythril_tpu_torch.ops.slot_write import slot_write, slot_write_many
from mythril_tpu_torch.support import hostsync
from mythril_tpu_torch.support.opcodes import OPCODES

W = u256.LIMBS
M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# opcode byte constants
# ---------------------------------------------------------------------------
_B = {name: entry[0] for name, entry in OPCODES.items()}

STOP, ADD, MUL, SUB, DIV, SDIV, MOD, SMOD = (
    _B["STOP"], _B["ADD"], _B["MUL"], _B["SUB"], _B["DIV"], _B["SDIV"],
    _B["MOD"], _B["SMOD"],
)
ADDMOD, MULMOD, EXP, SIGNEXTEND = _B["ADDMOD"], _B["MULMOD"], _B["EXP"], _B["SIGNEXTEND"]
LT, GT, SLT, SGT, EQ, ISZERO = _B["LT"], _B["GT"], _B["SLT"], _B["SGT"], _B["EQ"], _B["ISZERO"]
AND, OR, XOR, NOT, BYTE, SHL, SHR, SAR = (
    _B["AND"], _B["OR"], _B["XOR"], _B["NOT"], _B["BYTE"], _B["SHL"],
    _B["SHR"], _B["SAR"],
)
SHA3 = _B["SHA3"]
ADDRESS, BALANCE, ORIGIN, CALLER, CALLVALUE = (
    _B["ADDRESS"], _B["BALANCE"], _B["ORIGIN"], _B["CALLER"], _B["CALLVALUE"],
)
CALLDATALOAD, CALLDATASIZE, CALLDATACOPY = (
    _B["CALLDATALOAD"], _B["CALLDATASIZE"], _B["CALLDATACOPY"],
)
CODESIZE, CODECOPY, GASPRICE = _B["CODESIZE"], _B["CODECOPY"], _B["GASPRICE"]
RETURNDATASIZE = _B["RETURNDATASIZE"]
BLOCKHASH, COINBASE, TIMESTAMP, NUMBER, DIFFICULTY, GASLIMIT = (
    _B["BLOCKHASH"], _B["COINBASE"], _B["TIMESTAMP"], _B["NUMBER"],
    _B["DIFFICULTY"], _B["GASLIMIT"],
)
CHAINID, SELFBALANCE, BASEFEE = _B["CHAINID"], _B["SELFBALANCE"], _B["BASEFEE"]
POP, MLOAD, MSTORE, MSTORE8, SLOAD, SSTORE = (
    _B["POP"], _B["MLOAD"], _B["MSTORE"], _B["MSTORE8"], _B["SLOAD"], _B["SSTORE"],
)
JUMP, JUMPI, PC, MSIZE, GAS, JUMPDEST = (
    _B["JUMP"], _B["JUMPI"], _B["PC"], _B["MSIZE"], _B["GAS"], _B["JUMPDEST"],
)
RETURN, REVERT, INVALID_OP, SELFDESTRUCT = (
    _B["RETURN"], _B["REVERT"], _B["ASSERT_FAIL"], _B["SUICIDE"],
)
CALL_OP, CALLCODE_OP, DELEGATECALL_OP, STATICCALL_OP = (
    _B["CALL"], _B["CALLCODE"], _B["DELEGATECALL"], _B["STATICCALL"],
)
EXTCODESIZE_OP, RETURNDATACOPY_OP = _B["EXTCODESIZE"], _B["RETURNDATACOPY"]

_UNSUPPORTED_NAMES = [
    "CREATE", "CREATE2",
    "EXTCODECOPY", "EXTCODEHASH",
    "BEGINSUB", "RETURNSUB", "JUMPSUB",
]
# CALL/CALLCODE/DELEGATECALL/STATICCALL are conditionally supported: in
# an empty world (no foreign code) they execute as transfers, and the
# step demotes the remaining cases to UNSUPPORTED per lane. The same
# gating covers EXTCODESIZE (self -> own code length, foreign -> 0) and
# RETURNDATACOPY (the zero-length form Solidity emits after calls).

PUSH_OPS = frozenset(range(0x60, 0x80))
DUP_OPS = frozenset(range(0x80, 0x90))
SWAP_OPS = frozenset(range(0x90, 0xA0))
LOG_OPS = frozenset(range(0xA0, 0xA5))
CALL_OPS = frozenset((CALL_OP, CALLCODE_OP, DELEGATECALL_OP, STATICCALL_OP))
DIV_OPS = frozenset((DIV, SDIV, MOD, SMOD))

# ---------------------------------------------------------------------------
# static per-opcode table: [valid, supported, pops, net_sp, gas_min, gas_max]
# ---------------------------------------------------------------------------
_META_NP = np.zeros((256, 6), dtype=np.int32)
for _name, (_byte, _pops, _pushes, _gmin, _gmax) in OPCODES.items():
    _META_NP[_byte] = (1, _name not in _UNSUPPORTED_NAMES, _pops,
                       _pushes - _pops, _gmin, _gmax)

_CONSTS: dict = {}


# ---------------------------------------------------------------------------
# kernel specialization: phase switches (the JAX package's, by name)
# ---------------------------------------------------------------------------


class PhaseSet(NamedTuple):
    """Hashable phase switches: all True is the generic step.
    `fuse_depth` > 1 runs that many - 1 fused substeps after each full
    step (specialize.py); `block_depth` > 0 runs that many block
    substeps instead (blockjit.py). Both are part of the
    specialization-bucket key."""

    calls: bool = True
    extcodesize: bool = True
    returndatacopy: bool = True
    arith: bool = True
    cmp: bool = True
    bits: bool = True
    shifts: bool = True
    div: bool = True
    modops: bool = True
    exp: bool = True
    env_block: bool = True
    env_tx: bool = True
    env_info: bool = True
    calldataload: bool = True
    sha3: bool = True
    mload: bool = True
    mstore: bool = True
    mstore8: bool = True
    copy: bool = True
    sload: bool = True
    sstore: bool = True
    logs: bool = True
    selfdestruct: bool = True
    fuse_depth: int = 0
    block_depth: int = 0

    @property
    def pruned(self):
        """Names of the phases this kernel elides."""
        return tuple(name for name in PHASE_FLAGS if not getattr(self, name))


#: the boolean phase fields, in declaration order
PHASE_FLAGS = tuple(
    name for name in PhaseSet._fields if name not in ("fuse_depth", "block_depth"))

#: phase flag -> the opcode names that phase (and only that phase)
#: handles. Ops in no group (STOP/RETURN/REVERT/JUMP/JUMPI/JUMPDEST/POP/
#: PUSH/DUP/SWAP, ASSERT_FAIL) are structural and never pruned.
PHASE_OPS = {
    "calls": ["CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"],
    "extcodesize": ["EXTCODESIZE"],
    "returndatacopy": ["RETURNDATACOPY"],
    "arith": ["ADD", "SUB", "MUL"],
    "cmp": ["LT", "GT", "SLT", "SGT", "EQ", "ISZERO"],
    "bits": ["AND", "OR", "XOR", "NOT"],
    "shifts": ["BYTE", "SHL", "SHR", "SAR", "SIGNEXTEND"],
    "div": ["DIV", "SDIV", "MOD", "SMOD"],
    "modops": ["ADDMOD", "MULMOD"],
    "exp": ["EXP"],
    "env_block": [
        "TIMESTAMP", "NUMBER", "COINBASE", "DIFFICULTY", "GASLIMIT",
        "CHAINID", "BASEFEE", "BLOCKHASH",
    ],
    "env_tx": [
        "ADDRESS", "CALLER", "ORIGIN", "CALLVALUE", "GASPRICE",
        "SELFBALANCE", "BALANCE",
    ],
    "env_info": [
        "CALLDATASIZE", "CODESIZE", "RETURNDATASIZE", "MSIZE", "PC", "GAS",
    ],
    "calldataload": ["CALLDATALOAD"],
    "sha3": ["SHA3"],
    "mload": ["MLOAD"],
    "mstore": ["MSTORE"],
    "mstore8": ["MSTORE8"],
    "copy": ["CALLDATACOPY", "CODECOPY"],
    "sload": ["SLOAD"],
    "sstore": ["SSTORE"],
    "logs": ["LOG0", "LOG1", "LOG2", "LOG3", "LOG4"],
    "selfdestruct": ["SUICIDE"],
}

#: the generic (nothing pruned, no substeps) kernel
GENERIC_PHASES = PhaseSet()


def _on(phases: Optional[PhaseSet], name: str) -> bool:
    """Phase switch: None means the generic kernel."""
    return phases is None or getattr(phases, name)


@functools.lru_cache(maxsize=None)
def _unhandled_table(phases: PhaseSet) -> np.ndarray:
    """bool[256]: opcodes whose handler phase `phases` prunes. A lane
    that reaches one (a wrong or stale signature; a sound one makes this
    dead code) is parked UNSUPPORTED for the host to re-execute."""
    table = np.zeros(256, dtype=bool)
    for flag, names in PHASE_OPS.items():
        if not getattr(phases, flag):
            for opname in names:
                table[_B[opname]] = True
    return table


@functools.lru_cache(maxsize=None)
def _unhandled_bytes(phases: PhaseSet) -> frozenset:
    """The opcodes of `_unhandled_table`, as a set."""
    return frozenset(int(i) for i in np.flatnonzero(_unhandled_table(phases)))


def _unhandled(phases: PhaseSet, device) -> torch.Tensor:
    """`_unhandled_table(phases)` as a bool tensor on `device`."""
    key = ("unhandled", phases, device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(_unhandled_table(phases), device=device)
    return t


def _meta(device) -> torch.Tensor:
    t = _CONSTS.get(device)
    if t is None:
        t = _CONSTS[device] = torch.as_tensor(_META_NP, device=device)
    return t


# ---------------------------------------------------------------------------
# host reads (each one waits for the card; the tests patch this to
# force every phase open)
# ---------------------------------------------------------------------------


#: a key of the presence set past the opcodes: the caller's `flag` holds
#: on some lane
FLAG = 256


def _present(op, ex, flag=None) -> frozenset:
    """Opcodes that at least one executing lane runs this step, and FLAG
    where `flag` (bool[N], optional) holds on some lane: one host read."""
    keys = torch.where(ex, op, FLAG + 1)
    if flag is not None:
        keys = torch.cat([keys, torch.where(flag, FLAG, FLAG + 1)])
    counts = torch.bincount(keys, minlength=FLAG + 2)
    return frozenset(i for i, c in enumerate(hostsync.read(counts[:FLAG + 1])) if c)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _m(mask, x, y):
    """Masked select with trailing-dim broadcast."""
    extra = x.dim() - mask.dim()
    return torch.where(mask.reshape(mask.shape + (1,) * extra), x, y)


def _u32(x):
    """Wrap an int64 tensor of uint32 arithmetic to [0, 2**32)."""
    return x & M32


def _i32(x64):
    """int64 -> int32 with two's-complement wrap (as a uint32 -> int32
    cast does in JAX)."""
    x64 = x64 & M32
    return (x64 - ((x64 >> 31) << 32)).to(torch.int32)


def _word_to_i32(a):
    """u256 word -> (int32 value, overflow mask). Values >= 2**31 overflow."""
    lo = a[..., 0].to(torch.int64) + (a[..., 1].to(torch.int64) << 16)
    big = torch.any(a[..., 2:] != 0, dim=-1) | (lo >= (1 << 31))
    return _i32(lo), big


def _addr160(word):
    """Truncate a u256 word mod 2**160 (10 of 16 limbs)."""
    out = word.clone()
    out[:, 10:] = 0
    return out


def _mem_gas(words):
    """3w + w*w//512 in uint32 arithmetic (wraps as the JAX kernel's
    does), as int64 in [0, 2**32)."""
    w = words.to(torch.int64) & M32
    return _u32(_u32(3 * w) + _u32(w * w) // 512)


def _lane_word(lo32):
    """An int64 holding a uint32 value -> u256 word (limbs 0 and 1)."""
    word = torch.zeros(lo32.shape + (W,), dtype=u256.DTYPE, device=lo32.device)
    word[:, 0] = (lo32 & 0xFFFF).to(u256.DTYPE)
    word[:, 1] = (lo32 >> 16).to(u256.DTYPE)
    return word


BIGOFF = 1 << 29  # stands in for any offset/len >= 2**31


def step(batch: StateBatch, code: CodeTable,
         track_coverage: bool = True, present: frozenset = None,
         phases: Optional[PhaseSet] = None) -> StateBatch:
    """Execute one instruction on every live lane.

    Updates `batch.stack`, `mem`, `storage_keys`, `storage_vals`,
    `pc_seen`, `br_pc` and `br_taken` in place and returns the batch
    with its other fields replaced.

    `present` is the set of opcodes that gates the handlers. None reads
    it from the card (`_present`, one host read). A caller that has read
    it already (the symbolic step) passes it; any superset of the
    opcodes executing lanes run gives the same result.

    `phases` prunes handler phases (None: the generic step)."""
    n = batch.pc.shape[0]
    dev = batch.pc.device
    mem_cap = batch.mem.shape[1]
    stack_cap = batch.stack.shape[1]
    cd_cap = batch.calldata.shape[1]
    lanes = torch.arange(n, device=dev)
    i32 = torch.int32

    # ---- fetch -----------------------------------------------------------
    code_id = batch.code_id.clamp(0, code.ops.shape[0] - 1).long()
    code_len = code.length[code_id]
    oob = batch.pc >= code_len  # running off the code ends the tx
    pc_safe = batch.pc.clamp(0, code.ops.shape[1] - 33).long()
    # one 33-byte window serves the opcode fetch (byte 0) and the PUSH
    # payload (bytes 1..32)
    code_win = code.ops[code_id[:, None],
                        pc_safe[:, None] + torch.arange(33, device=dev)]
    op = code_win[:, 0].to(i32)

    active = batch.status == Status.RUNNING
    halt_oob = active & oob
    live = active & ~oob

    meta = _meta(dev)[op.long()]
    valid = meta[:, 0] != 0
    supported = meta[:, 1] != 0
    pops = meta[:, 2]
    net_sp = meta[:, 3]
    underflow = batch.sp < pops
    over_cap = batch.sp + net_sp > stack_cap
    if stack_cap >= 1024:
        # the model holds the full EVM stack: the genuine stack-limit
        # exception fires at the EVM's 1024
        overflow = batch.sp + net_sp > 1024
        cap_degrade = torch.zeros_like(over_cap)
    else:
        # a model cap below the EVM's 1024 degrades to the host engine
        # instead of reporting a stack error the contract may not have
        overflow = torch.zeros_like(over_cap)
        cap_degrade = over_cap

    is_invalid_op = live & (~valid | (op == INVALID_OP))
    is_unsupported = live & valid & ~supported & (op != INVALID_OP)
    is_unsupported = is_unsupported | (
        live & valid & supported & ~underflow & cap_degrade)
    pruned = phases is not None and bool(phases.pruned)
    if pruned:
        # the specialization safety net: a pruned phase's opcode parks
        # the lane UNSUPPORTED at the instruction
        unhandled = _unhandled(phases, dev)[op.long()]
        is_unsupported = is_unsupported | (
            live & valid & supported & ~underflow & ~cap_degrade & unhandled)
    stack_err = live & valid & supported & (underflow | overflow)
    ex = (live & valid & supported & ~stack_err & ~cap_degrade
          & (op != INVALID_OP))  # executing
    if pruned:
        ex = ex & ~unhandled
    if present is None:
        present = _present(op, ex)
    elif pruned:
        # a caller's set may hold pruned opcodes no lane executes
        present = present - _unhandled_bytes(phases)

    def on(*ops):
        return any(o in present for o in ops)

    # ---- operands: one gather for a/b/c and the DUP/SWAP depths ---------
    dup_n = op - 0x80
    swap_n = op - 0x8F
    peek_ks = torch.stack([torch.zeros_like(op), torch.ones_like(op),
                           torch.full_like(op, 2), dup_n, swap_n], dim=1)
    peek_idx = (batch.sp[:, None] - 1 - peek_ks).clamp(0, stack_cap - 1).long()
    peeked = batch.stack[lanes[:, None], peek_idx]  # [n, 5, W]
    a, b, c = peeked[:, 0], peeked[:, 1], peeked[:, 2]
    dup_val, swap_deep_val = peeked[:, 3], peeked[:, 4]

    status = batch.status
    status = torch.where(halt_oob, Status.STOPPED, status)
    status = torch.where(is_invalid_op, Status.INVALID, status)
    status = torch.where(is_unsupported, Status.UNSUPPORTED, status)
    status = torch.where(stack_err, Status.ERR_STACK, status)

    # result accumulation: one stack slot per opcode. Pop-then-push ops
    # write at sp-pops; DUP writes the new top (sp); SWAP writes sp-1.
    res = {"val": torch.zeros((n, W), dtype=u256.DTYPE, device=dev),
           "mask": torch.zeros((n,), dtype=torch.bool, device=dev)}
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    res_idx = torch.where(
        is_dup, batch.sp, torch.where(is_swap, batch.sp - 1, batch.sp - pops))
    res_idx = res_idx.clamp(0, stack_cap - 1).long()

    mem = batch.mem
    msize = batch.msize_words
    zeros64 = torch.zeros((n,), dtype=torch.int64, device=dev)
    gas = {"min": zeros64, "max": zeros64}
    skeys, svals, scnt = batch.storage_keys, batch.storage_vals, batch.storage_cnt
    ret_offset, ret_len = batch.ret_offset, batch.ret_len
    balance = batch.balance

    def put(mask, val):
        res["val"] = _m(mask, val, res["val"])
        res["mask"] = res["mask"] | mask

    def add_gas(dmin, dmax=None):
        gas["min"] = _u32(gas["min"] + dmin)
        gas["max"] = _u32(gas["max"] + (dmin if dmax is None else dmax))

    # ---- external calls in a codeless world ------------------------------
    # A call to an account without code is a plain ether transfer plus a
    # success push. Lanes whose callee might carry code (self-calls,
    # precompiles, batches with foreign code) degrade to UNSUPPORTED.
    if on(EXTCODESIZE_OP):
        extsz = ex & (op == EXTCODESIZE_OP)
        extsz_self = u256.eq(_addr160(a), batch.address)
        extsz_ok = extsz & ((batch.empty_world != 0) | extsz_self)
        status = torch.where(extsz & ~extsz_ok, Status.UNSUPPORTED, status)
        extsz_word = torch.zeros((n, W), dtype=u256.DTYPE, device=dev)
        extsz_word[:, 0] = torch.where(extsz_self, code_len, 0)
        put(extsz_ok, extsz_word)

    # RETURNDATACOPY: device lanes always have an empty return buffer,
    # so the (dest, 0, 0) form is a no-op; anything else goes to host.
    if on(RETURNDATACOPY_OP):
        rdc = ex & (op == RETURNDATACOPY_OP)
        rdc_ok = rdc & u256.is_zero(b) & u256.is_zero(c)
        status = torch.where(rdc & ~rdc_ok, Status.UNSUPPORTED, status)

    if on(*CALL_OPS):
        call_any = ex & ((op == CALL_OP) | (op == CALLCODE_OP)
                         | (op == DELEGATECALL_OP) | (op == STATICCALL_OP))
        callee = _addr160(b)
        callee_precompile = (
            torch.all(callee[:, 1:] == 0, dim=-1)
            & (callee[:, 0] >= 1) & (callee[:, 0] <= 9))
        # window operands sit at depth 3..6 for CALL/CALLCODE and 2..5
        # for DELEGATECALL/STATICCALL
        win0 = torch.where((op == CALL_OP) | (op == CALLCODE_OP), 3, 2)
        win_ks = win0[:, None] + torch.arange(4, device=dev)
        win_idx = (batch.sp[:, None] - 1 - win_ks).clamp(0, stack_cap - 1).long()
        windows = batch.stack[lanes[:, None], win_idx]
        in_off_i, in_off_big = _word_to_i32(windows[:, 0])
        in_len_i, in_len_big = _word_to_i32(windows[:, 1])
        ret_off_i, ret_off_big = _word_to_i32(windows[:, 2])
        ret_len_i, ret_len_big = _word_to_i32(windows[:, 3])

        def _win_words(off_i, len_i):
            # int32 sum: wraps as the JAX kernel's does
            return torch.where(len_i > 0, (off_i + len_i + 31) // 32, 0)

        want_words = torch.maximum(
            _win_words(in_off_i, in_len_i), _win_words(ret_off_i, ret_len_i))
        win_bad = (in_len_big | ret_len_big
                   | ((in_len_i > 0) & in_off_big)
                   | ((ret_len_i > 0) & ret_off_big)
                   | (want_words > (1 << 15)))
        runnable = ((batch.empty_world != 0) & ~u256.eq(callee, batch.address)
                    & ~callee_precompile & ~win_bad)
        status = torch.where(call_any & ~runnable, Status.UNSUPPORTED, status)
        call_exec = call_any & runnable
        carries_value = (op == CALL_OP) | (op == CALLCODE_OP)
        call_value = _m(call_exec & carries_value, c, torch.zeros_like(c))
        can_pay = ~u256.ult(balance, call_value)
        put(call_exec, u256.bool_to_word(can_pay))
        # only an outgoing CALL moves ether (CALLCODE pays itself)
        outgoing = call_exec & (op == CALL_OP) & can_pay
        balance = _m(outgoing, u256.sub(balance, call_value), balance)
        new_msize = torch.maximum(msize, want_words)
        mem_gas = torch.where(
            call_exec, _u32(_mem_gas(new_msize) - _mem_gas(msize)), 0)
        msize = torch.where(call_exec, new_msize, msize)
        add_gas(mem_gas)

    # ---- cheap arithmetic / compares / bitwise ---------------------------
    cheap = {
        ADD: lambda: u256.add(a, b),
        SUB: lambda: u256.sub(a, b),
        MUL: lambda: u256.mul(a, b),
        AND: lambda: a & b,
        OR: lambda: a | b,
        XOR: lambda: a ^ b,
        LT: lambda: u256.bool_to_word(u256.ult(a, b)),
        GT: lambda: u256.bool_to_word(u256.ult(b, a)),
        SLT: lambda: u256.bool_to_word(u256.slt(a, b)),
        SGT: lambda: u256.bool_to_word(u256.slt(b, a)),
        EQ: lambda: u256.bool_to_word(u256.eq(a, b)),
        BYTE: lambda: u256.byte_op(a, b),
        SHL: lambda: u256.shl(b, u256.shift_amount(a)),
        SHR: lambda: u256.lshr(b, u256.shift_amount(a)),
        SAR: lambda: u256.ashr(b, u256.shift_amount(a)),
        SIGNEXTEND: lambda: u256.signextend(a, b),
        ISZERO: lambda: u256.bool_to_word(u256.is_zero(a)),
        NOT: lambda: u256.bit_not(a),
    }
    for byte_, fn in cheap.items():
        if byte_ in present:
            put(ex & (op == byte_), fn())

    # ---- expensive arithmetic --------------------------------------------
    # operands of lanes outside the phase are zeroed before the
    # bit-serial loops, whose trip count follows the largest operand;
    # those lanes' results are masked out either way
    if on(*DIV_OPS):
        div_mask = ex & ((op == DIV) | (op == SDIV) | (op == MOD) | (op == SMOD))
        q, qs, r, rs = u256.divmod_all(_m(div_mask, a, 0), _m(div_mask, b, 0))
        put(div_mask, _m(op == DIV, q, _m(op == SDIV, qs, _m(op == MOD, r, rs))))

    if on(ADDMOD, MULMOD):
        modmask = ex & ((op == ADDMOD) | (op == MULMOD))
        am, mm = u256.addmod_mulmod(
            _m(modmask, a, 0), _m(modmask, b, 0), _m(modmask, c, 0))
        put(modmask, _m(op == ADDMOD, am, mm))

    if on(EXP):
        exp_mask = ex & (op == EXP)
        put(exp_mask, u256.exp(a, _m(exp_mask, b, 0)))
        # dynamic gas: priced per byte of exponent (b)
        k1 = torch.arange(1, W + 1, device=dev, dtype=i32)
        high_limb = torch.where(b != 0, k1, 0).amax(-1)
        top_limb = torch.gather(
            b, 1, (high_limb - 1).clamp(0, W - 1).long()[:, None])[:, 0]
        exp_bytes = torch.where(
            high_limb > 0, 2 * high_limb - (top_limb < 256).to(i32), 0)
        exp_bytes = torch.where(exp_mask, exp_bytes, 0).to(torch.int64)
        # 10/byte is the Frontier/Homestead price; 50/byte (EIP-160)
        # bounds the maximum
        add_gas(10 * exp_bytes, 50 * exp_bytes)

    # ---- environment / block pushes --------------------------------------
    zero_w = torch.zeros((n, W), dtype=u256.DTYPE, device=dev)
    budget = batch.gas_budget
    # GAS pushes the gas remaining after its own charge (2); gas_left
    # also feeds the memory-expansion OOG estimate
    gas_left = budget - torch.minimum(_u32(batch.gas_min + 2), budget)

    env = {
        ADDRESS: lambda: batch.address,
        CALLER: lambda: batch.caller,
        ORIGIN: lambda: batch.origin,
        CALLVALUE: lambda: batch.callvalue,
        GASPRICE: lambda: batch.gasprice,
        SELFBALANCE: lambda: batch.balance,
        TIMESTAMP: lambda: batch.timestamp,
        NUMBER: lambda: batch.number,
        COINBASE: lambda: batch.coinbase,
        DIFFICULTY: lambda: batch.difficulty,
        GASLIMIT: lambda: batch.gaslimit,
        CHAINID: lambda: batch.chainid,
        BASEFEE: lambda: batch.basefee,
        CALLDATASIZE: lambda: torch.nn.functional.pad(
            batch.calldatasize[:, None], (0, W - 1)),
        CODESIZE: lambda: torch.nn.functional.pad(code_len[:, None], (0, W - 1)),
        RETURNDATASIZE: lambda: zero_w,
        MSIZE: lambda: _lane_word(_u32(msize.to(torch.int64) * 32)),
        PC: lambda: _lane_word(batch.pc.to(torch.int64) & M32),
        GAS: lambda: _lane_word(gas_left),
        # BALANCE: own account -> balance, anything else -> 0
        BALANCE: lambda: _m(u256.eq(a, batch.address), batch.balance, zero_w),
        # BLOCKHASH: zero (no chain on device)
        BLOCKHASH: lambda: zero_w,
    }
    for byte_, fn in env.items():
        if byte_ in present:
            put(ex & (op == byte_), fn())

    # top-of-stack as an i32 offset: CALLDATALOAD's operand, and the
    # memory/hash/log/halt phases' window base
    off_i, off_big = _word_to_i32(a)

    # ---- CALLDATALOAD ----------------------------------------------------
    if on(CALLDATALOAD):
        cdl_mask = ex & (op == CALLDATALOAD)
        cd_idx = off_i.clamp(0, cd_cap)[:, None] + torch.arange(32, device=dev)
        cd_in = (cd_idx < batch.calldatasize[:, None]) & (cd_idx < cd_cap)
        cd_bytes = torch.gather(batch.calldata, 1, cd_idx.clamp(0, cd_cap - 1).long())
        cd_bytes = torch.where(cd_in, cd_bytes, 0)
        put(cdl_mask, _m(off_big, zero_w, u256.bytes_to_word(cd_bytes)))

    # ---- PUSHn -----------------------------------------------------------
    push_mask = ex & (op >= 0x60) & (op <= 0x7F)
    push_n = op - 0x5F
    if on(*PUSH_OPS):
        pword = u256.lshr(u256.bytes_to_word(code_win[:, 1:]), 8 * (32 - push_n))
        put(push_mask, pword)

    # ---- DUP / SWAP ------------------------------------------------------
    swap_mask = ex & (op >= 0x90) & (op <= 0x9F)
    if on(*DUP_OPS):
        put(ex & (op >= 0x80) & (op <= 0x8F), dup_val)
    if on(*SWAP_OPS):
        # the deep value goes to the top through the result write; the
        # top goes to the deep slot in the second write below
        put(swap_mask, swap_deep_val)

    def expand(mask, off_i32, nbytes, msize, status, over_status=Status.ERR_MEM):
        """Memory expansion accounting + capacity check.

        Zero-length accesses never expand memory. Accesses past mem_cap
        whose true expansion gas provably exceeds the lane's remaining
        budget halt with ERR_OOG; the gas is estimated in float32, in
        the JAX kernel's order of operations."""
        # clamp before adding: offsets just below 2**31 would wrap
        off_c = torch.clamp(off_i32, max=BIGOFF)
        nb = torch.clamp(torch.as_tensor(nbytes, dtype=i32, device=dev)
                         .expand(mask.shape), max=BIGOFF)
        end = off_c + nb
        nz = mask & (nb > 0)
        over = nz & (end > mem_cap)
        wf = ((end + 31) // 32).to(torch.float32)
        est = (3.0 * wf + wf * wf / 512.0) - _mem_gas(msize).to(torch.float32)
        oog = over & (est > gas_left.to(torch.float32))
        bad = over & ~oog
        grow_mask = nz & ~over
        new_words = torch.where(grow_mask, (end + 31) // 32, 0)
        grow = torch.maximum(new_words, msize)
        delta = torch.where(grow_mask, _u32(_mem_gas(grow) - _mem_gas(msize)), 0)
        add_gas(delta)
        msize = torch.where(grow_mask, grow, msize)
        status = torch.where(oog, Status.ERR_OOG, status)
        status = torch.where(bad, over_status, status)
        return msize, status, mask & ~over

    # ---- SHA3 ------------------------------------------------------------
    if on(SHA3):
        sha_mask = ex & (op == SHA3)
        len_i, len_big = _word_to_i32(b)
        sha_off = torch.where(off_big, BIGOFF, off_i)
        sha_len = torch.where(len_big, BIGOFF, len_i)
        # charge memory expansion over the hashed range first;
        # unaffordable huge ranges OOG, affordable-but-over-cap ones go
        # back to the host engine
        msize, status, sha_exp_ok = expand(
            sha_mask, sha_off, sha_len, msize, status,
            over_status=Status.UNSUPPORTED)
        sha_toobig = sha_exp_ok & (sha_len > HASH_CAP)
        sha_ok = sha_exp_ok & ~sha_toobig

        # one launch on the card: each lane absorbs its own blocks
        put(sha_ok, keccak_cuda.keccak_sponge(mem, off_i, len_i, sha_ok))
        # affordable inputs beyond the device hash cap go to the host
        status = torch.where(sha_toobig, Status.UNSUPPORTED, status)
        sha_words = torch.where(sha_ok, (len_i + 31) // 32, 0).to(torch.int64)
        add_gas(6 * sha_words)

    # ---- memory ----------------------------------------------------------
    if on(MLOAD):
        mload_mask = ex & (op == MLOAD)
        msize, status, mload_ok = expand(
            mload_mask, torch.where(off_big, BIGOFF, off_i), 32, msize, status)
        idx = off_i.clamp(0, mem_cap - 32)[:, None] + torch.arange(32, device=dev)
        byts = torch.gather(mem, 1, idx.long())
        put(mload_ok, u256.bytes_to_word(byts))

    if on(MSTORE):
        mstore_mask = ex & (op == MSTORE)
        msize, status, mstore_ok = expand(
            mstore_mask, torch.where(off_big, BIGOFF, off_i), 32, msize, status)
        # every scattered byte is the slot's final value: a lane that
        # does not store writes back what is there
        idx = off_i.clamp(0, mem_cap - 32)[:, None] + torch.arange(32, device=dev)
        rel = idx - off_i[:, None]
        inw = (rel >= 0) & (rel < 32) & mstore_ok[:, None]
        src = torch.gather(u256.word_to_bytes(b), 1, rel.clamp(0, 31).long())
        idx = idx.long()
        mem.scatter_(1, idx, torch.where(inw, src, torch.gather(mem, 1, idx)))

    if on(MSTORE8):
        m8_mask = ex & (op == MSTORE8)
        msize, status, m8_ok = expand(
            m8_mask, torch.where(off_big, BIGOFF, off_i), 1, msize, status)
        idx = off_i.clamp(0, mem_cap - 1).long()[:, None]
        byte8 = (b[:, 0] & 0xFF).to(torch.uint8)[:, None]
        mem.scatter_(1, idx, torch.where(m8_ok[:, None], byte8,
                                         torch.gather(mem, 1, idx)))

    # ---- CALLDATACOPY / CODECOPY -----------------------------------------
    if on(CALLDATACOPY, CODECOPY):
        copy_mask = ex & ((op == CALLDATACOPY) | (op == CODECOPY))
        dst_i, dst_big = _word_to_i32(a)
        src_i, src_big = _word_to_i32(b)
        cplen_i, cplen_big = _word_to_i32(c)
        # a huge source offset is legal: reads past the data are zeros
        src_i = torch.where(src_big, BIGOFF, src_i)
        msize, status, copy_ok = expand(
            copy_mask, torch.where(dst_big, BIGOFF, dst_i),
            torch.where(cplen_big, BIGOFF, cplen_i), msize, status)
        copy_words = torch.where(copy_ok, (cplen_i + 31) // 32, 0).to(torch.int64)
        add_gas(3 * copy_words)
        # every memory byte of every lane, as the JAX step does
        rel = torch.arange(mem_cap, device=dev)[None, :] - dst_i[:, None]
        inw = (rel >= 0) & (rel < cplen_i[:, None]) & copy_ok[:, None]
        sidx = src_i[:, None] + rel
        cd_ok = ((sidx >= 0) & (sidx < batch.calldatasize[:, None])
                 & (sidx < cd_cap))
        from_cd = torch.gather(batch.calldata, 1, sidx.clamp(0, cd_cap - 1).long())
        from_cd = torch.where(cd_ok, from_cd, 0)
        co_ok = (sidx >= 0) & (sidx < code_len[:, None])
        from_co = code.ops[code_id[:, None],
                           sidx.clamp(0, code.ops.shape[1] - 1).long()]
        from_co = torch.where(co_ok, from_co, 0)
        src = torch.where((op == CALLDATACOPY)[:, None], from_cd, from_co)
        mem.copy_(torch.where(inw, src, mem))

    # ---- storage ---------------------------------------------------------
    if on(SLOAD, SSTORE):
        s_cap = skeys.shape[1]
        slots = torch.arange(s_cap, device=dev)
        hit = torch.all(skeys == a[:, None, :], dim=-1) & (slots < scnt[:, None])
        any_hit = torch.any(hit, dim=-1)
        # the latest matching entry (0 when none, as JAX's argmax gives)
        last = (torch.where(hit, slots + 1, 0).amax(-1) - 1).clamp(min=0)

    if on(SLOAD):
        sload_mask = ex & (op == SLOAD)
        val = svals[lanes, last]
        put(sload_mask, _m(any_hit, val, torch.zeros_like(val)))

    if on(SSTORE):
        sstore_mask = ex & (op == SSTORE)
        slot = torch.where(any_hit, last, scnt.long())
        full = sstore_mask & ~any_hit & (scnt >= s_cap)
        write = sstore_mask & ~full
        slot = slot.clamp(0, s_cap - 1)
        slot_write_many(slot, write, [(skeys, a), (svals, b)])
        scnt = torch.where(write & ~any_hit, scnt + 1, scnt)
        status = torch.where(full, Status.ERR_MEM, status)

    # ---- LOGn: pure pops (topics + data range) ---------------------------
    if on(*LOG_OPS):
        log_mask = ex & (op >= 0xA0) & (op <= 0xA4)
        log_len_i, log_len_big = _word_to_i32(b)
        msize, status, log_ok = expand(
            log_mask, torch.where(off_big, BIGOFF, off_i),
            torch.where(log_len_big, BIGOFF, log_len_i), msize, status)
        add_gas(torch.where(log_ok, _u32(8 * (log_len_i.to(torch.int64) & M32)), 0))

    # ---- halts -----------------------------------------------------------
    status = torch.where(ex & (op == STOP), Status.STOPPED, status)
    status = torch.where(ex & (op == SELFDESTRUCT), Status.KILLED, status)

    if on(RETURN, REVERT):
        retrev_mask = ex & ((op == RETURN) | (op == REVERT))
        rr_len_i, rr_len_big = _word_to_i32(b)
        msize, status, rr_ok = expand(
            retrev_mask, torch.where(off_big, BIGOFF, off_i),
            torch.where(rr_len_big, BIGOFF, rr_len_i), msize, status)
        ret_offset = torch.where(rr_ok, off_i, ret_offset)
        ret_len = torch.where(rr_ok, rr_len_i, ret_len)
        status = torch.where(rr_ok & (op == RETURN), Status.RETURNED, status)
        status = torch.where(rr_ok & (op != RETURN), Status.REVERTED, status)

    # ---- jumps + pc ------------------------------------------------------
    jump_mask = ex & (op == JUMP)
    jumpi_mask = ex & (op == JUMPI)
    taken = jumpi_mask & ~u256.is_zero(b)
    do_jump = jump_mask | taken
    pc_next = batch.pc + 1 + torch.where(push_mask, push_n, 0)
    if on(JUMP, JUMPI):
        dest_i, dest_big = _word_to_i32(a)
        jd_cap = code.jumpdest.shape[1]
        dest_ok = (~dest_big & (dest_i < code_len) & (dest_i < jd_cap)
                   & code.jumpdest[code_id, dest_i.clamp(0, jd_cap - 1).long()])
        status = torch.where(do_jump & ~dest_ok, Status.ERR_JUMP, status)
        pc_next = torch.where(do_jump & dest_ok, dest_i, pc_next)
    pc_new = torch.where(ex & (status == Status.RUNNING), pc_next, batch.pc)

    # ---- stack/sp write --------------------------------------------------
    # an op that degraded mid-step (capacity -> UNSUPPORTED/ERR_MEM)
    # leaves the lane exactly AT the instruction: no sp delta, no static
    # gas, so a host engine can re-execute it
    interrupted = ex & ((status == Status.UNSUPPORTED) | (status == Status.ERR_MEM))
    effective = ex & ~interrupted
    # one launch writes the result slot and SWAP's deep slot; the result
    # slot is the second write, so it wins a tie, as in the JAX kernel's
    # nested select
    res_write = (res_idx, res["mask"] & effective, res["val"])
    if on(*SWAP_OPS):
        swap_idx = (batch.sp - 1 - swap_n).clamp(0, stack_cap - 1).long()
        slot_write(batch.stack, swap_idx, swap_mask & ~interrupted, a, *res_write)
    else:
        slot_write(batch.stack, *res_write)
    sp = torch.where(effective, batch.sp + net_sp, batch.sp)

    # ---- gas (static bounds from the metadata row) -----------------------
    gas_min = _u32(batch.gas_min + torch.where(effective, meta[:, 4], 0) + gas["min"])
    gas_max = _u32(batch.gas_max + torch.where(effective, meta[:, 5], 0) + gas["max"])
    # out-of-gas: even the minimum-cost path exceeded this lane's budget
    oog = active & (gas_min > batch.gas_budget) & (status != Status.UNSUPPORTED)
    status = torch.where(oog, Status.ERR_OOG, status)

    # ---- concolic branch journal: each JUMPI decision in order -----------
    br_cnt = batch.br_cnt
    if on(JUMPI):
        br_cap = batch.br_pc.shape[1]
        br_slot = br_cnt.clamp(0, br_cap - 1).long()
        record = jumpi_mask & (br_cnt < br_cap)
        slot_write_many(br_slot, record, [(batch.br_pc, batch.pc),
                                          (batch.br_taken, taken.to(torch.uint8))])
        br_cnt = br_cnt + record.to(torch.int32)

    # ---- coverage bitmap: this step's pc for every executing lane --------
    if track_coverage:
        word_idx = (batch.pc // 32).clamp(0, batch.pc_seen.shape[1] - 1).long()
        # bit 31 is the int32's sign bit: the same bit pattern as uint32
        bit = torch.ones_like(batch.pc) << (batch.pc % 32)
        seen = batch.pc_seen[lanes, word_idx]
        slot_write(batch.pc_seen, word_idx, ex, seen | bit)

    return batch._replace(
        pc=pc_new,
        br_cnt=br_cnt,
        sp=sp,
        balance=balance,
        msize_words=msize,
        storage_cnt=scnt,
        status=status,
        gas_min=gas_min,
        gas_max=gas_max,
        ret_offset=ret_offset,
        ret_len=ret_len,
    )
