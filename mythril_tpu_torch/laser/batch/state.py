"""StateBatch: the EVM machine state as a structure of tensors.

A batch of N machine states is one NamedTuple of fixed-shape tensors,
with the JAX package's field names, order and shapes (N = lanes):

  pc            i32[N]
  stack         i32[N, STACK_CAP, 16]   (256-bit words as 16x16-bit limbs)
  sp            i32[N]                  (next free slot)
  mem           u8[N, MEM_CAP]
  msize_words   i32[N]                  (EVM memory size in 32-byte words)
  storage_*     bounded key/value journal per lane
  status        i32[N]                  (Status enum)
  gas_min/max   i64[N]                  (uint32 values, wrapped mod 2**32)

plus per-lane environment words (caller, callvalue, calldata, block ctx).

Dtypes differ from the JAX package's where PyTorch lacks a usable
uint32: limb words are int32 (values below 2**16), the uint32 gas
fields are int64 holding values in [0, 2**32), and the uint32 coverage
bitmap `pc_seen` is int32 holding the same bit pattern. `NUMPY_DTYPES`
gives each field's JAX dtype; `interop.batch_to_numpy` converts back
exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.ops.keccak import SPONGE_MAX_BLOCKS
from mythril_tpu_torch.support.accel import resolve_device

STACK_CAP = 128  # configurable; EVM max is 1024, real contracts stay shallow
MEM_CAP = 4096  # bytes of modelled memory per lane
STORAGE_CAP = 64  # journal entries per lane
CALLDATA_CAP = 512  # bytes of calldata per lane
SHA_RATE = 136  # keccak-256 rate in bytes
SHA_MAX_BLOCKS = SPONGE_MAX_BLOCKS  # 8 absorption blocks per SHA3 on device
HASH_CAP = SHA_MAX_BLOCKS * SHA_RATE - 1  # 1087 B of SHA3 input on device
PC_BITMAP_WORDS = 768  # coverage bitmap words (EVM max code size 24576 / 32)
BRANCH_CAP = 64  # recorded JUMPI decisions per lane (concolic journal)


class Status:
    RUNNING = 0
    STOPPED = 1
    RETURNED = 2
    REVERTED = 3
    INVALID = 4  # ASSERT_FAIL / designated invalid opcode
    ERR_STACK = 5  # under/overflow
    ERR_JUMP = 6  # invalid jump destination
    ERR_MEM = 7  # memory model capacity exceeded
    UNSUPPORTED = 8  # opcode outside the device set -> host takes over
    ERR_OOG = 9  # minimum gas bound exceeded the lane's gas budget
    KILLED = 10  # SELFDESTRUCT executed (a successful halt)

    HALTED = (STOPPED, RETURNED, REVERTED, INVALID, ERR_STACK, ERR_JUMP,
              ERR_MEM, UNSUPPORTED, ERR_OOG, KILLED)


class CodeTable(NamedTuple):
    """Shared contract store: lanes reference rows by code_id."""

    ops: torch.Tensor  # u8[C, CODE_CAP + 33] (zero-padded for PUSH reads)
    jumpdest: torch.Tensor  # bool[C, CODE_CAP]
    length: torch.Tensor  # i32[C]


class StateBatch(NamedTuple):
    code_id: torch.Tensor
    pc: torch.Tensor
    stack: torch.Tensor
    sp: torch.Tensor
    mem: torch.Tensor
    msize_words: torch.Tensor
    storage_keys: torch.Tensor
    storage_vals: torch.Tensor
    storage_cnt: torch.Tensor
    status: torch.Tensor
    gas_min: torch.Tensor
    gas_max: torch.Tensor
    gas_budget: torch.Tensor  # lane OOGs when gas_min exceeds it
    ret_offset: torch.Tensor
    ret_len: torch.Tensor
    pc_seen: torch.Tensor  # [N, PC_BITMAP_WORDS] executed-pc bitmap
    br_pc: torch.Tensor  # i32[N, BRANCH_CAP] JUMPI pcs in execution order
    br_taken: torch.Tensor  # u8[N, BRANCH_CAP] 1 = branch taken
    br_cnt: torch.Tensor  # i32[N] journal length (saturates at BRANCH_CAP)
    # environment
    address: torch.Tensor  # i32[N,16]
    caller: torch.Tensor
    origin: torch.Tensor
    callvalue: torch.Tensor
    gasprice: torch.Tensor
    balance: torch.Tensor  # active account balance
    calldata: torch.Tensor  # u8[N, CALLDATA_CAP]
    calldatasize: torch.Tensor  # i32[N]
    # block context
    timestamp: torch.Tensor
    number: torch.Tensor
    coinbase: torch.Tensor
    difficulty: torch.Tensor
    gaslimit: torch.Tensor
    chainid: torch.Tensor
    basefee: torch.Tensor
    # world model: 1 = no foreign account carries code, so CALL-family
    # ops to non-self, non-precompile addresses execute on device as
    # plain transfers; 0 = calls hand off to the host
    empty_world: torch.Tensor  # u8[N]

    @property
    def n_lanes(self) -> int:
        return self.pc.shape[0]

    @property
    def active(self):
        return self.status == Status.RUNNING


_WORD_FIELDS = (
    "stack", "storage_keys", "storage_vals", "address", "caller", "origin",
    "callvalue", "gasprice", "balance", "timestamp", "number", "coinbase",
    "difficulty", "gaslimit", "chainid", "basefee",
)
_GAS_FIELDS = ("gas_min", "gas_max", "gas_budget")
_BYTE_FIELDS = ("mem", "calldata", "br_taken", "empty_world")

#: each field's dtype in the JAX package (numpy form)
NUMPY_DTYPES = {
    name: (
        np.uint32 if name in _WORD_FIELDS + _GAS_FIELDS + ("pc_seen",)
        else np.uint8 if name in _BYTE_FIELDS
        else np.int32
    )
    for name in StateBatch._fields
}

#: each field's dtype in the port
TORCH_DTYPES = {
    name: (
        torch.int64 if name in _GAS_FIELDS
        else torch.uint8 if name in _BYTE_FIELDS
        else torch.int32
    )
    for name in StateBatch._fields
}

_NP_OF = {torch.int64: np.int64, torch.int32: np.int32, torch.uint8: np.uint8}


def field_to_torch(name: str, arr, device) -> torch.Tensor:
    """One field from its JAX numpy form to the port's tensor."""
    arr = np.asarray(arr)
    if name == "pc_seen":
        arr = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    else:
        arr = np.ascontiguousarray(arr, dtype=_NP_OF[TORCH_DTYPES[name]])
    # torch.tensor copies: the batch never aliases the caller's arrays
    return torch.tensor(arr, device=device)


def field_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    """One field from the port's tensor to its JAX numpy dtype, exactly."""
    arr = t.detach().cpu().numpy()
    if name == "pc_seen":
        return arr.view(np.uint32)
    return arr.astype(NUMPY_DTYPES[name])


def batch_from_fields(fields, device) -> StateBatch:
    """A StateBatch of tensors on `device` from the JAX numpy fields."""
    return StateBatch(*(field_to_torch(name, arr, device)
                        for name, arr in zip(StateBatch._fields, fields)))


def make_code_table(codes, code_cap: int = None, device=None) -> CodeTable:
    """Build a CodeTable from a list of bytecode byte strings, on the
    card unless `device` names another."""
    from mythril_tpu_torch.disassembler.asm import to_dense

    device = resolve_device(device)
    code_cap = code_cap or max((len(c) for c in codes), default=1)
    ops = np.zeros((len(codes), code_cap + 33), dtype=np.uint8)
    jd = np.zeros((len(codes), code_cap), dtype=bool)
    length = np.zeros((len(codes),), dtype=np.int32)
    for i, code in enumerate(codes):
        o, j = to_dense(code, max_len=code_cap)
        ops[i, :code_cap] = o
        jd[i] = j
        length[i] = min(len(code), code_cap)
    return CodeTable(torch.from_numpy(ops).to(device),
                     torch.from_numpy(jd).to(device),
                     torch.from_numpy(length).to(device))


def _word_rows(n, value: int = 0):
    return np.broadcast_to(u256.from_int(value), (n, u256.LIMBS))


def make_batch_numpy(
    n: int,
    code_ids=None,
    calldata=None,
    callvalue=0,
    caller: int = 0xDEADBEEFDEADBEEF,
    address: int = 0xAFFEAFFE,
    balance: int = 10**18,
    timestamp: int = 1_600_000_000,
    number: int = 10_000_000,
    chainid: int = 1,
    gasprice: int = 10,
    gas_budget: int = 8_000_000,
    mem_cap: int = MEM_CAP,
    calldata_cap: int = CALLDATA_CAP,
    storage_cap: int = STORAGE_CAP,
    stack_cap: int = STACK_CAP,
    storage_seed=None,
    empty_world=True,
) -> StateBatch:
    """The fresh batch of `make_batch` as host numpy arrays in the JAX
    package's dtypes (the layout its `make_batch(..., as_numpy=True)`
    returns)."""
    code_ids = (
        np.zeros((n,), np.int32)
        if code_ids is None
        else np.asarray(code_ids, np.int32)
    )
    cd = np.zeros((n, calldata_cap), dtype=np.uint8)
    cds = np.zeros((n,), dtype=np.int32)
    if calldata is not None:
        for i, data in enumerate(calldata):
            m = min(len(data), calldata_cap)
            cd[i, :m] = np.frombuffer(bytes(data[:m]), dtype=np.uint8)
            cds[i] = len(data)
    skeys = np.zeros((n, storage_cap, u256.LIMBS), dtype=np.uint32)
    svals = np.zeros((n, storage_cap, u256.LIMBS), dtype=np.uint32)
    scnt = np.zeros((n,), dtype=np.int32)
    if storage_seed is not None:
        for i, journal in enumerate(storage_seed):
            for j, (slot, value) in enumerate(
                list((journal or {}).items())[:storage_cap]
            ):
                skeys[i, j] = u256.from_int(slot)
                svals[i, j] = u256.from_int(value)
                scnt[i] = j + 1
    return StateBatch(
        code_id=code_ids,
        pc=np.zeros((n,), np.int32),
        stack=np.zeros((n, stack_cap, u256.LIMBS), np.uint32),
        sp=np.zeros((n,), np.int32),
        mem=np.zeros((n, mem_cap), np.uint8),
        msize_words=np.zeros((n,), np.int32),
        storage_keys=skeys,
        storage_vals=svals,
        storage_cnt=scnt,
        status=np.zeros((n,), np.int32),
        gas_min=np.zeros((n,), np.uint32),
        gas_max=np.zeros((n,), np.uint32),
        gas_budget=np.full((n,), gas_budget, np.uint32),
        ret_offset=np.zeros((n,), np.int32),
        ret_len=np.zeros((n,), np.int32),
        pc_seen=np.zeros((n, PC_BITMAP_WORDS), np.uint32),
        br_pc=np.full((n, BRANCH_CAP), -1, np.int32),
        br_taken=np.zeros((n, BRANCH_CAP), np.uint8),
        br_cnt=np.zeros((n,), np.int32),
        address=_word_rows(n, address),
        caller=_word_rows(n, caller),
        origin=_word_rows(n, caller),
        callvalue=(
            _word_rows(n, callvalue)
            if np.isscalar(callvalue)
            else np.stack([u256.from_int(int(v)) for v in callvalue])
        ),
        balance=(
            _word_rows(n, balance)
            if np.isscalar(balance)
            else np.stack([u256.from_int(int(v)) for v in balance])
        ),
        gasprice=_word_rows(n, gasprice),
        calldata=cd,
        calldatasize=cds,
        timestamp=_word_rows(n, timestamp),
        number=_word_rows(n, number),
        coinbase=_word_rows(n, 0),
        difficulty=_word_rows(n, 0x0BAD),
        gaslimit=_word_rows(n, 8_000_000),
        chainid=_word_rows(n, chainid),
        basefee=_word_rows(n, 7),
        empty_world=(
            np.full((n,), int(bool(empty_world)), np.uint8)
            if np.isscalar(empty_world) or isinstance(empty_world, bool)
            else np.asarray(empty_world, np.uint8)
        ),
    )


def make_batch(n: int, *args, device=None, **kwargs) -> StateBatch:
    """Fresh batch at pc=0 with empty stacks and zeroed memory, on the
    card unless `device` names another.

    Takes the JAX package's `make_batch` arguments (see
    `make_batch_numpy`). Capacities are per-batch: the step reads them
    off the tensor shapes. `storage_seed` pre-loads per-lane storage
    journals, one {slot: value} dict (or None) per lane; `callvalue` and
    `balance` take a scalar or one int per lane."""
    device = resolve_device(device)
    return batch_from_fields(make_batch_numpy(n, *args, **kwargs), device)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def storage_dict_from(tables, lane: int) -> dict:
    """One lane's storage journal (latest write wins) out of a bulk
    (keys, vals, cnt) host read."""
    keys, vals, cnt = (_host(t) for t in tables)
    out = {}
    for i in range(int(cnt[lane])):
        out[u256.to_int(keys[lane, i])] = u256.to_int(vals[lane, i])
    return {k: v for k, v in out.items() if v != 0}


def storage_dict(batch: StateBatch, lane: int) -> dict:
    """Host-side view of one lane's storage journal."""
    tables = (
        _host(batch.storage_keys[lane])[None],
        _host(batch.storage_vals[lane])[None],
        np.asarray([int(batch.storage_cnt[lane])]),
    )
    return storage_dict_from(tables, 0)


def stack_list(batch: StateBatch, lane: int) -> list:
    """Host-side view of one lane's stack (bottom to top)."""
    sp = int(batch.sp[lane])
    rows = _host(batch.stack[lane, :sp])
    return [u256.to_int(rows[i]) for i in range(sp)]


def mem_bytes(batch: StateBatch, lane: int, offset: int, length: int) -> bytes:
    return bytes(_host(batch.mem[lane, offset : offset + length]).tolist())
