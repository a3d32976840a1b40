"""Block-level JIT: advance whole straight-line basic blocks a loop
iteration, in eager PyTorch.

The port of the JAX package's laser/batch/blockjit.py, its decisions
and results reproduced bit for bit:

- **Block summaries** (`summarize_blocks`): per basic block of the
  recovered CFG, the net stack effect, the minimum entry stack, static
  gas bounds, memory/storage/call touches and the lowerability verdict
  with the reason of its first disqualifying instruction. Blocks with
  calls, storage or memory effects, environment reads, unresolved jumps
  or any op outside the lowered set are never lowered: they run on the
  full step, and `block_stats` attributes each one.
- **The block-program table** (`build_block_row`): u8 per pc, 0 = full
  step only, ROW_FUSE = a fusible op outside any lowered block,
  ROW_BODY = inside a lowered block, ROW_HEAD = a lowered block's first
  instruction.
- **The block substeps** (`block_substep`, `sym_block_substep`, the
  plain versions): a micro-step over the lowered set (the fusible ops
  and the ALU family `_ALU_NAMES`, static gas, one result slot). A lane
  whose op would fault simply skips, and the next full step gives the
  generic verdict (a mid-block out-of-gas included). Symbolic lanes
  also skip an ALU op with a tainted operand (the full step appends its
  arena row) and one that wraps by the JAX package's coarse test (the
  full step banks the event). On the card all the substeps of an
  iteration are one launch of `csrc/substep.cu` (specialize.py).

`blockjit_enabled` reads `args.blockjit` (on by default, CLI
--no-blockjit) and the MYTHRIL_NO_BLOCKJIT override.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.state import CodeTable, StateBatch, Status
from mythril_tpu_torch.laser.batch.step import PHASE_OPS, _unhandled
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support.opcodes import OPCODES

log = logging.getLogger(__name__)

#: block substeps per loop iteration
BLOCK_DEPTH = 6

#: profitability floor: the fraction of the instruction stream inside
#: lowerable blocks of >= 2 lowered ops
BLOCK_DENSITY_MIN = 0.25

#: block-program row codes (see the module docstring)
ROW_FUSE = 1
ROW_BODY = 2
ROW_HEAD = 3

#: the ALU family the block substep executes beside the fusible ops
_ALU_NAMES = (
    "ADD", "SUB", "MUL",
    "AND", "OR", "XOR", "NOT",
    "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
    "BYTE", "SHL", "SHR", "SAR", "SIGNEXTEND",
)
LOWERED_NAMES = frozenset(
    [f"PUSH{i}" for i in range(1, 33)]
    + [f"DUP{i}" for i in range(1, 17)]
    + [f"SWAP{i}" for i in range(1, 17)]
    + ["POP", "JUMPDEST"]
    + list(_ALU_NAMES)
)

#: terminators a lowered block may end with (run by the full step)
_OK_TERMINATORS = frozenset(
    ["STOP", "RETURN", "REVERT", "ASSERT_FAIL", "SUICIDE", "JUMP",
     "INVALID", "JUMPI"]
)

#: fallback-reason categories (the first disqualifying instruction's)
_CALL_NAMES = frozenset(
    ["CALL", "CALLCODE", "DELEGATECALL", "STATICCALL", "CREATE", "CREATE2"]
)
_STORAGE_NAMES = frozenset(["SLOAD", "SSTORE"])
_MEM_NAMES = frozenset(
    ["MLOAD", "MSTORE", "MSTORE8", "SHA3", "CALLDATACOPY", "CODECOPY",
     "RETURNDATACOPY", "EXTCODECOPY", "LOG0", "LOG1", "LOG2", "LOG3",
     "LOG4"]
)
_ENV_NAMES = frozenset(
    PHASE_OPS["env_block"] + PHASE_OPS["env_tx"] + PHASE_OPS["env_info"]
    + ["CALLDATALOAD"]
)

_B = {name: entry[0] for name, entry in OPCODES.items()}


def blockjit_enabled() -> bool:
    """`args.blockjit` (CLI --no-blockjit) unless MYTHRIL_NO_BLOCKJIT
    is set."""
    if os.environ.get("MYTHRIL_NO_BLOCKJIT"):
        return False
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "blockjit", True))


# ---------------------------------------------------------------------------
# block summaries + lowerability
# ---------------------------------------------------------------------------
class BlockSummary(NamedTuple):
    """One basic block's static summary."""

    start: int
    end: int
    #: total instructions, the terminator included
    n_ops: int
    #: instructions the substeps may advance (terminator excluded)
    n_lowered: int
    #: net stack-pointer delta over the block
    net_sp: int
    #: minimum entry stack depth for no instruction to underflow
    min_sp: int
    #: static gas bounds summed over the block
    gas_min: int
    gas_max: int
    touches_mem: bool
    touches_storage: bool
    has_call: bool
    terminator: str
    lowerable: bool
    #: 'ok' | 'call' | 'storage' | 'memory' | 'env' | 'opcode'
    #: | 'unresolved-jump' | 'tiny'
    reason: str


def _cfg_for(code: bytes, summary=None):
    """The static summary's CFG when one is attached, a fresh recovery
    otherwise; None when recovery fails (nothing lowerable)."""
    cfg = getattr(summary, "cfg", None) if summary is not None else None
    if cfg is not None:
        return cfg
    try:
        from mythril_tpu_torch.analysis.static.cfg import recover_cfg

        return recover_cfg(code)
    except Exception:
        log.debug("CFG recovery failed; no blocks lowered", exc_info=True)
        return None


def _classify(instructions) -> str:
    """The lowerability verdict for one block's instruction list."""
    last = len(instructions) - 1
    for i, ins in enumerate(instructions):
        name = ins.opcode
        if name in LOWERED_NAMES:
            continue
        if i == last and name in _OK_TERMINATORS:
            continue
        if name in _CALL_NAMES:
            return "call"
        if name in _STORAGE_NAMES:
            return "storage"
        if name in _MEM_NAMES:
            return "memory"
        if name in _ENV_NAMES:
            return "env"
        return "opcode"
    return "ok"


def summarize_blocks(code: bytes, summary=None) -> Dict[int, BlockSummary]:
    """Per-basic-block summaries keyed by start pc."""
    cfg = _cfg_for(code, summary)
    if cfg is None:
        return {}
    flow = getattr(summary, "flow", None) if summary is not None else None
    out: Dict[int, BlockSummary] = {}
    for start, block in cfg.blocks.items():
        rel = 0
        min_sp = 0
        gas_min = gas_max = 0
        touches_mem = touches_storage = has_call = False
        for ins in block.instructions:
            row = OPCODES.get(ins.opcode)
            if row is not None:
                _byte, pops, pushes, gmin, gmax = row
                min_sp = max(min_sp, pops - rel)
                rel += pushes - pops
                gas_min += gmin
                gas_max += gmax
            touches_mem = touches_mem or ins.opcode in _MEM_NAMES
            touches_storage = touches_storage or ins.opcode in _STORAGE_NAMES
            has_call = has_call or ins.opcode in _CALL_NAMES
        reason = _classify(block.instructions)
        terminator = block.terminator
        if reason == "ok" and terminator in ("JUMP", "JUMPI"):
            # a computed jump neither the peephole nor the dataflow pass
            # resolved falls back
            pc = block.end
            resolved = pc in cfg.peephole_targets or (
                flow is not None and pc in flow.resolved_jumps
            )
            if not resolved:
                reason = "unresolved-jump"
        n_lowered = sum(
            1 for ins in block.instructions if ins.opcode in LOWERED_NAMES
        )
        if reason == "ok" and n_lowered < 2:
            # one lowerable instruction gains nothing over a full step
            reason = "tiny"
        out[start] = BlockSummary(
            start=start,
            end=block.end,
            n_ops=len(block.instructions),
            n_lowered=n_lowered,
            net_sp=rel,
            min_sp=min_sp,
            gas_min=gas_min,
            gas_max=gas_max,
            touches_mem=touches_mem,
            touches_storage=touches_storage,
            has_call=has_call,
            terminator=terminator,
            lowerable=reason == "ok",
            reason=reason,
        )
    return out


def block_stats(code: bytes, summary=None) -> Dict:
    """One contract's lowering scorecard: block counts, lowered density
    and the fallbacks by reason."""
    blocks = summarize_blocks(code, summary)
    total_ops = sum(b.n_ops for b in blocks.values())
    lowered_ops = sum(b.n_lowered for b in blocks.values() if b.lowerable)
    reasons: Dict[str, int] = {}
    for b in blocks.values():
        if not b.lowerable:
            reasons[b.reason] = reasons.get(b.reason, 0) + 1
    return {
        "blocks_total": len(blocks),
        "blocks_lowered": sum(1 for b in blocks.values() if b.lowerable),
        "blocks_unlowered": sum(1 for b in blocks.values() if not b.lowerable),
        "instructions": total_ops,
        "lowered_instructions": lowered_ops,
        "lowered_density": (
            round(lowered_ops / total_ops, 4) if total_ops else 0.0
        ),
        "fallback_reasons": reasons,
    }


def block_depth_for(code: bytes, summary=None) -> int:
    """BLOCK_DEPTH when enough of the instruction stream sits in
    lowerable blocks, 0 otherwise."""
    stats = block_stats(code, summary)
    if not stats["blocks_lowered"]:
        return 0
    if stats["lowered_density"] < BLOCK_DENSITY_MIN:
        return 0
    return BLOCK_DEPTH


# ---------------------------------------------------------------------------
# the per-pc block-program table
# ---------------------------------------------------------------------------
def build_block_row(code: bytes, code_cap: int, summary=None) -> np.ndarray:
    """u8[code_cap]: the fuse marks at ROW_FUSE, with every lowered
    block's member pcs overwritten by ROW_BODY/ROW_HEAD."""
    from mythril_tpu_torch.laser.batch.specialize import build_fuse_row

    row = build_fuse_row(code, code_cap, summary)
    cfg = _cfg_for(code, summary)
    if cfg is None:
        return row
    for blk_start, blk in summarize_blocks(code, summary).items():
        if not blk.lowerable:
            continue
        block = cfg.blocks[blk_start]
        first = True
        for ins in block.instructions:
            if ins.opcode not in LOWERED_NAMES:
                continue
            if ins.address < code_cap:
                row[ins.address] = ROW_HEAD if first else ROW_BODY
            first = False
    return row


def build_block_table(
    codes: List[bytes], code_cap: int, summaries: Optional[List] = None
) -> np.ndarray:
    """One block-program row per CodeTable row, same row order."""
    if summaries is None:
        summaries = [None] * len(codes)
    return np.stack(
        [
            build_block_row(code, code_cap, summary)
            for code, summary in zip(codes, summaries)
        ]
    )


# ---------------------------------------------------------------------------
# the block substeps' plain versions
# ---------------------------------------------------------------------------
def _alu(op, a, b):
    """(value, mask): the ALU family's result where `op` is one of it
    (the full step's expressions, step.py `cheap`)."""
    vals = {
        _B["ADD"]: lambda: u256.add(a, b),
        _B["SUB"]: lambda: u256.sub(a, b),
        _B["MUL"]: lambda: u256.mul(a, b),
        _B["AND"]: lambda: a & b,
        _B["OR"]: lambda: a | b,
        _B["XOR"]: lambda: a ^ b,
        _B["LT"]: lambda: u256.bool_to_word(u256.ult(a, b)),
        _B["GT"]: lambda: u256.bool_to_word(u256.ult(b, a)),
        _B["SLT"]: lambda: u256.bool_to_word(u256.slt(a, b)),
        _B["SGT"]: lambda: u256.bool_to_word(u256.slt(b, a)),
        _B["EQ"]: lambda: u256.bool_to_word(u256.eq(a, b)),
        _B["ISZERO"]: lambda: u256.bool_to_word(u256.is_zero(a)),
        _B["NOT"]: lambda: u256.bit_not(a),
        _B["BYTE"]: lambda: u256.byte_op(a, b),
        _B["SHL"]: lambda: u256.shl(b, u256.shift_amount(a)),
        _B["SHR"]: lambda: u256.lshr(b, u256.shift_amount(a)),
        _B["SAR"]: lambda: u256.ashr(b, u256.shift_amount(a)),
        _B["SIGNEXTEND"]: lambda: u256.signextend(a, b),
    }
    val = torch.zeros_like(a)
    mask = torch.zeros_like(op, dtype=torch.bool)
    for byte_, fn in vals.items():
        hit = op == byte_
        val = torch.where(hit[:, None], fn(), val)
        mask = mask | hit
    return val, mask


def _wraps(op, a, b):
    """The JAX package's wrap test: exact for ADD and SUB, and its
    coarse over-approximation for MUL (an operand above 128 bits and
    both nonzero)."""
    half = u256.LIMBS // 2
    hi_a = torch.any(a[:, half:] != 0, dim=-1)
    hi_b = torch.any(b[:, half:] != 0, dim=-1)
    nz_a = torch.any(a != 0, dim=-1)
    nz_b = torch.any(b != 0, dim=-1)
    return (((op == _B["ADD"]) & u256.ult(u256.bit_not(a), b))
            | ((op == _B["SUB"]) & u256.ult(a, b))
            | ((op == _B["MUL"]) & (hi_a | hi_b) & nz_a & nz_b))


def block_substep(batch: StateBatch, code: CodeTable, blk_tbl,
                  track_coverage: bool = True, stack_tid=None, phases=None):
    """One micro-step over the lowered op set, in place: every RUNNING
    lane whose pc the block table marks and whose stack and gas cannot
    fault on the op (and, with `phases` pruning, whose op is handled).
    With `stack_tid` (the symbolic shadow) ALU ops also need concrete
    operands and no wrap. Returns (batch', lanes_executed,
    blocks_entered)."""
    from mythril_tpu_torch.laser.batch.specialize import (
        _apply_substep,
        _ok_predicate,
        _peek,
        _push_word,
        _substep_prelude,
    )

    stack_cap = batch.stack.shape[1]
    code_len, code_win, op, row, meta = _substep_prelude(batch, code, blk_tbl)
    live = (batch.status == Status.RUNNING) & (batch.pc < code_len) & (row != 0)
    ok = _ok_predicate(batch, live, meta)
    if phases is not None and phases.pruned:
        # the safety net holds through substeps: a pruned op waits for
        # the full step, which parks the lane UNSUPPORTED
        ok = ok & ~_unhandled(phases, op.device)[op.long()]
    is_push = (op >= 0x60) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    dup_n, swap_n = op - 0x80, op - 0x8F
    peek_idx, peeked = _peek(batch, torch.stack(
        [torch.zeros_like(op), torch.ones_like(op), dup_n, swap_n], 1))
    a, b = peeked[:, 0], peeked[:, 1]
    dup_val, swap_deep = peeked[:, 2], peeked[:, 3]
    alu_val, alu_mask = _alu(op, a, b)
    lanes = torch.arange(op.shape[0], device=op.device)
    if stack_tid is not None:
        tids = stack_tid[lanes[:, None], peek_idx]
        a_tid, b_tid = tids[:, 0], tids[:, 1]
        is_unary = (op == _B["ISZERO"]) | (op == _B["NOT"])
        concrete = torch.where(is_unary, a_tid == 0, (a_tid == 0) & (b_tid == 0))
        ok = ok & (~alu_mask | (concrete & ~_wraps(op, a, b)))
    pops = meta[:, 2]
    res_val = torch.where(is_push[:, None], _push_word(code_win, op),
                          torch.where(is_dup[:, None], dup_val,
                                      torch.where(is_swap[:, None], swap_deep, alu_val)))
    # DUP writes the new top (sp), SWAP sp - 1, PUSH and the ALU ops
    # sp - pops: the full step's rule
    res_idx = torch.where(is_dup, batch.sp, torch.where(is_swap, batch.sp - 1,
                                                        batch.sp - pops))
    res_idx = res_idx.clamp(0, stack_cap - 1).long()
    writes = ok & (is_push | is_dup | is_swap | alu_mask)
    swap_idx = (batch.sp - 1 - swap_n).clamp(0, stack_cap - 1).long()
    if stack_tid is not None:
        # PUSH and concrete ALU results are concrete; DUP and SWAP move
        # tids as they move values (the result slot first, as in JAX)
        res_tid = torch.where(is_dup, tids[:, 2], torch.where(is_swap, tids[:, 3], 0))
        stack_tid[lanes, res_idx] = torch.where(writes, res_tid, stack_tid[lanes, res_idx])
        stack_tid[lanes, swap_idx] = torch.where(ok & is_swap, a_tid,
                                                 stack_tid[lanes, swap_idx])
    n_blocks = (ok & (row == ROW_HEAD)).to(torch.int64).sum()
    out = _apply_substep(batch, ok, op, meta, res_val, res_idx, writes, swap_idx, a,
                         track_coverage)
    return out, ok.to(torch.int64).sum(), n_blocks


def sym_block_substep(symb, code: CodeTable, blk_tbl, track_coverage: bool = True,
                      phases=None):
    """The block substep with the symbolic-shadow mirror, in place.
    Returns (symb', lanes_executed, blocks_entered)."""
    base, n_exec, n_blocks = block_substep(
        symb.base, code, blk_tbl, track_coverage=track_coverage,
        stack_tid=symb.stack_tid, phases=phases)
    return symb._replace(base=base), n_exec, n_blocks
