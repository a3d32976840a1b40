"""Abstract stack-height + constant-lattice dataflow over the CFG.

The port's copy of the JAX package's analysis/static/dataflow.py, with the
package renamed.

A worklist fixpoint over basic blocks. The abstract state per block
entry is (stack-height interval, top-window of abstract values); the
value lattice is {constant int} < TOP (None). The pass:

- resolves computed jumps whose target is a stack constant at the
  JUMP (the peephole in cfg.py only sees `PUSH t; JUMP`; this one
  sees the target through DUP/SWAP/POP shuffles and arithmetic on
  constants — the superoptimizer-style constant propagation of arxiv
  2005.05912, §3, restricted to what seeding needs);
- constant-folds JUMPI conditions: a condition that is the same
  constant on EVERY path into the branch makes the contradicted
  direction statically dead;
- flags blocks that DEFINITELY underflow the stack (reverting on all
  paths) and const jumps to invalid destinations;
- computes the reachable block set conservatively: an unresolved
  (still-TOP) jump target is treated as "any JUMPDEST", so
  reachability over-approximates and everything derived from it
  (detector screen, dead-code accounting) stays sound.

Termination: the value lattice is finite per slot, window length only
shrinks, and height intervals only widen within [0, 1024]; a visit
cap backstops pathological graphs — hitting it marks the result
`incomplete` and every consumer falls back to the conservative
whole-stream view.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static.cfg import CFG, BasicBlock, stack_effect

log = logging.getLogger(__name__)

TOP = None
WORD = 2**256
MASK = WORD - 1
#: EVM stack limit — the height interval's natural ceiling
STACK_LIMIT = 1024
#: modeled stack window (top slots); values below are TOP
DEPTH_CAP = 32
#: worklist visit backstop
VISIT_CAP = 60_000


class AbsState:
    """Abstract machine state at a block boundary."""

    __slots__ = ("lo", "hi", "stack")

    def __init__(self, lo: int, hi: int, stack: Tuple) -> None:
        self.lo = lo
        self.hi = hi
        self.stack = stack  # top at index -1; len <= DEPTH_CAP

    def key(self) -> Tuple:
        return (self.lo, self.hi, self.stack)

    @staticmethod
    def unknown() -> "AbsState":
        return AbsState(0, STACK_LIMIT, ())


def join(a: Optional[AbsState], b: AbsState) -> AbsState:
    if a is None:
        return b
    n = min(len(a.stack), len(b.stack))
    if n:
        merged = tuple(
            x if x == y else TOP
            for x, y in zip(a.stack[-n:], b.stack[-n:])
        )
    else:
        merged = ()
    return AbsState(min(a.lo, b.lo), max(a.hi, b.hi), merged)


def _fold(op: str, a, b):
    """Constant fold a binary op; operand `a` is the stack top."""
    if a is TOP or b is TOP:
        return TOP
    try:
        if op == "ADD":
            return (a + b) & MASK
        if op == "SUB":
            return (a - b) & MASK
        if op == "MUL":
            return (a * b) & MASK
        if op == "DIV":
            return (a // b) & MASK if b else 0
        if op == "MOD":
            return (a % b) & MASK if b else 0
        if op == "EXP":
            return pow(a, b, WORD)
        if op == "AND":
            return a & b
        if op == "OR":
            return a | b
        if op == "XOR":
            return a ^ b
        if op == "EQ":
            return int(a == b)
        if op == "LT":
            return int(a < b)
        if op == "GT":
            return int(a > b)
        if op == "SHL":
            return (b << a) & MASK if a < 256 else 0
        if op == "SHR":
            return (b >> a) if a < 256 else 0
        if op == "BYTE":
            return (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0
    except (OverflowError, ValueError):  # pragma: no cover
        return TOP
    return TOP


_BINARY = frozenset(
    [
        "ADD", "SUB", "MUL", "DIV", "MOD", "EXP", "AND", "OR", "XOR",
        "EQ", "LT", "GT", "SHL", "SHR", "BYTE",
    ]
)


class BlockFacts:
    """What one transfer of a block established (final pass only)."""

    __slots__ = (
        "jump_target",
        "jump_unresolved",
        "invalid_jump",
        "dead_direction",
        "definite_underflow",
        "possible_underflow",
    )

    def __init__(self) -> None:
        self.jump_target: Optional[int] = None
        self.jump_unresolved = False
        self.invalid_jump = False
        #: True/False = the JUMPI direction proven infeasible here
        self.dead_direction: Optional[bool] = None
        self.definite_underflow = False
        self.possible_underflow = False


def transfer(
    block: BasicBlock, state: AbsState
) -> Tuple[AbsState, BlockFacts]:
    """Run the abstract interpreter over one block from `state`."""
    lo, hi = state.lo, state.hi
    stack: List = list(state.stack)
    facts = BlockFacts()

    def pop():
        nonlocal lo, hi
        value = stack.pop() if stack else TOP
        lo, hi = max(0, lo - 1), max(0, hi - 1)
        return value

    def push(value) -> None:
        nonlocal lo, hi
        stack.append(value)
        lo, hi = min(STACK_LIMIT, lo + 1), min(STACK_LIMIT, hi + 1)
        if len(stack) > DEPTH_CAP:
            del stack[0]

    for ins in block.instructions:
        op = ins.opcode
        pops, pushes = stack_effect(op)
        if pops:
            if hi < pops:
                # every path into this instruction underflows: the
                # block reverts before doing anything further
                facts.definite_underflow = True
                break
            if lo < pops:
                facts.possible_underflow = True
        if op.startswith("PUSH"):
            push(int(ins.argument, 16) if ins.argument else 0)
        elif op.startswith("DUP"):
            n = int(op[3:])
            value = stack[-n] if len(stack) >= n else TOP
            push(value)
        elif op.startswith("SWAP"):
            n = int(op[4:])
            if len(stack) >= n + 1:
                stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
            else:
                # the swapped-with slot is below the window: the top
                # becomes unknown, the deep slot is already TOP
                if stack:
                    stack[-1] = TOP
        elif op == "POP":
            pop()
        elif op in _BINARY:
            a, b = pop(), pop()
            push(_fold(op, a, b))
        elif op == "ISZERO":
            a = pop()
            push(TOP if a is TOP else int(a == 0))
        elif op == "NOT":
            a = pop()
            push(TOP if a is TOP else (~a) & MASK)
        elif op == "JUMP":
            target = pop()
            if target is TOP:
                facts.jump_unresolved = True
            else:
                facts.jump_target = int(target)
        elif op == "JUMPI":
            target = pop()
            cond = pop()
            if target is TOP:
                facts.jump_unresolved = True
            else:
                facts.jump_target = int(target)
            if cond is not TOP:
                # the contradicted direction can never execute;
                # True means "the taken direction is dead" (cond == 0)
                facts.dead_direction = not bool(cond)
        else:
            for _ in range(pops):
                pop()
            for _ in range(pushes):
                push(TOP)
    return AbsState(lo, hi, tuple(stack)), facts


class DataflowResult:
    """Fixpoint output consumed by summary.py."""

    def __init__(self) -> None:
        self.entry_states: Dict[int, AbsState] = {}
        self.reachable: Set[int] = set()
        self.resolved_jumps: Dict[int, int] = {}  # jump pc -> target pc
        self.unresolved_jumps: Set[int] = set()  # jump pc
        self.invalid_jumps: Dict[int, int] = {}  # jump pc -> bad target
        self.dead_directions: Set[Tuple[int, bool]] = set()
        self.underflow_blocks: Set[int] = set()
        self.possible_underflow_blocks: Set[int] = set()
        self.incomplete = False


def _successors(
    cfg: CFG, block: BasicBlock, facts: BlockFacts
) -> Tuple[List[int], bool]:
    """(successor block starts, broadcast-to-all-jumpdests?)."""
    out: List[int] = []
    terminator = block.terminator
    if facts.definite_underflow:
        return out, False
    if terminator == "JUMP":
        if facts.jump_unresolved:
            return out, True
        if facts.jump_target in cfg.jumpdests:
            out.append(facts.jump_target)
        return out, False
    if terminator == "JUMPI":
        broadcast = False
        if facts.dead_direction is not True:  # taken side feasible
            if facts.jump_unresolved:
                broadcast = True
            elif facts.jump_target in cfg.jumpdests:
                out.append(facts.jump_target)
        if facts.dead_direction is not False:  # fall side feasible
            nxt = cfg.block_after(block.start)
            if nxt is not None:
                out.append(nxt.start)
        return out, broadcast
    if terminator == "FALL":
        nxt = cfg.block_after(block.start)
        if nxt is not None:
            out.append(nxt.start)
    return out, False


def run_dataflow(cfg: CFG) -> DataflowResult:
    """Worklist fixpoint + a recording pass over the final states."""
    result = DataflowResult()
    if not cfg.blocks:
        return result

    entry = cfg.starts[0]
    in_states: Dict[int, AbsState] = {entry: AbsState(0, 0, ())}
    work: List[int] = [entry]
    jumpdest_starts = [s for s in cfg.starts if cfg.blocks[s].is_jumpdest]
    broadcast_done = False
    visits = 0
    while work:
        visits += 1
        if visits > VISIT_CAP:
            result.incomplete = True
            log.debug(
                "static dataflow visit cap hit (%d blocks); conservative "
                "fallback",
                len(cfg.blocks),
            )
            break
        start = work.pop()
        state = in_states[start]
        out_state, facts = transfer(cfg.blocks[start], state)
        successors, broadcast = _successors(cfg, cfg.blocks[start], facts)
        targets = list(successors)
        if broadcast and not broadcast_done:
            # one unresolved jump makes every JUMPDEST conservatively
            # reachable with an unknown state; doing this once is
            # enough — the unknown state joins everything to itself
            broadcast_done = True
            unknown = AbsState.unknown()
            for s in jumpdest_starts:
                merged = join(in_states.get(s), unknown)
                if s not in in_states or merged.key() != in_states[s].key():
                    in_states[s] = merged
                    work.append(s)
        for s in targets:
            if s not in cfg.blocks:
                continue
            merged = join(in_states.get(s), out_state)
            if s not in in_states or merged.key() != in_states[s].key():
                in_states[s] = merged
                work.append(s)

    result.entry_states = in_states
    result.reachable = set(in_states)
    if result.incomplete:
        # conservative: everything is reachable, nothing is dead
        result.reachable = set(cfg.blocks)
        return result

    # recording pass: facts are only trusted at the FIXPOINT states —
    # a dead direction observed mid-iteration could be an artifact of
    # a not-yet-joined path
    for start, state in in_states.items():
        block = cfg.blocks[start]
        _, facts = transfer(block, state)
        if facts.definite_underflow:
            result.underflow_blocks.add(start)
        if facts.possible_underflow:
            result.possible_underflow_blocks.add(start)
        if block.terminator in ("JUMP", "JUMPI"):
            pc = block.end
            if facts.jump_unresolved:
                result.unresolved_jumps.add(pc)
            elif facts.jump_target is not None:
                if facts.jump_target in cfg.jumpdests:
                    result.resolved_jumps[pc] = facts.jump_target
                else:
                    result.invalid_jumps[pc] = facts.jump_target
            if block.terminator == "JUMPI" and facts.dead_direction is not None:
                result.dead_directions.add((pc, facts.dead_direction))
    return result
