"""Attacker-taint dataflow over the recovered CFG.

The port's copy of the JAX package's analysis/static/taint.py, with the
package renamed.

A worklist fixpoint (same shape as `dataflow.py`, which must have run
first — jump resolution and dead directions are reused, not
recomputed) propagating an attacker-influence lattice per abstract
stack slot. The abstract value is ``(const, taint)``:

- ``const`` is the constant-lattice half ({int} < TOP=None), folded
  with the same `_fold` the dataflow pass uses;
- ``taint`` is a provenance bitmask: ATTACKER (CALLDATALOAD/COPY,
  CALLER, CALLVALUE, returndata), ORIGIN and CALLER provenance bits
  (kept separately so "tx.origin guards a branch" is a distinct
  fact), and UNKNOWN (storage/balance/env/memory — symbolic in
  execution, but not attacker-steered).

Indirect flows join conservatively:

- **memory** is one accumulated taint mask (`mem_taint`): any tainted
  MSTORE/CALLDATACOPY/call-return-write taints every later MLOAD/SHA3
  — the "MLOAD after tainted MSTORE" join;
- **storage** keeps a per-constant-slot written-taint map plus an
  any-slot mask for writes at unknown slots; SLOAD joins the slot's
  written taint with UNKNOWN (initial storage is symbolic);
- values that leave the modeled stack window (depth cap, join
  truncation, under-window SWAP) fold their taint into a sticky
  per-state *spill* mask that every under-window pop returns with —
  provenance is never silently dropped.

The recording pass (final states only, like dataflow's) lands one
fact per **sink** instruction: JUMP/JUMPI target and condition,
CALL-family target/value/gas, SSTORE slot+value, SLOAD slot,
SELFDESTRUCT beneficiary, LOG1 topic, ORIGIN/CALLER reaching a
comparison or branch guard, and ADD/SUB/MUL/EXP sites whose operands
are not provably constant (or whose constants wrap). `screen.py`
layers the per-module sink predicates on these facts; `summary.py`
turns the ATTACKER-bit sinks into `lint` findings.

Soundness direction: every approximation here makes values LESS
constant and MORE tainted, so a sink the result calls clean is clean
on every real execution — the invariant the semantic detector screen
and the static-answer triage tier stand on. Any bail (visit cap,
upstream dataflow incompleteness, an exception) sets `incomplete` and
every consumer falls back to the opcode screen.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static.cfg import CFG, BasicBlock, stack_effect
from mythril_tpu_torch.analysis.static.dataflow import (
    _BINARY,
    _fold,
    DataflowResult,
    DEPTH_CAP,
    MASK,
    WORD,
)

log = logging.getLogger(__name__)

# -- the provenance lattice --------------------------------------------------
TAINT_ATTACKER = 1  #: calldata / caller / callvalue / returndata
TAINT_ORIGIN = 2  #: derived from ORIGIN
TAINT_CALLER = 4  #: derived from CALLER (auth-check evidence)
TAINT_UNKNOWN = 8  #: symbolic but not attacker-steered (storage, env)
#: a value whose provenance was lost could be anything
TAINT_ANY = TAINT_ATTACKER | TAINT_ORIGIN | TAINT_CALLER | TAINT_UNKNOWN

#: abstract value: (constant int | None, taint mask)
AbsVal = Tuple[Optional[int], int]

CLEAN_UNKNOWN: AbsVal = (None, TAINT_UNKNOWN)

#: taint worklist backstop (the pass reruns the fixpoint while the
#: memory/storage accumulators grow, so the cap is total visits)
TAINT_VISIT_CAP = 120_000
#: outer accumulator rounds (masks are monotone 4-bit; this never
#: triggers on sane code — pure paranoia against a dict-growth loop)
ACCUM_ROUNDS_CAP = 8

_COMPARISONS = frozenset(["EQ", "LT", "GT", "SLT", "SGT"])
_ARITH_SINKS = frozenset(["ADD", "SUB", "MUL", "EXP"])
#: writes into memory whose payload the attacker steers
_MEM_ATTACKER_WRITES = frozenset(["CALLDATACOPY", "RETURNDATACOPY"])
_CALL_ARITY = {"CALL": 7, "CALLCODE": 7, "DELEGATECALL": 6, "STATICCALL": 6}
#: CALL/CALLCODE carry a value operand; DELEGATECALL/STATICCALL do not
_CALL_HAS_VALUE = ("CALL", "CALLCODE")

_SOURCE_PUSH = {
    # opcode -> taint of the pushed value (all 0-pop pushes)
    "CALLDATASIZE": TAINT_ATTACKER,
    "CALLVALUE": TAINT_ATTACKER,
    "RETURNDATASIZE": TAINT_ATTACKER,
    "CALLER": TAINT_ATTACKER | TAINT_CALLER,
    "ORIGIN": TAINT_ATTACKER | TAINT_ORIGIN,
    "TIMESTAMP": TAINT_UNKNOWN,
    "NUMBER": TAINT_UNKNOWN,
    "COINBASE": TAINT_UNKNOWN,
    "DIFFICULTY": TAINT_UNKNOWN,
    "PREVRANDAO": TAINT_UNKNOWN,
    "GASLIMIT": TAINT_UNKNOWN,
    "GASPRICE": TAINT_UNKNOWN,
    "CHAINID": TAINT_UNKNOWN,
    "BASEFEE": TAINT_UNKNOWN,
    "SELFBALANCE": TAINT_UNKNOWN,
    "GAS": TAINT_UNKNOWN,
    "MSIZE": TAINT_UNKNOWN,
    "ADDRESS": TAINT_UNKNOWN,
    "CODESIZE": TAINT_UNKNOWN,
}


class TaintState:
    """Abstract state at a block boundary: the top-window of abstract
    values plus the spill mask for everything below the window."""

    __slots__ = ("stack", "spill")

    def __init__(self, stack: Tuple[AbsVal, ...], spill: int) -> None:
        self.stack = stack
        self.spill = spill

    def key(self) -> Tuple:
        return (self.stack, self.spill)

    @staticmethod
    def empty() -> "TaintState":
        return TaintState((), 0)

    @staticmethod
    def unknown() -> "TaintState":
        # broadcast entry: nothing on the model stack, everything
        # below it could be anything
        return TaintState((), TAINT_ANY)


def join(a: Optional[TaintState], b: TaintState) -> TaintState:
    if a is None:
        return b
    n = min(len(a.stack), len(b.stack))
    spill = a.spill | b.spill
    # entries a join truncates fold their taint into the spill mask
    for dropped in a.stack[: len(a.stack) - n]:
        spill |= dropped[1]
    for dropped in b.stack[: len(b.stack) - n]:
        spill |= dropped[1]
    if n:
        merged = tuple(
            (x[0] if x[0] == y[0] else None, x[1] | y[1])
            for x, y in zip(a.stack[-n:], b.stack[-n:])
        )
    else:
        merged = ()
    return TaintState(merged, spill)


class TaintResult:
    """Per-sink facts at the fixpoint (consumed by screen/summary)."""

    def __init__(self) -> None:
        self.incomplete = False
        self.reachable: Set[int] = set()
        #: sink operands, keyed by instruction address
        self.jump_targets: Dict[int, AbsVal] = {}
        self.jumpi_conditions: Dict[int, AbsVal] = {}
        self.sstore_slots: Dict[int, AbsVal] = {}
        self.sstore_values: Dict[int, AbsVal] = {}
        self.sload_slots: Dict[int, AbsVal] = {}
        #: pc -> {"kind", "target", "value" (CALL/CALLCODE), "gas"}
        self.call_sites: Dict[int, Dict] = {}
        self.selfdestruct_sites: Dict[int, AbsVal] = {}
        self.log1_topics: Dict[int, AbsVal] = {}
        #: JUMPI guards carrying ORIGIN / CALLER provenance
        self.origin_condition_pcs: List[int] = []
        self.caller_condition_pcs: List[int] = []
        #: EQ/LT/GT/SLT/SGT with an ORIGIN-derived operand
        self.origin_compare_pcs: List[int] = []
        #: ADD/SUB/MUL/EXP whose operands are not provably constant,
        #: or whose constant fold wraps — the sites symbolic execution
        #: could annotate as overflowing
        self.arith_unsafe_pcs: Set[int] = set()
        self.mem_taint = 0
        self.storage_written: Dict[int, int] = {}
        self.storage_any_taint = 0
        self.wall_ms = 0.0

    # -- derived views ---------------------------------------------------
    def sink_counts(self) -> Dict[str, int]:
        """Per-sink-kind totals (routing features / stats)."""
        return {
            "jump_target": len(self.jump_targets),
            "jumpi_condition": len(self.jumpi_conditions),
            "sstore_slot": len(self.sstore_slots),
            "call_target": len(self.call_sites),
            "selfdestruct": len(self.selfdestruct_sites),
            "log1_topic": len(self.log1_topics),
            "origin_condition": len(self.origin_condition_pcs),
            "arith_unsafe": len(self.arith_unsafe_pcs),
        }

    def tainted_sink_counts(self) -> Dict[str, int]:
        """Per-sink-kind counts carrying the ATTACKER bit."""

        def _n(table: Dict[int, AbsVal]) -> int:
            return sum(
                1 for v in table.values() if v[1] & TAINT_ATTACKER
            )

        return {
            "jump_target": _n(self.jump_targets),
            "jumpi_condition": _n(self.jumpi_conditions),
            "sstore_slot": _n(self.sstore_slots),
            "call_target": sum(
                1
                for site in self.call_sites.values()
                if site["target"][1] & TAINT_ATTACKER
            ),
            "selfdestruct": _n(self.selfdestruct_sites),
            "log1_topic": _n(self.log1_topics),
        }

    @property
    def taint_density(self) -> float:
        """Tainted sinks / total sinks — the routing-feature scalar."""
        total = sum(self.sink_counts().values())
        tainted = sum(self.tainted_sink_counts().values()) + len(
            self.origin_condition_pcs
        ) + len(self.arith_unsafe_pcs)
        return round(min(1.0, tainted / total), 4) if total else 0.0

    def tainted_call_sites(self, kind: Optional[str] = None) -> List[int]:
        """pcs of CALL-family sites whose target carries ATTACKER."""
        return sorted(
            pc
            for pc, site in self.call_sites.items()
            if (kind is None or site["kind"] == kind)
            and site["target"][1] & TAINT_ATTACKER
        )

    def tainted_jump_pcs(self) -> List[int]:
        return sorted(
            pc
            for pc, v in self.jump_targets.items()
            if v[1] & TAINT_ATTACKER
        )


class _Accumulators:
    """The flow-insensitive joins (memory / storage): monotone masks
    shared by every path, re-fixpointed until they stop growing."""

    __slots__ = ("mem", "storage", "storage_any", "dirty")

    def __init__(self) -> None:
        self.mem = 0
        self.storage: Dict[int, int] = {}
        self.storage_any = 0
        self.dirty = False

    def write_mem(self, taint: int) -> None:
        if taint & ~self.mem:
            self.mem |= taint
            self.dirty = True

    def write_storage(self, slot: Optional[int], taint: int) -> None:
        if slot is None:
            if taint & ~self.storage_any:
                self.storage_any |= taint
                self.dirty = True
            return
        have = self.storage.get(slot, 0)
        if taint & ~have:
            self.storage[slot] = have | taint
            self.dirty = True

    def read_storage(self, slot: Optional[int]) -> int:
        base = self.storage_any | TAINT_UNKNOWN
        if slot is None:
            out = base
            for taint in self.storage.values():
                out |= taint
            return out
        return base | self.storage.get(slot, 0)


def _wraps(op: str, a: int, b: int) -> bool:
    """Does the CONSTANT operation wrap mod 2**256? (a is stack top.)"""
    if op == "ADD":
        return a + b >= WORD
    if op == "SUB":
        return a - b < 0
    if op == "MUL":
        return a * b >= WORD
    if op == "EXP":
        try:
            return b > 1 and b ** a >= WORD
        except OverflowError:  # astronomically large exponent
            return True
    return False


def transfer(
    block: BasicBlock,
    state: TaintState,
    acc: _Accumulators,
    result: Optional[TaintResult] = None,
) -> TaintState:
    """One abstract pass over `block` from `state`. With `result`
    (the recording pass, fixpoint states only) sink facts land."""
    stack: List[AbsVal] = list(state.stack)
    spill = state.spill

    def pop() -> AbsVal:
        nonlocal spill
        if stack:
            return stack.pop()
        # below the modeled window: the value is whatever was spilled
        return (None, spill)

    def push(value: AbsVal) -> None:
        nonlocal spill
        stack.append(value)
        if len(stack) > DEPTH_CAP:
            spill |= stack[0][1]
            del stack[0]

    for ins in block.instructions:
        op = ins.opcode
        pc = ins.address
        if op.startswith("PUSH"):
            push((int(ins.argument, 16) if ins.argument else 0, 0))
        elif op.startswith("DUP"):
            n = int(op[3:])
            push(stack[-n] if len(stack) >= n else (None, spill))
        elif op.startswith("SWAP"):
            n = int(op[4:])
            if len(stack) >= n + 1:
                stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
            elif stack:
                # the partner slot is below the window: the top sinks
                # into the spill, an unknown spilled value surfaces
                spill |= stack[-1][1]
                stack[-1] = (None, spill)
        elif op == "POP":
            pop()
        elif op in _BINARY:
            a, b = pop(), pop()
            const = _fold(op, a[0], b[0])
            taint = a[1] | b[1]
            if result is not None:
                if op in _ARITH_SINKS and (
                    a[0] is None
                    or b[0] is None
                    or _wraps(op, a[0], b[0])
                ):
                    result.arith_unsafe_pcs.add(pc)
                if op in _COMPARISONS and (
                    (a[1] | b[1]) & TAINT_ORIGIN
                ):
                    result.origin_compare_pcs.append(pc)
            push((const, taint))
        elif op == "ISZERO":
            a = pop()
            push((None if a[0] is None else int(a[0] == 0), a[1]))
        elif op == "NOT":
            a = pop()
            push((None if a[0] is None else (~a[0]) & MASK, a[1]))
        elif op == "CALLDATALOAD":
            pop()
            push((None, TAINT_ATTACKER))
        elif op in _SOURCE_PUSH:
            push((None, _SOURCE_PUSH[op]))
        elif op == "PC":
            push((pc, 0))
        elif op in _MEM_ATTACKER_WRITES:
            for _ in range(3):
                pop()
            acc.write_mem(TAINT_ATTACKER)
        elif op in ("MSTORE", "MSTORE8"):
            pop()  # offset
            value = pop()
            acc.write_mem(value[1])
        elif op == "MLOAD":
            pop()
            push((None, acc.mem))
        elif op == "SHA3":
            pop(), pop()
            push((None, acc.mem | TAINT_UNKNOWN))
        elif op == "SSTORE":
            slot = pop()
            value = pop()
            acc.write_storage(slot[0], value[1])
            if result is not None:
                result.sstore_slots[pc] = slot
                result.sstore_values[pc] = value
        elif op == "SLOAD":
            slot = pop()
            if result is not None:
                result.sload_slots[pc] = slot
            push((None, slot[1] | acc.read_storage(slot[0])))
        elif op == "JUMP":
            target = pop()
            if result is not None:
                result.jump_targets[pc] = target
        elif op == "JUMPI":
            target = pop()
            cond = pop()
            if result is not None:
                result.jump_targets[pc] = target
                result.jumpi_conditions[pc] = cond
                if cond[1] & TAINT_ORIGIN:
                    result.origin_condition_pcs.append(pc)
                if cond[1] & TAINT_CALLER:
                    result.caller_condition_pcs.append(pc)
        elif op in _CALL_ARITY:
            gas = pop()
            target = pop()
            value = pop() if op in _CALL_HAS_VALUE else None
            for _ in range(4):  # inoff, insz, outoff, outsz
                pop()
            # the callee writes the return area; with a non-constant
            # or attacker target the payload is attacker-chosen
            acc.write_mem(TAINT_ATTACKER | TAINT_UNKNOWN)
            if result is not None:
                result.call_sites[pc] = {
                    "kind": op,
                    "target": target,
                    "value": value,
                    "gas": gas,
                }
            push((None, TAINT_UNKNOWN))
        elif op == "SUICIDE":
            beneficiary = pop()
            if result is not None:
                result.selfdestruct_sites[pc] = beneficiary
        elif op == "LOG1":
            pop(), pop()  # offset, size
            topic = pop()
            if result is not None:
                result.log1_topics[pc] = topic
        elif op in ("BALANCE", "EXTCODESIZE", "EXTCODEHASH", "BLOCKHASH"):
            pop()
            push((None, TAINT_UNKNOWN))
        elif op in ("CREATE", "CREATE2"):
            pops, _ = stack_effect(op)
            for _ in range(pops):
                pop()
            acc.write_mem(TAINT_UNKNOWN)
            push((None, TAINT_UNKNOWN))
        else:
            # generic fallback: the output derives from the inputs
            # plus whatever the opcode reads that we do not model
            pops, pushes = stack_effect(op)
            taint = TAINT_UNKNOWN
            for _ in range(pops):
                taint |= pop()[1]
            for _ in range(pushes):
                push((None, taint))
    return TaintState(tuple(stack), spill)


def _successors(
    cfg: CFG, flow: DataflowResult, block: BasicBlock
) -> Tuple[List[int], bool]:
    """(successor starts, broadcast?) from the DATAFLOW fixpoint's
    jump facts — the two passes must agree on the graph they walk."""
    out: List[int] = []
    terminator = block.terminator
    if block.start in flow.underflow_blocks:
        return out, False
    if terminator in ("JUMP", "JUMPI"):
        pc = block.end
        broadcast = pc in flow.unresolved_jumps
        target = flow.resolved_jumps.get(pc)
        dead = {d for p, d in flow.dead_directions if p == pc}
        if target is not None and not (
            terminator == "JUMPI" and True in dead
        ):
            out.append(target)
        if terminator == "JUMPI" and False not in dead:
            nxt = cfg.block_after(block.start)
            if nxt is not None:
                out.append(nxt.start)
        return out, broadcast
    if terminator == "FALL":
        nxt = cfg.block_after(block.start)
        if nxt is not None:
            out.append(nxt.start)
    return out, False


def run_taint(cfg: CFG, flow: DataflowResult) -> TaintResult:
    """Worklist fixpoint + recording pass; `flow` is the finished
    dataflow result for the same CFG."""
    t0 = time.perf_counter()
    result = TaintResult()
    if flow.incomplete or not cfg.blocks:
        result.incomplete = flow.incomplete
        result.wall_ms = round((time.perf_counter() - t0) * 1e3, 3)
        return result

    acc = _Accumulators()
    entry = cfg.starts[0]
    jumpdest_starts = [s for s in cfg.starts if cfg.blocks[s].is_jumpdest]
    in_states: Dict[int, TaintState] = {}
    visits = 0

    for _round in range(ACCUM_ROUNDS_CAP):
        acc.dirty = False
        in_states = {entry: TaintState.empty()}
        work: List[int] = [entry]
        broadcast_done = False
        while work:
            visits += 1
            if visits > TAINT_VISIT_CAP:
                result.incomplete = True
                log.debug(
                    "taint visit cap hit (%d blocks); opcode-screen "
                    "fallback",
                    len(cfg.blocks),
                )
                result.wall_ms = round(
                    (time.perf_counter() - t0) * 1e3, 3
                )
                return result
            start = work.pop()
            out_state = transfer(cfg.blocks[start], in_states[start], acc)
            successors, broadcast = _successors(
                cfg, flow, cfg.blocks[start]
            )
            if broadcast and not broadcast_done:
                broadcast_done = True
                unknown = TaintState.unknown()
                for s in jumpdest_starts:
                    merged = join(in_states.get(s), unknown)
                    if (
                        s not in in_states
                        or merged.key() != in_states[s].key()
                    ):
                        in_states[s] = merged
                        work.append(s)
            for s in successors:
                if s not in cfg.blocks:
                    continue
                merged = join(in_states.get(s), out_state)
                if s not in in_states or merged.key() != in_states[s].key():
                    in_states[s] = merged
                    work.append(s)
        if not acc.dirty:
            break
    else:
        # the accumulators never stabilized (cannot happen with a
        # monotone 4-bit mask — pure backstop)
        result.incomplete = True

    # recording pass over the fixpoint states
    for start, state in in_states.items():
        transfer(cfg.blocks[start], state, acc, result=result)
    result.reachable = set(in_states)
    result.mem_taint = acc.mem
    result.storage_written = dict(acc.storage)
    result.storage_any_taint = acc.storage_any
    result.wall_ms = round((time.perf_counter() - t0) * 1e3, 3)
    return result
