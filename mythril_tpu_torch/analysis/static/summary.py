"""StaticSummary: the per-code-hash product of the static layer.

The port's copy of the JAX package's analysis/static/summary.py, with the
package renamed.

Built once per code hash (module-level LRU; the service engine
additionally caches summaries in its own code LRU) and consumed by:

- `laser/batch/seeds.py` — `dead_selectors` drops dispatcher seeds
  for statically-inert functions (logged at DEBUG, counted);
- `laser/batch/explore.py` — `prune_directions()` keeps dead branch
  directions out of the flip frontier;
- `analysis/symbolic.py` / `analysis/security.py` — `features` feeds
  the detector pre-screen;
- `python -m mythril_tpu_torch lint` — `lint_dict()` renders the
  pure static findings + CFG/prune stats.

Soundness contract (the differential acceptance): nothing pruned here
may change the ISSUE set. Dead directions come from constant branch
conditions (the pruned flip would be UNSAT — no witness exists). Dead
selectors are functions whose whole resolved subgraph is *inert*: no
opcode any detector, trigger bank, or evidence bank observes, no
possible stack underflow, no unresolved jump, and only
bounded-operand REVERT/RETURN or STOP terminals — seeding or flipping
into them can only ever produce a clean, write-free halt.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static import callgraph as _callgraph
from mythril_tpu_torch.analysis.static.cfg import CFG, recover_cfg
from mythril_tpu_torch.analysis.static.dataflow import DataflowResult, run_dataflow
from mythril_tpu_torch.analysis.static.screen import screen_modules
from mythril_tpu_torch.analysis.static.taint import (
    TAINT_ATTACKER,
    TaintResult,
    run_taint,
)
from mythril_tpu_torch.analysis.static.vsa import ValueSets, value_sets

log = logging.getLogger(__name__)

#: `lint_dict()` payload version, pinned by the lint CLI tests. Bump
#: on any key-set change. v2: taint/value-set facts, per-selector
#: fingerprints, resolved call targets, semantic screen split, the
#: taint lint checks, and the schema_version field itself. v3: the
#: cross-contract link block (call-site provenance, proxy
#: classification) and the four link lint checks.
LINT_SCHEMA_VERSION = 3

#: every check `findings()` can emit — the CLI validates `--fail-on`
#: against this set so a typo'd check name errors instead of silently
#: never firing. The link checks live in `callgraph.LINK_CHECKS` so
#: the linker and the lint surface can't drift.
LINT_CHECKS = (
    frozenset(
        [
            "unreachable-code",
            "invalid-jump-target",
            "stack-underflow",
            "dead-branch",
            "inert-function",
            "tainted-jump-target",
            "tainted-delegatecall-target",
            "tx-origin-as-auth",
            "unprotected-selfdestruct",
        ]
    )
    | _callgraph.LINK_CHECKS
)

#: per-selector fingerprint subgraph bound: a dispatcher entry whose
#: resolved subgraph exceeds this is left unfingerprinted (the
#: incremental-reanalysis consumer treats "no fingerprint" as "always
#: re-analyze")
FINGERPRINT_MAX_BLOCKS = 512


def analysis_config_fingerprint(
    modules=None,
    transaction_count: Optional[int] = None,
    solver_timeout: Optional[int] = None,
    create_timeout: Optional[int] = None,
    creating: bool = False,
    extra: Optional[Dict] = None,
) -> str:
    """Content hash of everything VERDICT-relevant about the analysis
    configuration: two runs with the same code and the same fingerprint
    may share a verdict; any knob that could change the issue set must
    be in here. Hashed: the mythril_tpu version, the transaction count,
    the mounted-module set (None = the full registry), the per-query
    solver timeout, the create-tx budget, whether a create transaction
    runs at all, and the static-layer switches (a --no-static-prune
    verdict mounts more modules than a pruned one). Deliberately NOT
    hashed: the execution/wall budgets — they bound completeness, not
    soundness, and keying on them would shatter the store across every
    deadline setting.

    This is the shared key half of the cross-run verdict store
    (mythril_tpu/store) AND the in-memory `summary_for` cache: a
    StaticSummary's applicable-module verdict depends on the module
    registry in force, so the same code under two module sets must not
    alias one cache slot."""
    from mythril_tpu_torch import __version__
    from mythril_tpu_torch.support.support_args import args as _flags

    if solver_timeout is None:
        solver_timeout = getattr(_flags, "solver_timeout", None)
    parts = [
        f"v={__version__}",
        f"tx={2 if transaction_count is None else int(transaction_count)}",
        "mods={}".format(
            "*" if modules is None else ",".join(sorted(modules))
        ),
        f"st={solver_timeout}",
        f"ct={create_timeout}",
        f"create={int(bool(creating))}",
        f"sp={int(bool(getattr(_flags, 'static_prune', True)))}",
        f"sa={int(bool(getattr(_flags, 'static_answer', True)))}",
    ]
    if extra:
        parts.extend(f"{k}={extra[k]}" for k in sorted(extra))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

#: opcodes an inert (prunable) subgraph may contain: pure stack/data
#: shuffling plus control flow. Anything a detection module hooks, the
#: device evidence bank records (arith wraps, storage access, calls,
#: env reads), or that can degrade a lane (unbounded memory growth)
#: disqualifies the subgraph.
INERT_OPS = frozenset(
    ["POP", "JUMPDEST", "JUMP", "JUMPI", "STOP", "REVERT", "RETURN",
     "CALLDATALOAD", "CALLDATASIZE", "CALLVALUE", "CODESIZE", "PC", "GAS",
     "ISZERO", "EQ", "LT", "GT", "SLT", "SGT", "AND", "OR", "XOR", "NOT",
     "BYTE", "SHL", "SHR", "SAR"]
    + [f"PUSH{n}" for n in range(1, 33)]
    + [f"DUP{n}" for n in range(1, 17)]
    + [f"SWAP{n}" for n in range(1, 17)]
)
#: inert-subgraph size bound: bigger bodies are kept explorable
INERT_MAX_BLOCKS = 24


class DispatcherEntry:
    """One recovered dispatcher row: PUSH4 sel; EQ; [ISZERO...]
    PUSH target; JUMPI."""

    __slots__ = ("selector", "jumpi_pc", "entry_pc", "entry_taken")

    def __init__(
        self, selector: bytes, jumpi_pc: int, entry_pc: int, entry_taken: bool
    ) -> None:
        self.selector = selector
        self.jumpi_pc = jumpi_pc
        self.entry_pc = entry_pc
        #: the JUMPI direction that ENTERS the function body (False
        #: when an ISZERO inverted the compare and the body is the
        #: fall-through)
        self.entry_taken = entry_taken


class StaticSummary:
    """Everything the static pass established about one bytecode."""

    def __init__(self, code: bytes) -> None:
        t0 = time.perf_counter()
        self.code_hash = "0x" + hashlib.sha256(code).hexdigest()
        self.code_len = len(code)
        self.cfg: CFG = recover_cfg(code)
        self.flow: DataflowResult = run_dataflow(self.cfg)
        self.incomplete = self.flow.incomplete

        self.n_instructions = len(self.cfg.instructions)
        self.n_blocks = len(self.cfg.blocks)
        self.n_jumpis = sum(
            1 for b in self.cfg.blocks.values() if b.terminator == "JUMPI"
        )
        self.reachable_blocks: Set[int] = set(self.flow.reachable)
        self.dead_blocks: Set[int] = (
            set(self.cfg.blocks) - self.reachable_blocks
        )
        self.dead_instructions = sum(
            len(self.cfg.blocks[s]) for s in self.dead_blocks
        )
        #: branch directions proven infeasible by constant folding
        self.dead_directions: Set[Tuple[int, bool]] = set(
            self.flow.dead_directions
        )

        self.features: Set[str] = self._feature_set()
        self.dispatcher: List[DispatcherEntry] = self._recover_dispatcher()
        self.dead_selectors: Set[bytes] = set()
        #: dispatcher directions entering inert functions — pruned
        #: from the flip frontier alongside the infeasible directions
        self.inert_directions: Set[Tuple[int, bool]] = set()
        self._classify_dead_selectors()

        # the attacker-taint fixpoint + its value-set distillation
        # (taint.py / vsa.py): the semantic half of the detector
        # screen, the static-answer triage predicate, and the facts
        # behind the taint lint checks. Failure is a conservative
        # fallback (`taint=None` -> opcode screen decides), never an
        # error surface.
        self.taint: Optional[TaintResult] = None
        try:
            self.taint = run_taint(self.cfg, self.flow)
        except Exception:
            log.debug("taint pass failed; opcode-screen fallback",
                      exc_info=True)
        self.vsa: ValueSets = value_sets(self.taint, code)
        #: per-selector content hashes of each function's reachable
        #: subgraph — the dedup key incremental re-analysis (ROADMAP
        #: item 3) diffs against
        self.function_fingerprints: Dict[str, str] = (
            self._function_fingerprints()
        )
        #: per-contract half of the cross-contract linker: typed call
        #: sites with target provenance + proxy classification. None
        #: only if the link pass itself fails (linking degrades, the
        #: summary never does).
        self.link = None
        try:
            self.link = _callgraph.link_node(code, self)
        except Exception:
            log.debug("link pass failed; summary stays unlinked",
                      exc_info=True)

        #: mutable prune observability (seeds.py increments)
        self.seeds_dropped = 0
        self.wall_ms = round((time.perf_counter() - t0) * 1e3, 3)

    # -- derived feeds --------------------------------------------------
    def prune_directions(self) -> Set[Tuple[int, bool]]:
        """(jumpi_pc, taken) directions the explorer must never spend
        a flip on: infeasible (constant condition) plus inert
        (dispatcher entry of a statically-dead function)."""
        return self.dead_directions | self.inert_directions

    def applicable_modules(
        self, semantic: bool = True
    ) -> Tuple[List[str], List[str]]:
        """(applicable, skipped) detection-module class names.

        `semantic=True` (default) layers the per-module sink
        predicates over the opcode signatures; `semantic=False` is
        the opcode-only view (the bench reports both rates)."""
        if not semantic:
            return screen_modules(self.features)
        return screen_modules(
            self.features, taint=self.taint, vsa=self.vsa
        )

    @property
    def static_answerable(self) -> bool:
        """True when the semantic screen proves that NO detection
        module can fire on this code: the static-answer triage tier
        settles such a contract with an empty issue set at service
        admission / corpus dispatch, without ever touching the device.
        Requires a COMPLETE taint fixpoint — any bail keeps the
        contract on the full path."""
        if self.incomplete or self.taint is None or self.taint.incomplete:
            return False
        applicable, _skipped = self.applicable_modules()
        return not applicable

    @property
    def prune_units(self) -> int:
        return (
            len(self.dead_directions)
            + len(self.inert_directions)
            + len(self.dead_selectors)
            + len(self.dead_blocks)
        )

    @property
    def total_units(self) -> int:
        return 2 * self.n_jumpis + len(self.dispatcher) + self.n_blocks

    @property
    def prune_rate(self) -> float:
        total = self.total_units
        return round(self.prune_units / total, 4) if total else 0.0

    # -- construction helpers -------------------------------------------
    def _feature_set(self) -> Set[str]:
        if self.incomplete:
            # conservative: the whole instruction stream counts
            return {ins.opcode for ins in self.cfg.instructions}
        return {
            ins.opcode
            for start in self.reachable_blocks
            for ins in self.cfg.blocks[start].instructions
        }

    def _recover_dispatcher(self) -> List[DispatcherEntry]:
        """The Solidity selector-compare idiom, inversion-aware."""
        out: List[DispatcherEntry] = []
        instructions = self.cfg.instructions
        for i, ins in enumerate(instructions):
            if ins.opcode != "PUSH4" or not ins.argument:
                continue
            if i + 1 >= len(instructions) or instructions[i + 1].opcode != "EQ":
                continue
            inverted = False
            target_pc = None
            jumpi_pc = None
            for j in range(i + 2, min(i + 6, len(instructions))):
                op = instructions[j].opcode
                if op == "ISZERO":
                    inverted = not inverted
                elif op.startswith("PUSH"):
                    if (
                        j + 1 < len(instructions)
                        and instructions[j + 1].opcode == "JUMPI"
                    ):
                        target_pc = int(instructions[j].argument, 16)
                        jumpi_pc = instructions[j + 1].address
                    break
                else:
                    break
            if jumpi_pc is None or target_pc is None:
                continue
            selector = bytes.fromhex(ins.argument[2:].rjust(8, "0"))
            if inverted:
                # JUMPI skips PAST the body on mismatch: the function
                # entry is the fall-through
                nxt = self.cfg.block_after(
                    self.cfg.blocks[
                        max(
                            s
                            for s in self.cfg.starts
                            if s <= jumpi_pc
                        )
                    ].start
                )
                if nxt is None:
                    continue
                out.append(DispatcherEntry(selector, jumpi_pc, nxt.start, False))
            else:
                out.append(DispatcherEntry(selector, jumpi_pc, target_pc, True))
        return out

    def _classify_dead_selectors(self) -> None:
        if self.incomplete:
            return
        for entry in self.dispatcher:
            if self._subgraph_inert(entry.entry_pc):
                self.dead_selectors.add(entry.selector)
                self.inert_directions.add((entry.jumpi_pc, entry.entry_taken))

    def _subgraph_inert(self, entry_pc: int) -> bool:
        """True when every path from `entry_pc` over resolved edges is
        observable-effect-free (see module docstring)."""
        if entry_pc not in self.cfg.blocks:
            return False
        seen: Set[int] = set()
        work = [entry_pc]
        while work:
            start = work.pop()
            if start in seen:
                continue
            seen.add(start)
            if len(seen) > INERT_MAX_BLOCKS:
                return False
            block = self.cfg.blocks[start]
            if (
                start in self.flow.underflow_blocks
                or start in self.flow.possible_underflow_blocks
            ):
                return False
            for ins in block.instructions:
                if ins.opcode not in INERT_OPS:
                    return False
            terminator = block.terminator
            if terminator in ("REVERT", "RETURN"):
                if not self._halt_args_bounded(block):
                    return False
                continue
            if terminator == "STOP":
                continue
            if terminator in ("JUMP", "JUMPI"):
                pc = block.end
                if pc in self.flow.unresolved_jumps or pc in self.flow.invalid_jumps:
                    return False
                target = self.flow.resolved_jumps.get(pc)
                if target is None:
                    # block unreachable at fixpoint (no recorded jump
                    # facts): treat as not provably inert
                    return False
                dead = {
                    d for p, d in self.dead_directions if p == pc
                }
                if not (terminator == "JUMPI" and True in dead):
                    work.append(target)
                if terminator == "JUMPI" and False not in dead:
                    nxt = self.cfg.block_after(start)
                    if nxt is None:
                        return False
                    work.append(nxt.start)
                continue
            if terminator == "FALL":
                nxt = self.cfg.block_after(start)
                if nxt is None:
                    return False
                work.append(nxt.start)
                continue
            return False  # ASSERT_FAIL / SUICIDE / INVALID / unknown
        return True

    def _halt_args_bounded(self, block) -> bool:
        """REVERT/RETURN operands must be small constants (or DUPed
        zeros) so the halt cannot expand memory into a degraded lane —
        the `PUSH1 0 DUP1 REVERT` compiler shape and friends."""
        body = block.instructions[:-1]
        tail = body[-2:]
        if len(tail) < 2:
            return False
        for ins in tail:
            if ins.opcode.startswith("PUSH"):
                if int(ins.argument or "0", 16) > 4096:
                    return False
            elif not ins.opcode.startswith("DUP"):
                return False
        return True

    def _function_fingerprints(self) -> Dict[str, str]:
        """selector hex -> content hash of the function's reachable
        subgraph (blocks discovered over resolved edges from the
        dispatcher entry, dead directions honored; bytes hashed are
        each block's opcode names + immediates in block-start order).
        An entry whose subgraph hits an unresolved jump or the block
        cap gets NO fingerprint — "content unknown, always
        re-analyze"."""
        if self.incomplete:
            return {}
        out: Dict[str, str] = {}
        for entry in self.dispatcher:
            blocks = self._subgraph_blocks(entry.entry_pc)
            if blocks is None:
                continue
            digest = hashlib.sha256()
            for start in sorted(blocks):
                for ins in self.cfg.blocks[start].instructions:
                    digest.update(ins.opcode.encode())
                    if ins.argument:
                        digest.update(ins.argument.encode())
            out["0x" + entry.selector.hex()] = digest.hexdigest()[:16]
        return out

    def selector_subgraphs(self) -> Dict[str, List[Tuple[int, int]]]:
        """selector hex -> sorted [start, end] byte spans of the
        blocks in that function's resolved subgraph (the same blocks
        `_function_fingerprints` hashes). The verdict store's
        incremental diff uses these spans to attribute banked issues
        and covered branches to selectors: an address inside exactly
        one selector's spans belongs to that function; addresses in
        shared or dispatcher code attribute to no selector and stay
        conservative. Entries without a bounded subgraph are absent —
        same "content unknown" contract as the fingerprints."""
        out: Dict[str, List[Tuple[int, int]]] = {}
        if self.incomplete:
            return out
        for entry in self.dispatcher:
            blocks = self._subgraph_blocks(entry.entry_pc)
            if blocks is None:
                continue
            out["0x" + entry.selector.hex()] = sorted(
                (start, self.cfg.blocks[start].end)
                for start in blocks
            )
        return out

    def selector_entry_directions(self) -> Dict[str, Tuple[int, bool]]:
        """selector hex -> the (jumpi_pc, taken) dispatcher direction
        that ENTERS the function body — what the incremental
        re-analysis masks to keep an unchanged selector's flips out of
        the frontier."""
        return {
            "0x" + entry.selector.hex(): (entry.jumpi_pc, entry.entry_taken)
            for entry in self.dispatcher
        }

    def _subgraph_blocks(self, entry_pc: int) -> Optional[Set[int]]:
        """Block starts reachable from `entry_pc` over RESOLVED edges,
        or None when the subgraph cannot be bounded (unresolved jump /
        cap). Same traversal discipline as `_subgraph_inert`, without
        the opcode restrictions."""
        if entry_pc not in self.cfg.blocks:
            return None
        seen: Set[int] = set()
        work = [entry_pc]
        while work:
            start = work.pop()
            if start in seen:
                continue
            seen.add(start)
            if len(seen) > FINGERPRINT_MAX_BLOCKS:
                return None
            block = self.cfg.blocks[start]
            terminator = block.terminator
            if terminator in ("JUMP", "JUMPI"):
                pc = block.end
                if pc in self.flow.unresolved_jumps:
                    return None
                target = self.flow.resolved_jumps.get(pc)
                dead = {
                    d for p, d in self.flow.dead_directions if p == pc
                }
                if target is not None and not (
                    terminator == "JUMPI" and True in dead
                ):
                    if target in self.cfg.blocks:
                        work.append(target)
                if terminator == "JUMPI" and False not in dead:
                    nxt = self.cfg.block_after(start)
                    if nxt is not None:
                        work.append(nxt.start)
            elif terminator == "FALL":
                nxt = self.cfg.block_after(start)
                if nxt is not None:
                    work.append(nxt.start)
        return seen

    # -- rendering ------------------------------------------------------
    def stats(self) -> Dict:
        applicable, skipped = self.applicable_modules()
        opcode_applicable, _ = self.applicable_modules(semantic=False)
        out = {
            "code_hash": self.code_hash,
            "code_len": self.code_len,
            "instructions": self.n_instructions,
            "blocks": self.n_blocks,
            "reachable_blocks": len(self.reachable_blocks),
            "dead_blocks": len(self.dead_blocks),
            "dead_instructions": self.dead_instructions,
            "jumpis": self.n_jumpis,
            "resolved_jumps": len(self.flow.resolved_jumps),
            "unresolved_jumps": len(self.flow.unresolved_jumps),
            "invalid_jumps": len(self.flow.invalid_jumps),
            "dead_directions": len(self.dead_directions),
            "selectors": len(self.dispatcher),
            "dead_selectors": len(self.dead_selectors),
            "underflow_blocks": len(self.flow.underflow_blocks),
            "modules_applicable": len(applicable),
            # the opcode-only count beside the semantic one: the
            # bench's strictly-reduces acceptance reads both
            "modules_applicable_opcode": len(opcode_applicable),
            "modules_skipped": sorted(skipped),
            "modules_skipped_semantic": sorted(
                set(opcode_applicable) - set(applicable)
            ),
            "prune_rate": self.prune_rate,
            "seeds_dropped": self.seeds_dropped,
            "static_answerable": self.static_answerable,
            "incomplete": self.incomplete,
            "wall_ms": self.wall_ms,
            # per-selector subgraph fingerprints + resolved call
            # targets / constant slots: the enabling facts for ROADMAP
            # items 3 (incremental re-analysis) and 4 (cross-contract)
            "function_fingerprints": dict(self.function_fingerprints),
            "fingerprint_count": len(self.function_fingerprints),
        }
        out.update(self.vsa.stats())
        if self.taint is not None:
            out["taint"] = {
                "incomplete": self.taint.incomplete,
                "wall_ms": self.taint.wall_ms,
                "density": self.taint.taint_density,
                "sinks": self.taint.sink_counts(),
                "tainted_sinks": self.taint.tainted_sink_counts(),
                "origin_in_condition": bool(
                    self.taint.origin_condition_pcs
                ),
                "caller_in_condition": bool(
                    self.taint.caller_condition_pcs
                ),
                "arith_unsafe_sites": len(self.taint.arith_unsafe_pcs),
            }
        else:
            out["taint"] = {"incomplete": True}
        if self.link is not None:
            out["link"] = self.link.as_dict()
        return out

    def findings(self) -> List[Dict]:
        """Pure static findings for `lint` (informational — the
        lint surface, not security issues)."""
        out: List[Dict] = []
        if self.dead_blocks:
            out.append(
                {
                    "check": "unreachable-code",
                    "detail": (
                        f"{self.dead_instructions} instruction(s) across "
                        f"{len(self.dead_blocks)} block(s) are unreachable "
                        "from the entry point"
                    ),
                    "addresses": sorted(self.dead_blocks)[:16],
                }
            )
        for pc, target in sorted(self.flow.invalid_jumps.items()):
            out.append(
                {
                    "check": "invalid-jump-target",
                    "detail": (
                        f"jump at {pc} targets {target}, which is not a "
                        "valid JUMPDEST (execution there always fails)"
                    ),
                    "addresses": [pc],
                }
            )
        for start in sorted(self.flow.underflow_blocks):
            out.append(
                {
                    "check": "stack-underflow",
                    "detail": (
                        f"block at {start} underflows the stack on every "
                        "path (always-reverting)"
                    ),
                    "addresses": [start],
                }
            )
        for pc, dead_taken in sorted(self.dead_directions):
            direction = "taken" if dead_taken else "fall-through"
            out.append(
                {
                    "check": "dead-branch",
                    "detail": (
                        f"JUMPI at {pc}: the {direction} direction is "
                        "statically infeasible (constant condition)"
                    ),
                    "addresses": [pc],
                }
            )
        for entry in self.dispatcher:
            if entry.selector in self.dead_selectors:
                out.append(
                    {
                        "check": "inert-function",
                        "detail": (
                            f"function 0x{entry.selector.hex()} (entry "
                            f"{entry.entry_pc}) has no observable effect "
                            "(pruned from seeding)"
                        ),
                        "addresses": [entry.entry_pc],
                    }
                )
        out.extend(self._taint_findings())
        if self.link is not None:
            out.extend(self.link.findings())
        return out

    def _taint_findings(self) -> List[Dict]:
        """The taint lint checks: informational flow facts from the
        attacker-taint fixpoint (ATTACKER-bit sinks only — the same
        facts drive the semantic screen, rendered here for humans/CI
        via `lint --fail-on`)."""
        taint = self.taint
        if taint is None or taint.incomplete:
            return []
        out: List[Dict] = []
        jump_pcs = taint.tainted_jump_pcs()
        if jump_pcs:
            out.append(
                {
                    "check": "tainted-jump-target",
                    "detail": (
                        f"{len(jump_pcs)} jump(s) whose destination is "
                        "influenced by attacker-controlled input "
                        "(calldata/caller/callvalue)"
                    ),
                    "addresses": jump_pcs[:16],
                }
            )
        dc_pcs = taint.tainted_call_sites(kind="DELEGATECALL")
        if dc_pcs:
            out.append(
                {
                    "check": "tainted-delegatecall-target",
                    "detail": (
                        f"{len(dc_pcs)} DELEGATECALL(s) whose target "
                        "address is influenced by attacker-controlled "
                        "input — callee code executes in this "
                        "contract's storage context"
                    ),
                    "addresses": dc_pcs[:16],
                }
            )
        if taint.origin_condition_pcs:
            out.append(
                {
                    "check": "tx-origin-as-auth",
                    "detail": (
                        "tx.origin reaches "
                        f"{len(taint.origin_condition_pcs)} branch "
                        "guard(s) — origin-based authorization is "
                        "phishable; use msg.sender"
                    ),
                    "addresses": sorted(taint.origin_condition_pcs)[:16],
                }
            )
        if taint.selfdestruct_sites and not (
            taint.caller_condition_pcs or taint.origin_condition_pcs
        ):
            out.append(
                {
                    "check": "unprotected-selfdestruct",
                    "detail": (
                        "SELFDESTRUCT is reachable and no branch in "
                        "the contract compares msg.sender or "
                        "tx.origin — nothing gates who may kill it"
                    ),
                    "addresses": sorted(taint.selfdestruct_sites)[:16],
                }
            )
        return out

    def lint_dict(self, name: str = "") -> Dict:
        out = {"contract": name} if name else {}
        out["schema_version"] = LINT_SCHEMA_VERSION
        out.update(self.stats())
        out["findings"] = self.findings()
        return out


# ---------------------------------------------------------------------------
# per-code-hash cache
# ---------------------------------------------------------------------------
_CACHE: "OrderedDict[str, StaticSummary]" = OrderedDict()
_CACHE_CAP = 256
#: the cache is shared across threads (service HTTP admission, wave
#: thread, host-pool workers); one lock keeps the OrderedDict sane
_CACHE_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0


def _as_bytes(code) -> bytes:
    if isinstance(code, bytes):
        return code
    code = code or ""
    if code.startswith("0x"):
        code = code[2:]
    from mythril_tpu_torch.disassembler.asm import safe_decode

    return safe_decode(code)


def analyze_bytecode(code) -> StaticSummary:
    """Uncached static analysis of bytecode (bytes or hex str)."""
    return StaticSummary(_as_bytes(code))


def summary_for(code, config_fp: Optional[str] = None) -> StaticSummary:
    """Cached static analysis (thread-safe). The cache key is
    (code hash, analysis-config fingerprint): a summary's
    applicable-module/static-answerable VERDICT depends on the module
    set and static flags in force, so the same code under two configs
    must occupy two slots — the same key discipline the persistent
    verdict store uses. `config_fp` defaults to the current global
    configuration's fingerprint."""
    global _HITS, _MISSES
    raw = _as_bytes(code)
    if config_fp is None:
        config_fp = analysis_config_fingerprint()
    key = hashlib.sha256(raw).hexdigest() + ":" + config_fp
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _HITS += 1
            _CACHE.move_to_end(key)
            return hit
    summary = StaticSummary(raw)
    with _CACHE_LOCK:
        _MISSES += 1
        _CACHE[key] = summary
        while len(_CACHE) > _CACHE_CAP:
            _CACHE.popitem(last=False)
    return summary


def clear_static_cache() -> None:
    global _HITS, _MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0


def static_cache_stats() -> Dict:
    with _CACHE_LOCK:
        return {"size": len(_CACHE), "hits": _HITS, "misses": _MISSES}
