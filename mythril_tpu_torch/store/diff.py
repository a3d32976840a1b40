"""Fingerprint-diff incremental re-analysis planning.

The port's copy of the JAX package's store/diff.py, with the package
renamed.

Given a NEW contract's StaticSummary and the nearest stored verdict
(store.py `nearest`), decide which selectors actually changed and
build the plan the corpus driver executes:

- **mask** — the unchanged selectors' dispatcher seeds and
  entry-flip directions are pruned from the device exploration
  (seeds.py / explore.py already speak this protocol for
  statically-dead selectors), so lanes and flips are spent only on
  the changed functions;
- **bank merge** — the stored issues attributed (by selector block
  span) to unchanged functions merge into the fork's result;
- **coverage injection** — the stored covered branch directions
  inside unchanged functions are injected as a synthetic prepass
  outcome, so the host walk skips feasibility queries the base
  contract's analysis already answered concretely.

Everything here is CONSERVATIVE: any doubt — missing or incomplete
fingerprints, an incomplete taint fixpoint, cross-selector state flow
(a changed function writes storage an unchanged one reads, so banked
verdicts could be stale), delegatecall/selfdestruct in reach, issues
that cannot be attributed to exactly one unchanged function — bails
to full analysis (`IncrementalBail` carries the reason for the
routing log). The host walk itself always runs over the full
contract: incremental mode narrows what the DEVICE explores and what
the walk must re-prove, never what the walk may discover.
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

#: opcodes whose presence in a CHANGED function's subgraph can
#: invalidate an UNCHANGED function's banked verdict through shared
#: state — the write half of the cross-selector flow check
_STATE_WRITE_OPS = frozenset(["SSTORE", "SELFDESTRUCT", "CREATE", "CREATE2"])
#: opcodes that make a function's verdict depend on shared state —
#: the read half
_STATE_READ_OPS = frozenset(["SLOAD"])
#: opcodes that void span-local reasoning entirely (foreign code runs
#: in this contract's storage context / arbitrary effects)
_ESCAPE_OPS = frozenset(["DELEGATECALL", "CALLCODE"])


class IncrementalBail(Exception):
    """Raised (and caught by the planner) when the diff cannot be
    trusted; `.reason` feeds the routing/observability surface."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class SelectorMaskFeed:
    """A StaticSummary wrapper that additionally masks the UNCHANGED
    selectors like statically-dead ones: `dispatcher_seeds(prune=feed)`
    drops their seeds, and the explorer blacklists their dispatcher
    entry directions from the flip frontier. Everything else delegates
    to the wrapped summary, so the specialization signature and the
    screen see the real code."""

    def __init__(self, static, mask_selectors, mask_directions) -> None:
        assert static is not None
        self._static = static
        self.mask_selectors: FrozenSet[bytes] = frozenset(mask_selectors)
        self.mask_directions: FrozenSet[Tuple[int, bool]] = frozenset(
            mask_directions
        )
        #: own drop counter — consumers increment the feed they were
        #: handed, and the wrapped summary's counter is shared across
        #: runs (it lives in the summary LRU)
        self.seeds_dropped = 0

    @property
    def dead_selectors(self) -> FrozenSet[bytes]:
        return frozenset(self._static.dead_selectors) | self.mask_selectors

    def prune_directions(self) -> Set[Tuple[int, bool]]:
        return set(self._static.prune_directions()) | set(
            self.mask_directions
        )

    def __getattr__(self, name):
        return getattr(self._static, name)


class IncrementalPlan:
    """Everything the corpus driver needs to execute one contract's
    incremental re-analysis against a stored base verdict."""

    def __init__(
        self,
        base_code_hash: str,
        changed: Set[str],
        unchanged: Set[str],
        mask_selectors: Set[bytes],
        mask_directions: Set[Tuple[int, bool]],
        banked_issues: List[Dict],
        injected_outcome: Optional[Dict],
        linked: bool = False,
    ) -> None:
        self.base_code_hash = base_code_hash
        self.changed = set(changed)
        self.unchanged = set(unchanged)
        self.mask_selectors = set(mask_selectors)
        self.mask_directions = set(mask_directions)
        self.banked_issues = list(banked_issues)
        self.injected_outcome = injected_outcome
        #: True when this plan came from a LINKED-fingerprint diff
        #: (same codehash, moved callee closure) rather than a code
        #: diff against a near-neighbor
        self.linked = linked

    def mask_feed(self, static) -> SelectorMaskFeed:
        return SelectorMaskFeed(
            static, self.mask_selectors, self.mask_directions
        )

    def as_dict(self) -> Dict:
        return {
            "base_code_hash": self.base_code_hash,
            "changed_selectors": sorted(self.changed),
            "unchanged_selectors": sorted(self.unchanged),
            "banked_issues": len(self.banked_issues),
            "coverage_injected": bool(self.injected_outcome),
            "linked": self.linked,
        }


def _spans_contain(spans: List, address: int) -> bool:
    return any(start <= address <= end for start, end in spans)


def _selectors_at(
    selector_spans: Dict[str, List], address: int
) -> Set[str]:
    return {
        sel
        for sel, spans in selector_spans.items()
        if _spans_contain(spans, address)
    }


def _span_ops(summary, selectors: Set[str]) -> Set[str]:
    """The opcode set inside `selectors`' subgraph blocks of the NEW
    summary (block spans from the summary itself)."""
    spans = summary.selector_subgraphs()
    out: Set[str] = set()
    starts = {
        start
        for sel in selectors
        for start, _end in spans.get(sel, [])
    }
    for start in starts:
        block = summary.cfg.blocks.get(start)
        if block is None:
            continue
        out.update(ins.opcode for ins in block.instructions)
    return out


def plan_incremental(summary, entry) -> IncrementalPlan:
    """The incremental plan for re-analyzing `summary`'s contract
    against stored `entry`, or raise IncrementalBail. `summary` is the
    NEW code's StaticSummary; `entry` is a store.StoreEntry holding
    the base verdict."""
    if summary is None or summary.incomplete:
        raise IncrementalBail("summary-incomplete")
    if summary.taint is None or summary.taint.incomplete:
        raise IncrementalBail("taint-incomplete")
    new_fps = dict(summary.function_fingerprints)
    old_fps = entry.fingerprints
    if not new_fps or not old_fps:
        raise IncrementalBail("fingerprints-absent")
    new_dirs = summary.selector_entry_directions()
    # a dispatcher entry WITHOUT a fingerprint is content-unknown:
    # its flips/seeds must not be masked and nothing may be banked
    # against it; if any selector lacks a fingerprint the partition is
    # incomplete — bail
    if set(new_dirs) - set(new_fps):
        raise IncrementalBail("fingerprints-incomplete")
    unchanged = {
        sel
        for sel in set(new_fps) & set(old_fps)
        if new_fps[sel] == old_fps[sel]
    }
    changed = set(new_fps) - unchanged
    if not unchanged:
        raise IncrementalBail("no-shared-selectors")
    if not changed and set(new_fps) == set(old_fps):
        # every function fingerprint matches yet the code hash differs:
        # the change is in dispatcher/shared/unfingerprinted code —
        # span-local reasoning cannot bound it
        raise IncrementalBail("change-outside-functions")
    # -- cross-selector state flow (the staleness hazard) --------------
    changed_ops = _span_ops(summary, changed)
    unchanged_ops = _span_ops(summary, unchanged)
    if _ESCAPE_OPS & (changed_ops | unchanged_ops):
        raise IncrementalBail("delegatecall-in-reach")
    if (_STATE_WRITE_OPS & changed_ops) and (
        _STATE_READ_OPS & unchanged_ops
    ):
        # a changed function can write state an unchanged one reads:
        # the banked verdicts for the unchanged rest may be stale
        raise IncrementalBail("cross-selector-state-flow")

    # -- bank attribution ----------------------------------------------
    old_spans = entry.selector_spans
    if not old_spans:
        raise IncrementalBail("selector-spans-absent")
    banked: List[Dict] = []
    for issue in entry.issues:
        address = issue.get("address")
        if not isinstance(address, int):
            raise IncrementalBail("unattributable-issue")
        owners = _selectors_at(old_spans, address)
        if not owners:
            # dispatcher/shared-code issue: the fresh walk re-derives
            # it — not banked, not a bail
            continue
        if owners <= unchanged:
            banked.append(dict(issue))
        # an issue in a changed (or partially-changed) function is the
        # fresh analysis's job — dropped from the bank

    injected = _injected_outcome(summary, entry, unchanged, old_spans)
    mask_selectors = {
        bytes.fromhex(sel[2:]) for sel in unchanged
    }
    mask_directions = {
        new_dirs[sel] for sel in unchanged if sel in new_dirs
    }
    return IncrementalPlan(
        base_code_hash=entry.code_hash,
        changed=changed,
        unchanged=unchanged,
        mask_selectors=mask_selectors,
        mask_directions=mask_directions,
        banked_issues=banked,
        injected_outcome=injected,
    )


def _injected_outcome(
    summary, entry, unchanged: Set[str], old_spans: Dict[str, List]
) -> Optional[Dict]:
    """A synthetic prepass outcome carrying the base analysis's banked
    evidence RESTRICTED to unchanged functions: covered branch
    directions (the host walk skips their feasibility queries) and
    trigger witnesses. Only valid when the fork kept the base
    contract's byte length — program counters must line up — and only
    for addresses inside unchanged-selector spans; None otherwise
    (the walk just runs without pre-coverage)."""
    banks = entry.banks
    if not banks:
        return None
    if entry.code_len and entry.code_len != summary.code_len:
        return None
    covered = [
        [int(pc), bool(taken)]
        for pc, taken in (banks.get("covered") or [])
        if _selectors_at(old_spans, int(pc)) <= unchanged
        and _selectors_at(old_spans, int(pc))
    ]
    triggers: Dict[str, List[Dict]] = {}
    for kind, rows in (banks.get("triggers") or {}).items():
        kept = [
            dict(row)
            for row in rows
            if isinstance(row.get("pc"), int)
            and _selectors_at(old_spans, row["pc"])
            and _selectors_at(old_spans, row["pc"]) <= unchanged
        ]
        if kept:
            triggers[kind] = kept
    if not covered and not triggers:
        return None
    return {
        "covered_branches": covered,
        "corpus_size": 0,
        "triggers": triggers,
        "evidence": [],
        "device_complete": False,
        "completeness_gates": {},
        "degraded_lanes": 0,
        "store_bank": True,
        "stats": {
            "device_steps": 0,
            "waves": 0,
            "wall_s": 0.0,
            "arena_nodes": 0,
            "forks_tried": 0,
            "forks_feasible": 0,
            "device_sat": 0,
            "branches_covered": len(covered),
            "partial": False,
        },
    }


def plan_linked_incremental(
    summary,
    entry,
    linked_now: Dict[str, str],
    link_problems: Optional[Dict[str, str]] = None,
) -> Optional[IncrementalPlan]:
    """The CALL-GRAPH-fingerprint incremental plan: `summary`'s
    contract has the SAME codehash as stored `entry` (an exact store
    hit), but a callee behind one of its resolved call edges changed —
    visible as a linked-fingerprint mismatch between `linked_now`
    (the current LinkSet's selector -> linked fp for this contract)
    and the fps persisted with the entry.

    Returns None when every linked fingerprint matches (the exact hit
    stands as-is), an IncrementalPlan re-analyzing only the selectors
    whose callee closure moved, or raises IncrementalBail — including
    the link-specific reasons ``link-unresolved`` / ``link-cycle``
    when the current graph cannot pin a selector's closure.

    The code being byte-identical relaxes one plan_incremental rule:
    DELEGATECALL inside a CHANGED selector is the expected shape (the
    proxy's forward function), not a bail — but it counts as a state
    WRITE for the cross-selector staleness check, since the new
    implementation may store anywhere."""
    if summary is None or summary.incomplete:
        raise IncrementalBail("summary-incomplete")
    if summary.taint is None or summary.taint.incomplete:
        raise IncrementalBail("taint-incomplete")
    problems = dict(link_problems or {})
    if problems:
        # a selector whose closure crosses an unresolved edge or a
        # cycle can never be proven unchanged — conservative full bail
        raise IncrementalBail(sorted(set(problems.values()))[0])
    old_linked = entry.linked_fingerprints
    if not old_linked or not linked_now:
        raise IncrementalBail("linked-fingerprints-absent")
    new_fps = dict(summary.function_fingerprints)
    if not new_fps:
        raise IncrementalBail("fingerprints-absent")
    new_dirs = summary.selector_entry_directions()
    if set(new_dirs) - set(new_fps):
        raise IncrementalBail("fingerprints-incomplete")
    unchanged = {
        sel
        for sel in set(linked_now) & set(old_linked)
        if linked_now[sel] == old_linked[sel]
    }
    changed = set(new_fps) - unchanged
    if not changed:
        return None  # closure identical everywhere: pure exact hit
    if not unchanged:
        raise IncrementalBail("no-shared-selectors")

    changed_ops = _span_ops(summary, changed)
    unchanged_ops = _span_ops(summary, unchanged)
    if _ESCAPE_OPS & unchanged_ops:
        # an unchanged selector's OWN delegatecall is pinned by its
        # matching linked fp, but its matching fp cannot pin what a
        # CHANGED selector's callee does to shared storage it reads —
        # and with escape ops on the unchanged side the span-local
        # issue attribution below loses meaning
        raise IncrementalBail("delegatecall-in-reach")
    writes = (_STATE_WRITE_OPS | _ESCAPE_OPS) & changed_ops
    if writes and (_STATE_READ_OPS & unchanged_ops):
        raise IncrementalBail("cross-selector-state-flow")

    old_spans = entry.selector_spans
    if not old_spans:
        raise IncrementalBail("selector-spans-absent")
    banked: List[Dict] = []
    for issue in entry.issues:
        address = issue.get("address")
        if not isinstance(address, int):
            raise IncrementalBail("unattributable-issue")
        owners = _selectors_at(old_spans, address)
        if not owners:
            continue
        if owners <= unchanged:
            banked.append(dict(issue))

    injected = _injected_outcome(summary, entry, unchanged, old_spans)
    mask_selectors = {bytes.fromhex(sel[2:]) for sel in unchanged}
    mask_directions = {
        new_dirs[sel] for sel in unchanged if sel in new_dirs
    }
    return IncrementalPlan(
        base_code_hash=entry.code_hash,
        changed=changed,
        unchanged=unchanged,
        mask_selectors=mask_selectors,
        mask_directions=mask_directions,
        banked_issues=banked,
        injected_outcome=injected,
        linked=True,
    )


def merge_banked_issues(
    result_issues: List[Dict], banked: List[Dict]
) -> int:
    """Fold the plan's banked issues into a fresh result's issue list
    (same dedup rule as the prepass witness merge: one issue per
    (address, swc-id)). Returns how many were actually added."""
    seen = {
        (issue.get("address"), issue.get("swc-id"))
        for issue in result_issues
    }
    added = 0
    for issue in banked:
        key = (issue.get("address"), issue.get("swc-id"))
        if key in seen:
            continue
        seen.add(key)
        result_issues.append(dict(issue))
        added += 1
    return added
