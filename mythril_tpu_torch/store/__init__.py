"""Cross-run verdict store + fingerprint-diff incremental re-analysis.

The port's copy of the JAX package's store/, with the package renamed
(store.py names the one departure: failures the JAX package only logs
are recorded in the DegradationLog).

At millions-of-users scale most submissions are exact duplicates,
forks, or proxy/implementation upgrades of contracts already analyzed
— yet every job would otherwise pay the full
static -> prepass -> wave -> solve pipeline. This package turns
completed analyses into a growing knowledge base:

1. **Exact hit** — `serve` admission and `analyze_corpus` look
   up (codehash, analysis-config fingerprint) and settle repeat jobs
   on the spot: registry-only admission, no queue slot, no wave, no
   walk — the same settle discipline as the static-answer tier.
2. **Near-duplicate** — on a codehash miss, the submitted contract's
   per-selector subgraph fingerprints (the StaticSummary export)
   diff against the store's nearest entry; only CHANGED selectors are
   re-explored (their unchanged siblings' dispatcher seeds and flip
   directions are masked), banked issues merge for the untouched
   rest, and banked branch coverage pre-empts the walk's feasibility
   queries. Conservative bail to full analysis whenever fingerprints
   are absent/incomplete or the taint layer sees cross-selector state
   flow (store/diff.py).
3. **Write-back** — every completed full analysis persists its
   verdict, static export, and evidence banks (store/store.py).

Keying: `analysis_config_fingerprint` (analysis/static/summary.py)
hashes everything verdict-relevant — tx count, module set, solver
timeout, create flags, version — so a verdict is only ever served to
a configuration that would have computed the same one.

`--store DIR` / `--no-store` on `analyze` and `serve`;
`store.{hits,near_hits,misses,writes,bytes,evictions}` in `/stats`
and `mtpu_store_*` in Prometheus.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from mythril_tpu_torch.store.diff import (  # noqa: F401
    IncrementalBail,
    IncrementalPlan,
    SelectorMaskFeed,
    merge_banked_issues,
    plan_incremental,
    plan_linked_incremental,
)
from mythril_tpu_torch.store.store import (  # noqa: F401
    ENTRY_SCHEMA_VERSION,
    StoreEntry,
    VerdictStore,
    close_stores,
    code_hash_hex,
    open_store,
)


def store_enabled() -> bool:
    """The --no-store switch (rides the global flag bag like the
    static/specialize switches)."""
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "store", True))


def configured_store(directory: Optional[str] = None):
    """The VerdictStore in force, or None: an explicit directory wins,
    else the flag bag's `store_dir` (CLI --store DIR); either way
    `--no-store` turns the tier off entirely."""
    if not store_enabled():
        return None
    if directory is None:
        from mythril_tpu_torch.support.support_args import args

        directory = getattr(args, "store_dir", None)
    return open_store(directory)


def static_export(summary, linkset=None) -> Dict:
    """The StaticSummary slice a store entry carries: enough to diff a
    future fork against this verdict (fingerprints + selector block
    spans), to sanity-check pc stability (code_len), and — when a
    corpus `LinkSet` is in force — the CALL-GRAPH fingerprints
    (selector -> hash of base fp + resolved callee closure) that let
    a later run detect "same code, upgraded callee" and re-analyze
    only the selectors whose closure moved."""
    if summary is None:
        return {}
    try:
        out = _static_export_base(summary)
        if linkset is not None and summary.link is not None:
            linked, problems = linkset.linked_fingerprints(
                summary.code_hash
            )
            if linked:
                out["linked_fingerprints"] = linked
            if problems:
                out["link_problems"] = problems
            meta = linkset.node_meta(summary.code_hash)
            if meta is not None:
                out["link"] = {
                    "out_degree": meta.get("out_degree", 0),
                    "resolved_degree": meta.get("resolved_degree", 0),
                    "is_proxy": meta.get("is_proxy", False),
                    "proxy_kind": meta.get("proxy_kind"),
                    "escape_density": meta.get("escape_density", 0.0),
                }
        return out
    except Exception:
        return {}


def _static_export_base(summary) -> Dict:
    return {
        "code_len": summary.code_len,
        "function_fingerprints": dict(summary.function_fingerprints),
        "selector_spans": {
            sel: [list(span) for span in spans]
            for sel, spans in summary.selector_subgraphs().items()
        },
        "resolved_call_targets": {
            str(pc): f"0x{target:040x}"
            for pc, target in sorted(
                getattr(
                    summary.vsa, "resolved_call_targets", {}
                ).items()
            )
        }
        if getattr(summary, "vsa", None) is not None
        else {},
        "static_answerable": bool(summary.static_answerable),
    }


def banks_from_outcome(outcome: Optional[Dict]) -> Dict:
    """The evidence banks a store entry carries, harvested from a
    device-prepass/explorer outcome: covered branch directions and
    trigger witnesses (each trigger row already holds its concrete
    calldata — the seeds a future warm run replays). Empty for
    walk-only analyses."""
    if not outcome:
        return {}
    out: Dict = {}
    covered = outcome.get("covered_branches")
    if covered:
        out["covered"] = [[int(p), bool(t)] for p, t in covered][:4096]
    triggers = outcome.get("triggers")
    if triggers:
        out["triggers"] = {
            kind: [dict(row) for row in rows][:64]
            for kind, rows in triggers.items()
        }
    return out


def provenance(
    wall_s: Optional[float] = None,
    computed_by: str = "",
    degradations: Optional[List[str]] = None,
    incremental: bool = False,
) -> Dict:
    out: Dict = {"computed_by": computed_by or "analysis"}
    if wall_s is not None:
        out["wall_s"] = round(float(wall_s), 4)
    if degradations:
        out["degradations"] = list(degradations)
    if incremental:
        out["incremental"] = True
    out["stored_at"] = time.time()
    return out


__all__ = [
    "ENTRY_SCHEMA_VERSION",
    "IncrementalBail",
    "IncrementalPlan",
    "SelectorMaskFeed",
    "StoreEntry",
    "VerdictStore",
    "banks_from_outcome",
    "close_stores",
    "code_hash_hex",
    "configured_store",
    "merge_banked_issues",
    "open_store",
    "plan_incremental",
    "plan_linked_incremental",
    "provenance",
    "static_export",
    "store_enabled",
]
