"""The routing feature log: one record per analyzed contract, joining
static-summary features with the analysis outcome.

A host/device routing cost model (routing/) needs a training set.
This module emits it: for every contract a
corpus run analyzes, one JSONL record holding

- **features** available BEFORE any routing decision — code size, CFG
  block/instruction counts, selector counts, storage-op density,
  screened-detector count, the kernel-specialization phase bucket;
- **outcome** observed AFTER — the route actually taken (device-owned
  / host walk / skipped), per-contract wall, waves, issues, verdicts.

`analyze --observe-out DIR` lands the records in
``DIR/routing_features.jsonl``; an in-memory tail is always kept (the
bench and the tests read it without touching disk). Schema is
versioned (`schema_version`) so the future trainer can pin it.

The port's copy of the JAX package's observe/routing.py: the same
records, features and route vocabulary, so a log either package wrote
trains a router the other loads. Two departures: the specialization
bucket (`phase_bucket`) is built here (`_phase_bucket`, the JAX
compile plane's `bucket_key`, which the port does not have), and a
record that cannot be appended to the log file is recorded in the
DegradationLog (`routing-record-failed`), where the JAX package
drops it silently; the analysis stands.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

#: routing-record schema version — the routing log's OWN version, no
#: longer tied to the registry's. v2 adds the taint/value-set feature
#: block (taint_density, per-sink-kind tainted counts, resolved call
#: targets, fingerprint count, static answerability) and the
#: "static-answer" route. v3 adds the top-level ``journey_id`` — the
#: key that joins a record to its tier-ladder timeline
#: (observe/journey.py), so features ⨝ route ⨝ outcome ⨝ timeline
#: joins offline. v4 adds the cross-contract link feature block
#: (`V4_FEATURE_KEYS`): out-degree / resolved degree of the contract's
#: static call graph node, proxy classification flags, and the escape
#: -summary density — the "how entangled is this contract" axis the
#: cost model needs once multi-account arenas exist. v1/v2/v3 records
#: parse through `read_records` / `parse_record` unchanged (absent
#: features read as None; absent journey_id reads as None).
SCHEMA_VERSION = 4

#: every record carries exactly these top-level keys (the JSONL golden
#: test pins them); ``journey_id`` may be None for pre-v3 records
RECORD_KEYS = (
    "schema_version", "contract", "code_hash", "features", "outcome",
    "journey_id",
)

#: feature keys added by schema v2 (the back-compat reader fills them
#: with None for v1 records so a trainer sees one column set)
V2_FEATURE_KEYS = (
    "taint_density",
    "tainted_sinks",
    "sink_counts",
    "resolved_call_targets",
    "fingerprints",
    "static_answerable",
)

#: feature keys added by schema v4 (the cross-contract linker block;
#: same None-fill back-compat rule as V2_FEATURE_KEYS)
V4_FEATURE_KEYS = (
    "link_out_degree",
    "link_resolved_degree",
    "link_is_proxy",
    "link_proxy_kind",
    "link_delegatecall_sites",
    "link_escape_density",
)


class RoutingLog:
    """Thread-safe JSONL writer + bounded in-memory tail."""

    def __init__(self, capacity: int = 2048) -> None:
        self._mu = threading.Lock()
        self._tail: "deque[Dict]" = deque(maxlen=capacity)
        self.written = 0

    def record(
        self,
        contract: str,
        code_hash: str,
        features: Dict,
        outcome: Dict,
        journey_id: Optional[str] = None,
    ) -> Dict:
        from mythril_tpu_torch import observe
        from mythril_tpu_torch.support.resilience import (
            DegradationLog,
            DegradationReason,
        )

        rec = {
            "schema_version": SCHEMA_VERSION,
            "contract": contract,
            "code_hash": code_hash,
            "features": features,
            "outcome": outcome,
            "journey_id": journey_id,
        }
        if not observe.enabled():
            return rec
        line = json.dumps(rec, sort_keys=True)
        out_dir = observe.out_dir()
        with self._mu:
            self._tail.append(rec)
            self.written += 1
            if out_dir:
                try:
                    with open(
                        os.path.join(out_dir, "routing_features.jsonl"), "a"
                    ) as fp:
                        fp.write(line + "\n")
                except OSError as why:
                    # a full/readonly disk must not sink the analysis,
                    # but the lost row is recorded
                    DegradationLog().record(
                        DegradationReason.ROUTING_RECORD_FAILED,
                        site="routing-log",
                        detail=str(why),
                        contract=contract,
                    )
        return rec

    def tail(self, n: int = 256) -> List[Dict]:
        with self._mu:
            return list(self._tail)[-n:]

    def clear(self) -> None:
        with self._mu:
            self._tail.clear()


_LOG = RoutingLog()


def routing_log() -> RoutingLog:
    return _LOG


#: storage / call / env opcode sets for the density features (byte
#: scan over-approximates into PUSH data, uniformly for every
#: contract — fine for a ranking feature)
_STORAGE_OPS = (0x54, 0x55)  # SLOAD, SSTORE
_CALL_OPS = (0xF1, 0xF2, 0xF4, 0xFA)  # CALL family


def features_for(code_hex: str, summary=None, link=None) -> Dict:
    """The static feature vector for one contract. Uses the cached
    StaticSummary when available (CFG sizes, dead selectors, screened
    modules); degrades to byte-scan features when the static layer is
    off or failed — the record always exists. Pass ``summary=False``
    to skip the summary build outright (the microsecond admission
    tiers must not pay a CFG recovery for a telemetry row).

    ``link`` is an optional corpus-resolved link block
    (LinkSet.node_meta): when given it fills the schema-v4 features
    with graph-resolved values (resolved degree, escape density);
    without it the per-contract half (out-degree, proxy flags) still
    lands from the summary's own link node and the graph-level columns
    stay None."""
    code_hex = code_hex[2:] if code_hex.startswith("0x") else code_hex
    try:
        code = bytes.fromhex(code_hex)
    except ValueError:
        code = b""
    n = max(1, len(code))
    feats: Dict = {
        "code_bytes": len(code),
        "storage_op_density": round(
            sum(code.count(bytes([op])) for op in _STORAGE_OPS) / n, 5
        ),
        "call_op_density": round(
            sum(code.count(bytes([op])) for op in _CALL_OPS) / n, 5
        ),
    }
    if summary is False:
        summary = None
    elif summary is None:
        try:
            from mythril_tpu_torch.analysis.static import (
                static_prune_enabled,
                summary_for,
            )

            if static_prune_enabled():
                summary = summary_for(code_hex)
        except Exception:
            summary = None
    if summary is not None:
        try:
            row = summary.lint_dict()
            feats.update(
                cfg_blocks=row.get("blocks"),
                cfg_reachable_blocks=row.get("reachable_blocks"),
                instructions=row.get("instructions"),
                selectors=row.get("selectors"),
                dead_selectors=row.get("dead_selectors"),
                dead_directions=row.get("dead_directions"),
                modules_screened=row.get("modules_applicable"),
                # schema v2: the taint/value-set block — how
                # attacker-steerable the contract is, how much of its
                # call/storage surface is constant, and whether the
                # triage tier can settle it outright (the single
                # strongest routing feature: cost zero)
                taint_density=(row.get("taint") or {}).get("density"),
                tainted_sinks=(
                    sum(
                        ((row.get("taint") or {}).get("tainted_sinks")
                         or {}).values()
                    )
                ),
                sink_counts=(row.get("taint") or {}).get("sinks"),
                resolved_call_targets=row.get(
                    "resolved_call_target_count"
                ),
                fingerprints=row.get("fingerprint_count"),
                static_answerable=row.get("static_answerable"),
            )
        except Exception:
            pass
    # schema v4: the cross-contract link block — corpus-resolved when
    # a LinkSet rode along, per-contract (graph columns None) otherwise
    link_row = link
    if link_row is None and summary is not None:
        node = getattr(summary, "link", None)
        if node is not None:
            try:
                link_row = node.as_dict()
            except Exception:
                link_row = None
    if link_row:
        feats.update(
            link_out_degree=link_row.get("out_degree"),
            link_resolved_degree=link_row.get("resolved_degree"),
            link_is_proxy=link_row.get("is_proxy"),
            link_proxy_kind=link_row.get("proxy_kind"),
            link_delegatecall_sites=link_row.get("delegatecall_sites"),
            link_escape_density=link_row.get("escape_density"),
        )
    try:
        from mythril_tpu_torch.laser.batch import specialize as _spec

        phases = _spec.phases_for(
            _spec.signature_for(code, summary),
            fuse=_spec.fuse_profitable(code),
        )
        feats["phase_bucket_pruned"] = len(phases.pruned)
        feats["fuse_profitable"] = bool(phases.fuse_depth)
        # the FULL specialization bucket (not just its size): the JAX
        # `myth kernels bake --routing` mines these rows to prebake the
        # kernels live traffic actually dispatched (features are
        # open-ended — absent in old records reads as None)
        feats["phase_bucket"] = _phase_bucket(phases)
    except Exception:
        pass
    return feats


def _phase_bucket(phases) -> Dict:
    """The JSON-able specialization bucket of a PhaseSet (the JAX
    compile plane's `bucket_key`): None is the generic kernel."""
    if phases is None:
        return {"kind": "generic"}
    return {
        "kind": "spec",
        "pruned": sorted(phases.pruned),
        "fuse_depth": int(phases.fuse_depth),
        "block_depth": int(phases.block_depth),
    }


def outcome_for(result: Dict, prepass_stats: Optional[Dict] = None) -> Dict:
    """The outcome half of a routing record, from an analyze_corpus
    per-contract result dict (+ the corpus prepass stats when the
    device ran)."""
    if result.get("skipped"):
        route = "skipped"
    elif result.get("quarantined"):
        # a denylisted poison codehash settled FAILED at admission
        # (service quarantine) — blast-radius containment, zero
        # compute spent; the trainer must see these as their own class
        route = "quarantined"
    elif result.get("store_hit"):
        # settled at admission from the cross-run verdict store —
        # near-zero cost, the cache economics the item-5 cost model
        # must see (routes are open-ended; schema stays v2)
        route = "store-hit"
    elif result.get("static_answered"):
        route = "static-answer"
    elif result.get("store_incremental"):
        # fingerprint-diff re-analysis: only changed selectors paid
        # for compute, banked issues covered the rest
        route = "store-incremental"
    elif result.get("promoted"):
        # the cost-model router picked a tier, the tier overran its
        # predicted budget, and the job was promoted mid-flight — its
        # own outcome class so the trainer prices mis-routes
        route = "promoted-" + str(result["promoted"])
    elif result.get("routed"):
        # the cost-model router's own decision (routing/router.py):
        # recorded as routed-<tier> so the flywheel trains on its own
        # traffic (model.normalize_route folds it back onto <tier>)
        route = "routed-" + str(result["routed"])
    elif result.get("owned"):
        route = "device-owned"
    else:
        route = "host-walk"
    out: Dict = {
        "route": route,
        "wall_s": result.get("wall_s"),
        "issues": len(result.get("issues") or []),
        "states": result.get("states", 0),
        "complete": bool(result.get("complete", result.get("error") is None)),
        "error": bool(result.get("error")),
    }
    stats = prepass_stats or result.get("device_prepass") or {}
    if stats:
        out["waves"] = stats.get("waves", 0)
        out["device_sat"] = stats.get("device_sat", 0)
        out["host_sat"] = stats.get("host_sat", 0)
        out["device_steps"] = stats.get("device_steps", 0)
    return out


# ---------------------------------------------------------------------------
# the tail reader (trainer-side): version-tolerant JSONL parsing
# ---------------------------------------------------------------------------
def parse_record(line_or_obj) -> Dict:
    """One routing record from a JSONL line (or an already-decoded
    dict), normalized to the CURRENT schema: v1 records (no taint
    block) come back with every `V2_FEATURE_KEYS` column present and
    None — a trainer reads one column set across a mixed log. Raises
    ValueError on junk or a record from a FUTURE schema."""
    rec = (
        json.loads(line_or_obj)
        if isinstance(line_or_obj, (str, bytes))
        else dict(line_or_obj)
    )
    if not isinstance(rec, dict):
        raise ValueError("routing record is not an object")
    rec.setdefault("journey_id", None)  # pre-v3 records carry none
    missing = [k for k in RECORD_KEYS if k not in rec]
    if missing:
        raise ValueError(f"routing record missing keys: {missing}")
    version = int(rec["schema_version"])
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"routing record schema v{version} is newer than this "
            f"reader (v{SCHEMA_VERSION})"
        )
    features = dict(rec.get("features") or {})
    for key in V2_FEATURE_KEYS + V4_FEATURE_KEYS:
        features.setdefault(key, None)
    rec["features"] = features
    return rec


def iter_records(path: str):
    """Stream parsed records off a routing JSONL file one line at a
    time — flywheel logs grow without bound, and the
    trainer must not hold the raw text in memory to read them.
    Unparseable lines are skipped, not fatal — a half-written tail
    line must not sink the trainer."""
    with open(path) as fp:
        for line in fp:
            if not line.strip():
                continue
            try:
                yield parse_record(line)
            except ValueError:
                continue


def read_records(path: str, n: Optional[int] = None) -> List[Dict]:
    """The last `n` (default: all) records of a routing JSONL file,
    each normalized by `parse_record`. Streams the file (constant
    memory for the unbounded-`n` case is the caller's problem; with
    `n` the window is a bounded deque)."""
    if n is not None:
        return list(deque(iter_records(path), maxlen=n))
    return list(iter_records(path))


def tail_records(path: str, n: int) -> List[Dict]:
    """The last `n` records WITHOUT scanning the whole file: seek to
    the tail and read backwards in blocks until `n` parseable lines
    (plus one likely-partial head line) are in hand: a multi-GB log's
    tail reads in milliseconds with this; `read_records(path, n)` is the always-correct slow path the
    block scan falls back to semantically (same result, pinned by the
    tests)."""
    if n <= 0:
        return []
    block = 64 * 1024
    with open(path, "rb") as fp:
        fp.seek(0, os.SEEK_END)
        end = fp.tell()
        chunks: List[bytes] = []
        pos = end
        # n+1 newlines guarantee n COMPLETE lines even when the scan
        # lands mid-line at the window head
        while pos > 0 and b"".join(chunks).count(b"\n") <= n:
            step = min(block, pos)
            pos -= step
            fp.seek(pos)
            chunks.insert(0, fp.read(step))
    buf = b"".join(chunks)
    lines = buf.split(b"\n")
    if pos > 0 and lines:
        lines = lines[1:]  # drop the partial line the window cut
    out: "deque[Dict]" = deque(maxlen=n)
    for raw in lines:
        line = raw.decode("utf-8", "replace").strip()
        if not line:
            continue
        try:
            out.append(parse_record(line))
        except ValueError:
            continue
    return list(out)
