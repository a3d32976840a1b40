"""LinkSet: the corpus-level cross-contract static linker.

The port's copy of the JAX package's analysis/static/linkset.py, with the
package renamed.

Joins the per-contract `callgraph.ContractNode` facts into one typed
inter-contract graph:

- **nodes** are codehashes (per-selector sub-facts ride on each node's
  dispatcher attribution);
- **edges** are the typed call sites, resolved to a callee codehash
  through the **address book** — deployment addresses declared by
  corpus row names (``name@0x<40 hex>``), constant/immutable targets,
  minimal-proxy literals, runtime slot bindings, and init-code
  bindings (`implementation_from_init_code`).

On top of the resolved graph:

- **escape summaries** — per (contract, selector): which provenance
  bits can flow OUT into callee calldata, computed bottom-up over the
  Tarjan SCC condensation (callees first). Cycles and unresolved
  edges widen to TAINT_ANY — convergent by construction, monotone by
  the 4-bit mask.
- **proxy pairing + storage-collision diff** — each proxy-slot /
  minimal-proxy DELEGATECALL bound to a callee pairs the two
  contracts; the pair's constant storage footprints (minus the named
  proxy slots) are intersected for collision risk.
- **linked fingerprints** — per selector,
  ``H(base fingerprint | sorted resolved callee-closure codehashes)``:
  the store's incremental planner diffs these so an implementation
  upgrade behind an unchanged proxy invalidates exactly the selectors
  whose callee closure moved. Selectors whose closure crosses an
  unresolved edge or a cycle get a named problem (``link-unresolved``
  / ``link-cycle``) instead of a fingerprint.
- **arena co-location plan** — per entry contract, the resolved
  callee codehash closure: the exact artifact the device engine's
  multi-account arena work pre-loads before dispatch.

Pure host work over already-computed summaries (no torch, no device),
so `python -m mythril_tpu_torch graph` stays a sub-second line-rate
tool.
"""

from __future__ import annotations

import hashlib
import logging
import re
import time
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static.callgraph import (
    ADDRESSABLE_PROVENANCE,
    ContractNode,
    PROV_MINIMAL_PROXY,
    PROV_PROXY_SLOT,
    PROXY_SLOTS,
    _bump,
    implementation_from_init_code,
    link_node,
)

log = logging.getLogger(__name__)

#: `graph --json` / jsonv2 link-meta payload version
GRAPH_SCHEMA_VERSION = 1

#: call sites not inside exactly one selector's spans attribute to
#: this pseudo-selector: they ride every selector's closure (shared /
#: dispatcher / fallback code runs for any selector)
SHARED_SELECTOR = "*"

_NAME_ADDR = re.compile(r"@0x([0-9a-fA-F]{40})")


def address_from_name(name: str) -> Optional[int]:
    """The deployment address a corpus row/file name declares
    (``anything@0x<40 hex>``, the part after ``@`` wins), or None."""
    match = _NAME_ADDR.search(name or "")
    return int(match.group(1), 16) if match else None


class LinkSet:
    """The multi-contract container + resolution passes."""

    def __init__(self) -> None:
        #: code_hash -> ContractNode
        self.nodes: Dict[str, ContractNode] = {}
        #: code_hash -> first row name seen (the graph's display key)
        self.names: Dict[str, str] = {}
        #: deployment address -> code_hash (last add wins: an upgrade
        #: is "same address, new code" — exactly the invalidation the
        #: linked fingerprints exist to catch)
        self.book: Dict[int, str] = {}
        #: code_hash -> selector -> base function fingerprint
        self.base_fps: Dict[str, Dict[str, str]] = {}
        #: code_hash -> init-code implementation binding
        self.init_bindings: Dict[str, int] = {}
        self._resolved: Optional[Dict] = None

    # -- construction ---------------------------------------------------
    def add(
        self,
        name: str,
        code: bytes,
        summary,
        address: Optional[int] = None,
        init_code=None,
    ) -> ContractNode:
        """Register one contract. `address` overrides the name-declared
        deployment address; `init_code` (hex or bytes) feeds the
        init-code implementation binding."""
        node = getattr(summary, "link", None)
        if node is None:
            node = link_node(code, summary)
        self._resolved = None
        self.nodes[node.code_hash] = node
        self.names.setdefault(node.code_hash, name)
        addr = address if address is not None else address_from_name(name)
        if addr is not None:
            self.book[addr] = node.code_hash
        self.base_fps[node.code_hash] = dict(
            getattr(summary, "function_fingerprints", {}) or {}
        )
        if init_code:
            impl = implementation_from_init_code(init_code)
            if impl is not None:
                self.init_bindings[node.code_hash] = impl
        return node

    # -- resolution -----------------------------------------------------
    def resolve(self) -> Dict:
        """Run (or return the cached) resolution: edges, SCCs, escape
        fixpoint, proxy pairs, collisions, linked fingerprints."""
        if self._resolved is not None:
            return self._resolved
        t0 = time.perf_counter()
        edges: List[Dict] = []
        adjacency: Dict[str, Set[str]] = {ch: set() for ch in self.nodes}
        for ch, node in self.nodes.items():
            for site in node.call_sites:
                address = site.target_address
                if (
                    address is None
                    and site.provenance == PROV_PROXY_SLOT
                ):
                    address = self.init_bindings.get(ch)
                callee = (
                    self.book.get(address) if address is not None else None
                )
                edge = {
                    "caller": ch,
                    "pc": site.pc,
                    "kind": site.kind,
                    "selector": site.selector or SHARED_SELECTOR,
                    "provenance": site.provenance,
                    "target_address": (
                        f"0x{address:040x}" if address is not None else None
                    ),
                    "callee": callee,
                    "resolved": callee is not None,
                }
                edges.append(edge)
                if callee is not None:
                    adjacency[ch].add(callee)
                    if callee not in adjacency:
                        adjacency[callee] = set()

        sccs = _tarjan(adjacency)
        cyclic: Set[str] = set()
        for members in sccs:
            if len(members) > 1:
                cyclic.update(members)
        for ch in adjacency:
            if ch in adjacency[ch]:  # self-loop: A resolves to itself
                cyclic.add(ch)

        escapes, widened = self._escape_fixpoint(edges, sccs, cyclic)
        pairs, collisions = self._pair_proxies(edges)
        linked_fps, link_problems = self._linked_fingerprints(
            edges, adjacency, cyclic
        )
        _bump("escape_widened", widened)
        _bump("pairs", len(pairs))
        _bump("collisions", len(collisions))

        resolved_edges = sum(1 for e in edges if e["resolved"])
        addressable = sum(
            1
            for e in edges
            if e["provenance"] in ADDRESSABLE_PROVENANCE
        )
        self._resolved = {
            "edges": edges,
            "adjacency": adjacency,
            "cyclic": cyclic,
            "escapes": escapes,
            "widened": widened,
            "pairs": pairs,
            "collisions": collisions,
            "linked_fingerprints": linked_fps,
            "link_problems": link_problems,
            "stats": {
                "nodes": len(self.nodes),
                "edges": len(edges),
                "edges_resolved": resolved_edges,
                "edges_addressable": addressable,
                "resolve_rate": (
                    round(resolved_edges / len(edges), 4) if edges else 1.0
                ),
                "proxies": sum(
                    1 for n in self.nodes.values() if n.is_proxy
                ),
                "proxy_pairs": len(pairs),
                "collisions": len(collisions),
                "escape_widened": widened,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
            },
        }
        return self._resolved

    def _escape_fixpoint(
        self, edges: List[Dict], sccs: List[List[str]], cyclic: Set[str]
    ) -> Tuple[Dict[str, Dict[str, Dict]], int]:
        """Bottom-up escape summaries. Tarjan emits each SCC after
        every SCC reachable from it, so walking the SCC list in
        emission order processes callees before callers — one pass IS
        the fixpoint on the acyclic condensation; cyclic members and
        unresolved edges widen to TAINT_ANY."""
        from mythril_tpu_torch.analysis.static.taint import (
            TAINT_ANY,
            TAINT_ATTACKER,
            TAINT_UNKNOWN,
        )

        by_caller: Dict[str, List[Dict]] = {}
        for edge in edges:
            by_caller.setdefault(edge["caller"], []).append(edge)
        escapes: Dict[str, Dict[str, Dict]] = {}
        totals: Dict[str, int] = {}
        widened = 0
        for members in sccs:
            for ch in members:
                node = self.nodes.get(ch)
                if node is None:
                    totals.setdefault(ch, 0)
                    continue
                selectors = set(node.selectors) or set()
                per_sel: Dict[str, Dict] = {}
                shared_sites = []
                sel_sites: Dict[str, List[Dict]] = {}
                for edge in by_caller.get(ch, []):
                    if edge["selector"] == SHARED_SELECTOR:
                        shared_sites.append(edge)
                    else:
                        sel_sites.setdefault(edge["selector"], []).append(
                            edge
                        )
                        selectors.add(edge["selector"])
                if shared_sites and not selectors:
                    selectors = {SHARED_SELECTOR}
                for sel in sorted(selectors):
                    mask = 0
                    wide = False
                    sites = sel_sites.get(sel, []) + (
                        shared_sites if sel != SHARED_SELECTOR else []
                    )
                    if sel == SHARED_SELECTOR:
                        sites = list(shared_sites)
                    for edge in sites:
                        if node.incomplete or ch in cyclic:
                            mask = TAINT_ANY
                            wide = True
                            break
                        site_mask = (
                            TAINT_ATTACKER
                            if _edge_args_attacker(node, edge)
                            else TAINT_UNKNOWN
                        )
                        if edge["resolved"]:
                            mask |= site_mask | totals.get(
                                edge["callee"], 0
                            )
                        else:
                            mask = TAINT_ANY
                            wide = True
                            break
                    per_sel[sel] = {"mask": mask, "widened": wide}
                    if wide:
                        widened += 1
                if node.guard_return_pcs:
                    for sel in per_sel.values():
                        sel.setdefault("return_to_guard", True)
                escapes[ch] = per_sel
                totals[ch] = 0
                for row in per_sel.values():
                    totals[ch] |= row["mask"]
        return escapes, widened

    def _pair_proxies(
        self, edges: List[Dict]
    ) -> Tuple[List[Dict], List[Dict]]:
        pairs: List[Dict] = []
        collisions: List[Dict] = []
        seen: Set[Tuple[str, str]] = set()
        for edge in edges:
            if edge["kind"] not in ("DELEGATECALL", "CALLCODE"):
                continue
            if edge["provenance"] not in (
                PROV_PROXY_SLOT,
                PROV_MINIMAL_PROXY,
            ):
                continue
            if not edge["resolved"]:
                continue
            proxy_ch, impl_ch = edge["caller"], edge["callee"]
            if (proxy_ch, impl_ch) in seen:
                continue
            seen.add((proxy_ch, impl_ch))
            proxy = self.nodes[proxy_ch]
            impl = self.nodes.get(impl_ch)
            pair = {
                "proxy": proxy_ch,
                "implementation": impl_ch,
                "kind": proxy.proxy_kind or edge["provenance"],
                "upgradeable": proxy.upgradeable,
            }
            pairs.append(pair)
            if impl is None:
                continue
            # storage-collision diff: the proxy's own constant slots
            # (minus the named proxy slots, which are CHOSEN to never
            # collide) against the implementation's written slots —
            # under DELEGATECALL both address the same storage
            proxy_slots = (
                proxy.storage_reads | proxy.storage_writes
            ) - set(PROXY_SLOTS)
            impl_writes = impl.storage_writes - set(PROXY_SLOTS)
            shared = sorted(proxy_slots & impl_writes)
            if shared:
                collisions.append(
                    {
                        "proxy": proxy_ch,
                        "implementation": impl_ch,
                        "slots": [hex(s) for s in shared],
                    }
                )
        return pairs, collisions

    def _linked_fingerprints(
        self,
        edges: List[Dict],
        adjacency: Dict[str, Set[str]],
        cyclic: Set[str],
    ) -> Tuple[Dict[str, Dict[str, str]], Dict[str, Dict[str, str]]]:
        """code_hash -> selector -> linked fingerprint, plus
        code_hash -> selector -> problem ("link-unresolved" /
        "link-cycle") for selectors whose callee closure cannot be
        pinned. A selector with NO call sites still gets a linked
        fingerprint (= H(base | empty)), so the store's linked entry
        always carries the full selector set."""
        by_caller_sel: Dict[str, Dict[str, List[Dict]]] = {}
        unresolved_callers: Set[str] = set()
        for edge in edges:
            by_caller_sel.setdefault(edge["caller"], {}).setdefault(
                edge["selector"], []
            ).append(edge)
            if not edge["resolved"]:
                unresolved_callers.add(edge["caller"])
        fps: Dict[str, Dict[str, str]] = {}
        problems: Dict[str, Dict[str, str]] = {}
        for ch, base in self.base_fps.items():
            node = self.nodes.get(ch)
            per_sel = by_caller_sel.get(ch, {})
            shared = per_sel.get(SHARED_SELECTOR, [])
            out: Dict[str, str] = {}
            bad: Dict[str, str] = {}
            for sel, base_fp in base.items():
                sites = per_sel.get(sel, []) + shared
                problem = None
                closure: Set[str] = set()
                if node is not None and node.incomplete:
                    problem = "link-unresolved"
                for edge in sites:
                    if problem:
                        break
                    if not edge["resolved"]:
                        problem = "link-unresolved"
                        break
                    closure.add(edge["callee"])
                if problem is None and closure:
                    problem, closure = self._closure(
                        ch, closure, adjacency, cyclic, unresolved_callers
                    )
                if problem:
                    bad[sel] = problem
                    continue
                digest = hashlib.sha256(
                    (base_fp + "|" + ",".join(sorted(closure))).encode()
                ).hexdigest()[:16]
                out[sel] = digest
            fps[ch] = out
            if bad:
                problems[ch] = bad
        return fps, problems

    def _closure(
        self,
        origin: str,
        roots: Set[str],
        adjacency: Dict[str, Set[str]],
        cyclic: Set[str],
        unresolved_callers: Set[str],
    ) -> Tuple[Optional[str], Set[str]]:
        """Transitive resolved-callee closure from `roots`, or a
        problem name. Any member with an unresolved or incomplete
        site taints the whole closure (the codehash set alone no
        longer pins behavior); reaching back to `origin` or any
        cyclic member is a cycle."""
        seen: Set[str] = set()
        work = list(roots)
        while work:
            ch = work.pop()
            if ch in seen:
                continue
            seen.add(ch)
            if ch == origin or ch in cyclic:
                return "link-cycle", set()
            node = self.nodes.get(ch)
            if node is None or node.incomplete:
                return "link-unresolved", set()
            if ch in unresolved_callers:
                return "link-unresolved", set()
            work.extend(adjacency.get(ch, ()))
        return None, seen

    # -- consumer surfaces ----------------------------------------------
    def linked_fingerprints(
        self, code_hash: str
    ) -> Tuple[Dict[str, str], Dict[str, str]]:
        """(selector -> linked fingerprint, selector -> problem) for
        one contract."""
        data = self.resolve()
        return (
            dict(data["linked_fingerprints"].get(code_hash, {})),
            dict(data["link_problems"].get(code_hash, {})),
        )

    def node_meta(self, code_hash: str) -> Optional[Dict]:
        """The compact per-contract link block (jsonv2 meta / routing
        features / triage alerts)."""
        node = self.nodes.get(code_hash)
        if node is None:
            return None
        data = self.resolve()
        out_edges = [
            e for e in data["edges"] if e["caller"] == code_hash
        ]
        escapes = data["escapes"].get(code_hash, {})
        n_sel = max(1, len(escapes) or len(node.selectors) or 1)
        density = round(
            sum(
                1
                for row in escapes.values()
                if row["mask"]
            )
            / n_sel,
            4,
        )
        meta = dict(node.as_dict())
        meta.update(
            {
                "resolved_degree": sum(
                    1 for e in out_edges if e["resolved"]
                ),
                "escape_density": density,
                "escape_widened": sum(
                    1 for row in escapes.values() if row.get("widened")
                ),
                "in_pair": any(
                    code_hash in (p["proxy"], p["implementation"])
                    for p in data["pairs"]
                ),
            }
        )
        return meta

    def arena_plan(self) -> Dict[str, List[str]]:
        """Entry codehash -> sorted resolved callee-codehash closure
        (the multi-account arena's co-location artifact). Entries with
        no resolved callees map to an empty list."""
        data = self.resolve()
        adjacency = data["adjacency"]
        plan: Dict[str, List[str]] = {}
        for ch in self.nodes:
            seen: Set[str] = set()
            work = list(adjacency.get(ch, ()))
            while work:
                nxt = work.pop()
                if nxt in seen or nxt == ch:
                    continue
                seen.add(nxt)
                work.extend(adjacency.get(nxt, ()))
            plan[ch] = sorted(seen)
        return plan

    def findings(self) -> List[Dict]:
        """Corpus-level link findings: every node's single-contract
        checks (tagged with the row name) plus the pair-level
        `proxy-storage-collision` rows."""
        data = self.resolve()
        out: List[Dict] = []
        for ch, node in self.nodes.items():
            for row in node.findings():
                row = dict(row)
                row["contract"] = self.names.get(ch, ch)
                out.append(row)
        for collision in data["collisions"]:
            out.append(
                {
                    "check": "proxy-storage-collision",
                    "contract": self.names.get(
                        collision["proxy"], collision["proxy"]
                    ),
                    "detail": (
                        "proxy and implementation "
                        f"{self.names.get(collision['implementation'], collision['implementation'])}"
                        " both address constant storage slot(s) "
                        f"{', '.join(collision['slots'])} — under "
                        "DELEGATECALL they alias the same storage"
                    ),
                    "addresses": [
                        int(s, 16) for s in collision["slots"]
                    ][:16],
                }
            )
        return out

    def stats(self) -> Dict:
        return dict(self.resolve()["stats"])

    def as_dict(self) -> Dict:
        """The `graph --json` payload."""
        data = self.resolve()
        addr_of = {ch: None for ch in self.nodes}
        for addr, ch in self.book.items():
            addr_of[ch] = f"0x{addr:040x}"
        contracts = []
        for ch in sorted(self.nodes, key=lambda c: self.names.get(c, c)):
            node = self.nodes[ch]
            row = {
                "name": self.names.get(ch, ch),
                "address": addr_of.get(ch),
                "selectors": sorted(node.selectors),
                "link": self.node_meta(ch),
                "escape": {
                    sel: dict(rec)
                    for sel, rec in sorted(
                        data["escapes"].get(ch, {}).items()
                    )
                },
                "linked_fingerprints": dict(
                    data["linked_fingerprints"].get(ch, {})
                ),
                "link_problems": dict(
                    data["link_problems"].get(ch, {})
                ),
            }
            contracts.append(row)
        return {
            "schema_version": GRAPH_SCHEMA_VERSION,
            "contracts": contracts,
            "edges": [dict(e) for e in data["edges"]],
            "proxy_pairs": [dict(p) for p in data["pairs"]],
            "collisions": [dict(c) for c in data["collisions"]],
            "arena_plan": {
                self.names.get(ch, ch): callees
                for ch, callees in sorted(self.arena_plan().items())
            },
            "findings": self.findings(),
            "stats": self.stats(),
        }


def _edge_args_attacker(node: ContractNode, edge: Dict) -> bool:
    for site in node.call_sites:
        if site.pc == edge["pc"]:
            return site.args_attacker
    return False


def _tarjan(adjacency: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC. Emission order: every SCC is emitted
    AFTER all SCCs reachable from it (reverse topological order of
    the condensation) — the order the escape fixpoint wants."""
    index: Dict[str, int] = {}
    lowlink: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in sorted(adjacency):
        if root in index:
            continue
        work: List[Tuple[str, iter]] = [(root, iter(sorted(adjacency[root])))]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in adjacency:
                    continue
                if succ not in index:
                    index[succ] = lowlink[succ] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append(
                        (succ, iter(sorted(adjacency[succ])))
                    )
                    advanced = True
                    break
                if succ in on_stack:
                    lowlink[node] = min(lowlink[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                members: List[str] = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    members.append(member)
                    if member == node:
                        break
                sccs.append(members)
    return sccs


def link_corpus(contracts) -> LinkSet:
    """Build a LinkSet from analyze_corpus's input rows
    ``[(runtime_hex, creation_hex, name), ...]``. Per-row failures
    skip that row — linking degrades coverage, never correctness."""
    from mythril_tpu_torch.analysis.static import summary_for

    linkset = LinkSet()
    for row in contracts:
        try:
            code_hex, creation_hex, name = row
        except (TypeError, ValueError):
            continue
        norm = (
            code_hex[2:] if code_hex.startswith("0x") else code_hex
        )
        if len(norm) < 8:
            continue
        try:
            summary = summary_for(norm)
            linkset.add(
                name,
                bytes.fromhex(norm),
                summary,
                init_code=creation_hex or None,
            )
        except Exception:
            log.debug("link pass skipped %s", name, exc_info=True)
    return linkset
