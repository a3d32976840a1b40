"""Per-contract cross-contract call facts: the link half of the
static layer.

The port's copy of the JAX package's analysis/static/callgraph.py, with the
package renamed.

Where `vsa.py` distills "which call targets are constant", this module
types EVERY outbound call site of one contract for the corpus linker
(`linkset.py`): kind (CALL/DELEGATECALL/STATICCALL/CALLCODE plus the
CREATE family), owning selector (dispatcher span attribution), the
caller's taint on the target/value/gas operands, and a **target
provenance** class from a fixed ladder:

- ``minimal-proxy`` — the whole runtime is the EIP-1167 forwarder;
  the callee address is in the code bytes themselves;
- ``constant`` — the VSA-resolved constant target also appears as a
  PUSH20 immediate (a hardcoded address literal);
- ``constructor-immutable`` — constant at the fixpoint but NOT a
  PUSH20 literal (folded/masked constants, Solidity immutables);
- ``proxy-slot`` — non-constant, not attacker-steered, and the
  contract reads a recognized implementation slot (EIP-1967 /
  OpenZeppelin zeppelinos / Gnosis masterCopy) before the site;
- ``storage-slot`` — non-constant, not attacker-steered, some other
  constant storage slot is read (a registry-held address);
- ``tainted`` — the target carries the ATTACKER bit;
- ``unresolved`` — everything else.

The ladder over-approximates downward: a site classified
``proxy-slot`` may in truth read an unrelated slot (the per-site
taint mask cannot name WHICH slot fed the target) — consumers that
need certainty (the linked-fingerprint planner) treat only edges the
LinkSet actually bound to a callee codehash as resolved.

Proxy-slot **bindings** come from the same runtime code: a constant
SSTORE of a constant value into a recognized proxy slot binds that
slot to an implementation address (the "reset/upgrade to the baked-in
implementation" shape). Deployment-time bindings ride in through
`implementation_from_init_code` — the one scanner `chainstream/
watcher.py` shares so the streaming proxy-upgrade detector and the
linker can never drift on slot constants.

Everything here is pure host work over facts `StaticSummary` already
computed (no torch, no solver), so so `lint` keeps
their sub-second budget.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static.taint import (
    TAINT_ATTACKER,
    TAINT_UNKNOWN,
)

log = logging.getLogger(__name__)

# -- shared proxy constants (the watcher reuses these verbatim) -------------
#: keccak256("eip1967.proxy.implementation") - 1
EIP1967_IMPL_SLOT = int(
    "360894a13ba1a3210667c828492db98dca3e2076cc3735a920a3ca505d382bbc", 16
)
#: keccak256("eip1967.proxy.beacon") - 1
EIP1967_BEACON_SLOT = int(
    "a3f0ad74e5423aebfd80d3ef4346578335a9a72aeaee59ff6cb3582b35133d50", 16
)
#: keccak256("eip1967.proxy.admin") - 1
EIP1967_ADMIN_SLOT = int(
    "b53127684a568b3173ae13b9f8a6016e243e63b6e8ee1178d6a717850b5d6103", 16
)
#: keccak256("org.zeppelinos.proxy.implementation")
OZ_IMPL_SLOT = int(
    "7050c9e0f4ca769c69bd3a8ef740bc37934f8e2c036e5a723fd8ee048ed3f8c3", 16
)
#: Gnosis Safe masterCopy — storage slot 0 (only meaningful when a
#: DELEGATECALL reads it; slot 0 alone is far too common to name)
GNOSIS_MASTERCOPY_SLOT = 0

#: slot -> human name, the IMPLEMENTATION-bearing slots (admin/beacon
#: slots are recognized for classification but never hold callee code)
PROXY_IMPL_SLOTS: Dict[int, str] = {
    EIP1967_IMPL_SLOT: "eip1967.implementation",
    OZ_IMPL_SLOT: "zeppelinos.implementation",
}
PROXY_SLOTS: Dict[int, str] = dict(PROXY_IMPL_SLOTS)
PROXY_SLOTS[EIP1967_BEACON_SLOT] = "eip1967.beacon"
PROXY_SLOTS[EIP1967_ADMIN_SLOT] = "eip1967.admin"

#: upgradeTo(address) / upgradeToAndCall(address,bytes) — the
#: transparent-proxy admin surface the watcher matches on calldata
UPGRADE_SELECTORS: Dict[str, str] = {
    "0x3659cfe6": "upgradeTo",
    "0x4f1ef286": "upgradeToAndCall",
}

#: EIP-1167 minimal proxy runtime: prefix + 20 address bytes + suffix
MINIMAL_PROXY_PREFIX = bytes.fromhex("363d3d373d3d3d363d73")
MINIMAL_PROXY_SUFFIX = bytes.fromhex("5af43d82803e903d91602b57fd5bf3")
#: pc of the DELEGATECALL (0xf4) inside the 45-byte runtime
MINIMAL_PROXY_CALL_PC = len(MINIMAL_PROXY_PREFIX) + 20 + 1

ADDRESS_MASK = (1 << 160) - 1

# -- provenance ladder ------------------------------------------------------
PROV_MINIMAL_PROXY = "minimal-proxy"
PROV_CONSTANT = "constant"
PROV_IMMUTABLE = "constructor-immutable"
PROV_PROXY_SLOT = "proxy-slot"
PROV_STORAGE_SLOT = "storage-slot"
PROV_TAINTED = "tainted"
PROV_UNRESOLVED = "unresolved"

#: provenances whose target ADDRESS is statically known or slot-bound
ADDRESSABLE_PROVENANCE = frozenset(
    [PROV_MINIMAL_PROXY, PROV_CONSTANT, PROV_IMMUTABLE, PROV_PROXY_SLOT]
)

#: the cross-contract lint checks this layer adds (summary.py folds
#: them into LINT_CHECKS; `proxy-storage-collision` needs the pair and
#: fires from LinkSet findings, the rest are single-contract)
LINK_CHECKS = frozenset(
    [
        "delegatecall-to-upgradeable-target",
        "proxy-storage-collision",
        "tainted-cross-contract-call-arg",
        "untrusted-return-data-in-guard",
    ]
)

_CALL_KINDS = ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL")
_CREATE_KINDS = ("CREATE", "CREATE2")


def minimal_proxy_target(code: bytes) -> Optional[int]:
    """The implementation address when `code` is exactly the EIP-1167
    minimal-proxy runtime, else None."""
    if (
        len(code)
        == len(MINIMAL_PROXY_PREFIX) + 20 + len(MINIMAL_PROXY_SUFFIX)
        and code.startswith(MINIMAL_PROXY_PREFIX)
        and code.endswith(MINIMAL_PROXY_SUFFIX)
    ):
        return int.from_bytes(
            code[len(MINIMAL_PROXY_PREFIX) : len(MINIMAL_PROXY_PREFIX) + 20],
            "big",
        )
    return None


def _push_sweep(code: bytes):
    """(pc, width, immediate int) for every PUSH in a linear sweep."""
    pc = 0
    n = len(code)
    while pc < n:
        op = code[pc]
        if 0x60 <= op <= 0x7F:
            width = op - 0x60 + 1
            arg = code[pc + 1 : pc + 1 + width]
            yield pc, width, int.from_bytes(arg, "big")
            pc += 1 + width
        else:
            pc += 1


def implementation_from_init_code(init_code) -> Optional[int]:
    """The initial implementation address a deployment's init code
    stores into a NAMED proxy slot (EIP-1967 / zeppelinos): the
    ``PUSH20 impl; PUSH32 slot; SSTORE`` constructor shape, linear
    sweep, no CFG. This is the detector `chainstream/watcher.py` layers
    beside its upgradeTo-selector match — both read the slot constants
    above, so the two detectors cannot drift. Slot 0 (Gnosis) is
    deliberately NOT matched here: an SSTORE to slot 0 in init code is
    far too common to call a proxy wiring."""
    if isinstance(init_code, str):
        init_code = init_code[2:] if init_code.startswith("0x") else init_code
        try:
            init_code = bytes.fromhex(init_code)
        except ValueError:
            return None
    if not init_code:
        return None
    last_addr: Optional[int] = None
    pending_slot = False
    for pc, width, arg in _push_sweep(init_code):
        if width == 20:
            last_addr = arg
            pending_slot = False
        elif width == 32 and arg in PROXY_IMPL_SLOTS:
            pending_slot = True
        elif pending_slot and last_addr is not None:
            # any op between the slot push and SSTORE other than the
            # address push resets nothing — the sweep only needs the
            # slot push to FOLLOW the address push (constructor shape)
            return last_addr & ADDRESS_MASK
    if pending_slot and last_addr is not None:
        # slot push was the last push before the (non-push) SSTORE tail
        return last_addr & ADDRESS_MASK
    return None


class CallSite:
    """One typed outbound call/create site of one contract."""

    __slots__ = (
        "pc",
        "kind",
        "provenance",
        "target_address",
        "slot",
        "target_taint",
        "value_taint",
        "gas_taint",
        "args_attacker",
        "selector",
    )

    def __init__(
        self,
        pc: int,
        kind: str,
        provenance: str,
        target_address: Optional[int] = None,
        slot: Optional[int] = None,
        target_taint: int = 0,
        value_taint: int = 0,
        gas_taint: int = 0,
        args_attacker: bool = False,
        selector: Optional[str] = None,
    ) -> None:
        self.pc = pc
        self.kind = kind
        self.provenance = provenance
        self.target_address = target_address
        self.slot = slot
        self.target_taint = target_taint
        self.value_taint = value_taint
        self.gas_taint = gas_taint
        #: the call's input memory carries attacker bytes (calldata was
        #: copied into memory somewhere in the contract — the global
        #: memory join's documented over-approximation, refined to the
        #: CALLDATACOPY/RETURNDATACOPY feature so a contract that never
        #: copies calldata stays clean)
        self.args_attacker = args_attacker
        self.selector = selector

    def as_dict(self) -> Dict:
        out: Dict = {
            "pc": self.pc,
            "kind": self.kind,
            "provenance": self.provenance,
            "selector": self.selector,
            "target_taint": self.target_taint,
            "args_attacker": self.args_attacker,
        }
        if self.target_address is not None:
            out["target_address"] = f"0x{self.target_address:040x}"
        if self.slot is not None:
            out["slot"] = hex(self.slot)
        return out


class ContractNode:
    """One contract's link-relevant facts: typed call sites, proxy
    classification, slot bindings, and the escape-summary inputs."""

    __slots__ = (
        "code_hash",
        "code_len",
        "call_sites",
        "selectors",
        "slot_bindings",
        "proxy_kind",
        "proxy_slots_read",
        "proxy_slots_written",
        "upgrade_selectors",
        "storage_reads",
        "storage_writes",
        "guard_return_pcs",
        "minimal_proxy",
        "incomplete",
    )

    def __init__(self, code_hash: str, code_len: int) -> None:
        self.code_hash = code_hash
        self.code_len = code_len
        self.call_sites: List[CallSite] = []
        #: selector hex -> entry pc (from the dispatcher recovery)
        self.selectors: Dict[str, int] = {}
        #: proxy slot -> baked-in implementation address (constant
        #: SSTOREs of constant values into named slots)
        self.slot_bindings: Dict[int, int] = {}
        self.proxy_kind: Optional[str] = None
        self.proxy_slots_read: List[int] = []
        self.proxy_slots_written: List[int] = []
        #: upgradeTo/upgradeToAndCall selectors this dispatcher mounts
        self.upgrade_selectors: List[str] = []
        self.storage_reads: Set[int] = set()
        self.storage_writes: Set[int] = set()
        #: JUMPI pcs whose guard condition carries the memory join's
        #: ATTACKER+UNKNOWN signature after a call site (return data
        #: steering control flow — see `untrusted-return-data-in-guard`)
        self.guard_return_pcs: List[int] = []
        self.minimal_proxy = False
        #: taint fixpoint unavailable: sites may be missing — the
        #: linker must treat this node's closure as unresolved
        self.incomplete = False

    # -- derived views ---------------------------------------------------
    @property
    def is_proxy(self) -> bool:
        return self.proxy_kind is not None

    @property
    def upgradeable(self) -> bool:
        """Can the implementation binding move after deployment?"""
        return bool(self.upgrade_selectors or self.proxy_slots_written)

    @property
    def out_degree(self) -> int:
        return len(self.call_sites)

    @property
    def delegatecall_sites(self) -> List[CallSite]:
        return [
            s
            for s in self.call_sites
            if s.kind in ("DELEGATECALL", "CALLCODE")
        ]

    def sites_in_selector(self, selector: str) -> List[CallSite]:
        return [s for s in self.call_sites if s.selector == selector]

    def provenance_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for site in self.call_sites:
            out[site.provenance] = out.get(site.provenance, 0) + 1
        return out

    def as_dict(self) -> Dict:
        return {
            "code_hash": self.code_hash,
            "code_len": self.code_len,
            "out_degree": self.out_degree,
            "call_sites": [s.as_dict() for s in self.call_sites],
            "delegatecall_sites": len(self.delegatecall_sites),
            "provenance": self.provenance_counts(),
            "is_proxy": self.is_proxy,
            "proxy_kind": self.proxy_kind,
            "upgradeable": self.upgradeable,
            "minimal_proxy": self.minimal_proxy,
            "slot_bindings": {
                hex(slot): f"0x{addr:040x}"
                for slot, addr in sorted(self.slot_bindings.items())
            },
            "incomplete": self.incomplete,
        }

    # -- single-contract link findings ----------------------------------
    def findings(self) -> List[Dict]:
        """The per-contract half of the LINK_CHECKS (the pair-level
        `proxy-storage-collision` fires from LinkSet.findings())."""
        out: List[Dict] = []
        upg = [
            s
            for s in self.delegatecall_sites
            if s.provenance == PROV_PROXY_SLOT and self.upgradeable
        ]
        if upg:
            out.append(
                {
                    "check": "delegatecall-to-upgradeable-target",
                    "detail": (
                        f"{len(upg)} DELEGATECALL(s) through a proxy "
                        "implementation slot that this contract can "
                        "rewrite (upgrade selector or direct slot "
                        "store) — the code behind the call can change "
                        "after any audit of it"
                    ),
                    "addresses": sorted(s.pc for s in upg)[:16],
                }
            )
        tainted_args = [
            s
            for s in self.call_sites
            if s.kind in _CALL_KINDS
            and s.args_attacker
            # tainted targets already fire tainted-delegatecall-target
            # territory; a minimal proxy forwards calldata BY DESIGN —
            # the callee, not the forwarder, is the finding's subject
            and s.provenance not in (PROV_TAINTED, PROV_MINIMAL_PROXY)
        ]
        if tainted_args:
            out.append(
                {
                    "check": "tainted-cross-contract-call-arg",
                    "detail": (
                        f"{len(tainted_args)} outbound call(s) whose "
                        "input memory carries attacker-controlled "
                        "calldata bytes — the callee executes on "
                        "attacker-shaped arguments"
                    ),
                    "addresses": sorted(s.pc for s in tainted_args)[:16],
                }
            )
        if self.guard_return_pcs:
            out.append(
                {
                    "check": "untrusted-return-data-in-guard",
                    "detail": (
                        f"{len(self.guard_return_pcs)} branch guard(s) "
                        "after an external call read memory the callee "
                        "may have written — control flow keyed on "
                        "unvalidated return data"
                    ),
                    "addresses": sorted(self.guard_return_pcs)[:16],
                }
            )
        return out


def _selector_for_pc(
    spans: Dict[str, List[Tuple[int, int]]], pc: int
) -> Optional[str]:
    owners = [
        sel
        for sel, rows in spans.items()
        if any(start <= pc <= end for start, end in rows)
    ]
    return owners[0] if len(owners) == 1 else None


def link_node(code: bytes, summary) -> ContractNode:
    """Build one contract's ContractNode from its StaticSummary (the
    taint/VSA facts are read, never recomputed)."""
    node = ContractNode(summary.code_hash, len(code))

    # whole-code EIP-1167 match first: the forwarder has no dispatcher
    # and needs no taint facts — the callee is in the bytes
    target = minimal_proxy_target(code)
    if target is not None:
        node.minimal_proxy = True
        node.proxy_kind = "eip1167"
        node.call_sites.append(
            CallSite(
                pc=MINIMAL_PROXY_CALL_PC,
                kind="DELEGATECALL",
                provenance=PROV_MINIMAL_PROXY,
                target_address=target,
                args_attacker=True,  # forwards the raw calldata
            )
        )
        _record_node(node)
        return node

    taint = getattr(summary, "taint", None)
    if taint is None or taint.incomplete:
        node.incomplete = True
        _record_node(node)
        return node

    spans = summary.selector_subgraphs()
    node.selectors = {
        "0x" + entry.selector.hex(): entry.entry_pc
        for entry in summary.dispatcher
    }
    node.upgrade_selectors = sorted(
        sel for sel in node.selectors if sel in UPGRADE_SELECTORS
    )
    node.storage_reads = set(summary.vsa.constant_storage_reads)
    node.storage_writes = set(summary.vsa.constant_storage_writes)

    push20 = {
        arg & ADDRESS_MASK
        for _pc, width, arg in _push_sweep(code)
        if width == 20
    }
    mem_attacker = bool(
        {"CALLDATACOPY", "RETURNDATACOPY"} & set(summary.features)
    )

    # named-slot reads, per pc (the proxy-slot rung's evidence)
    named_reads: Dict[int, int] = {}
    for pc, slot in taint.sload_slots.items():
        if slot[0] is not None and slot[0] in PROXY_SLOTS:
            named_reads[pc] = slot[0]
    slot0_read_pcs = [
        pc
        for pc, slot in taint.sload_slots.items()
        if slot[0] == GNOSIS_MASTERCOPY_SLOT
    ]

    # slot bindings: constant value stored into a named impl slot
    for pc, slot in taint.sstore_slots.items():
        if slot[0] is None:
            continue
        if slot[0] in PROXY_SLOTS:
            node.proxy_slots_written.append(slot[0])
        if slot[0] in PROXY_IMPL_SLOTS:
            value = taint.sstore_values.get(pc)
            if value is not None and value[0] is not None:
                node.slot_bindings[slot[0]] = value[0] & ADDRESS_MASK
    node.proxy_slots_written = sorted(set(node.proxy_slots_written))
    node.proxy_slots_read = sorted(
        {slot for slot in named_reads.values()}
    )

    # every constant-slot SLOAD, per pc (the storage-slot rung names
    # the nearest one before the site, same rule as the proxy rung)
    const_reads: Dict[int, int] = {
        pc: slot[0]
        for pc, slot in taint.sload_slots.items()
        if slot[0] is not None and slot[0] not in PROXY_SLOTS
    }
    other_const_reads = node.storage_reads - set(PROXY_SLOTS)

    for pc, site in sorted(taint.call_sites.items()):
        kind = site["kind"]
        tgt = site["target"]
        value = site.get("value")
        sel = _selector_for_pc(spans, pc)
        provenance = PROV_UNRESOLVED
        address: Optional[int] = None
        slot: Optional[int] = None
        if tgt[0] is not None:
            address = tgt[0] & ADDRESS_MASK
            provenance = (
                PROV_CONSTANT if address in push20 else PROV_IMMUTABLE
            )
        elif tgt[1] & TAINT_ATTACKER:
            provenance = PROV_TAINTED
        elif named_reads and any(p < pc for p in named_reads):
            provenance = PROV_PROXY_SLOT
            # the nearest named-slot read before the site names the slot
            slot = named_reads[
                max(p for p in named_reads if p < pc)
            ]
            address = node.slot_bindings.get(slot)
        elif (
            kind in ("DELEGATECALL", "CALLCODE")
            and slot0_read_pcs
            and any(p < pc for p in slot0_read_pcs)
        ):
            provenance = PROV_PROXY_SLOT
            slot = GNOSIS_MASTERCOPY_SLOT
        elif other_const_reads:
            provenance = PROV_STORAGE_SLOT
            before = [p for p in const_reads if p < pc]
            if before:
                slot = const_reads[max(before)]
        node.call_sites.append(
            CallSite(
                pc=pc,
                kind=kind,
                provenance=provenance,
                target_address=address,
                slot=slot,
                target_taint=tgt[1],
                value_taint=value[1] if value is not None else 0,
                gas_taint=site["gas"][1],
                args_attacker=mem_attacker,
                selector=sel,
            )
        )

    # CREATE/CREATE2 sites: the taint pass records no call-site row for
    # them (the created code is the operand, not an address), so they
    # come from the reachable instruction stream — always unresolved
    # (the child's codehash does not exist before the call runs)
    reachable = getattr(taint, "reachable", set())
    for start in reachable:
        block = summary.cfg.blocks.get(start)
        if block is None:
            continue
        for ins in block.instructions:
            if ins.opcode in _CREATE_KINDS:
                node.call_sites.append(
                    CallSite(
                        pc=ins.address,
                        kind=ins.opcode,
                        provenance=PROV_UNRESOLVED,
                        args_attacker=mem_attacker,
                        selector=_selector_for_pc(spans, ins.address),
                    )
                )
    node.call_sites.sort(key=lambda s: s.pc)

    # proxy classification from the DELEGATECALL sites' slots
    for site in node.delegatecall_sites:
        if site.provenance != PROV_PROXY_SLOT:
            continue
        if site.slot in (EIP1967_IMPL_SLOT, EIP1967_BEACON_SLOT):
            node.proxy_kind = "eip1967"
        elif site.slot == OZ_IMPL_SLOT:
            node.proxy_kind = node.proxy_kind or "zeppelinos"
        elif site.slot == GNOSIS_MASTERCOPY_SLOT:
            node.proxy_kind = node.proxy_kind or "gnosis"

    # return-data-in-guard: a JUMPI after the first call site whose
    # condition carries BOTH the ATTACKER and UNKNOWN bits — the
    # signature of a value read back through the memory join (a pure
    # calldata guard carries ATTACKER alone, a pure storage guard
    # UNKNOWN alone); documented over-approximation
    if taint.call_sites:
        first_call = min(taint.call_sites)
        node.guard_return_pcs = sorted(
            pc
            for pc, cond in taint.jumpi_conditions.items()
            if pc > first_call
            and cond[1] & TAINT_ATTACKER
            and cond[1] & TAINT_UNKNOWN
        )

    _record_node(node)
    return node


# ---------------------------------------------------------------------------
# /stats + registry counters (`static.link.*`, `mtpu_static_link_*`)
# ---------------------------------------------------------------------------
_COUNTS_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {
    "nodes": 0,
    "call_sites": 0,
    "resolved_sites": 0,
    "proxies": 0,
    "minimal_proxies": 0,
    "escape_widened": 0,
    "pairs": 0,
    "collisions": 0,
}


def _bump(key: str, n: int = 1) -> None:
    if not n:
        return
    with _COUNTS_LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + n


def _record_node(node: ContractNode) -> None:
    _bump("nodes")
    _bump("call_sites", len(node.call_sites))
    _bump(
        "resolved_sites",
        sum(
            1
            for s in node.call_sites
            if s.provenance in ADDRESSABLE_PROVENANCE
        ),
    )
    if node.is_proxy:
        _bump("proxies")
    if node.minimal_proxy:
        _bump("minimal_proxies")


def link_stat_counts() -> Dict[str, int]:
    """The `/stats` ``static.link.*`` block (process-lifetime)."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_link_counts() -> None:
    with _COUNTS_LOCK:
        for key in _COUNTS:
            _COUNTS[key] = 0
