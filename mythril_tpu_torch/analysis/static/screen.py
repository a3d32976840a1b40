"""Detector pre-screen: opcode signatures + semantic sink predicates.

The port's copy of the JAX package's analysis/static/screen.py, with the
package renamed.

Two layers, applied in order:

1. **Opcode signatures** — each detection module can only ever fire
   if certain opcodes exist in the analyzed code (a module that
   reports unchecked CALL return values is inert on a contract with
   no CALL-family opcode). The signature is a conjunction of
   disjunctions over opcode names: the module applies iff EVERY group
   has at least one member present in the feature set. The feature
   set is the opcode names of the (conservatively) reachable
   instructions — an unresolved computed jump makes every JUMPDEST
   block reachable, and on any dataflow bail the whole instruction
   stream counts.
2. **Sink predicates** (`SINK_PREDICATES`) — for modules whose opcode
   is near-ubiquitous the signature screens almost nothing, so a
   second test runs over the taint/value-set fixpoint (taint.py /
   vsa.py): the module mounts only if its *sink* can actually carry
   the property it detects — a JUMP whose target might be symbolic,
   an SSTORE whose slot is not a provable constant, a CALL that can
   move value, an ORIGIN that reaches a branch guard. Each predicate
   mirrors the UNSAT-pruning its module performs symbolically (the
   module bodies in analysis/module/modules/ are the ground truth;
   every predicate cites the constraint it pre-evaluates). On any
   taint bail (`incomplete`) the predicate layer is skipped entirely
   and the opcode screen alone decides — the conservative fallback.

Both layers only ever err toward mounting: screening a module out is
sound — no execution of this code can make that module fire. Pinned
by the screen-soundness sweep over every module's positive fixture
(tests/analysis/test_static_taint.py).

Skipping a module buys two things per contract: its opcode hooks are
never mounted (the svm's hook dispatch runs per executed instruction)
and its POST pass never scans the statespace. When EVERY module
screens off, the static-answer triage tier (summary.py
`static_answerable`) settles the whole contract without touching the
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from mythril_tpu_torch.analysis.static.taint import TaintResult
from mythril_tpu_torch.analysis.static.vsa import (
    ATTACKER_ADDRESS,
    ValueSets,
    assertion_evidence,
)

CALL_FAMILY = ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL")

#: module class name -> conjunction of opcode-name disjunctions.
#: A module absent from this table is never screened (always loaded).
MODULE_SIGNATURES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    # jump-target hijack needs a jump
    "ArbitraryJump": (("JUMP", "JUMPI"),),
    # arbitrary storage write needs a store
    "ArbitraryStorage": (("SSTORE",),),
    "ArbitraryDelegateCall": (("DELEGATECALL",),),
    "TxOrigin": (("ORIGIN",),),
    "PredictableVariables": (
        ("BLOCKHASH", "COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER"),
    ),
    # its post hooks (ether_thief.py)
    "EtherThief": (("CALL", "STATICCALL"),),
    "Exceptions": (("ASSERT_FAIL",),),
    "ExternalCalls": (("CALL",),),
    "IntegerArithmetics": (("ADD", "SUB", "MUL", "EXP"),),
    "MultipleSends": (CALL_FAMILY,),
    # needs an external call AND a state access after it
    "StateChangeAfterCall": (
        ("CALL", "DELEGATECALL", "CALLCODE"),
        ("SSTORE", "SLOAD", "CREATE", "CREATE2"),
    ),
    "AccidentallyKillable": (("SUICIDE",),),
    "UncheckedRetval": (CALL_FAMILY,),
    # solc assertion markers ride LOG1 (event) or MSTORE (panic word);
    # MSTORE is near-ubiquitous so this layer alone screens almost
    # nothing — the real screen is the semantic predicate below
    # (LOG1-topic / marker-word evidence)
    "UserAssertions": (("LOG1", "MSTORE"),),
}

# ---------------------------------------------------------------------------
# the semantic layer: per-module sink predicates
# ---------------------------------------------------------------------------
#: arbitrary_write.SENTINEL_SLOT — a constant slot can only satisfy
#: `slot == sentinel` if it IS the sentinel
_SENTINEL_SLOT = 324345425435
#: external_calls pins UGT(gas, 2300)
_GAS_STIPEND = 2300


def _nonconst(value) -> bool:
    return value is None or value[0] is None


def _sink_arbitrary_jump(t: TaintResult, v: ValueSets) -> bool:
    # arbitrary_jump fires iff stack[-1].symbolic at JUMP/JUMPI; a
    # provable constant is never symbolic
    return any(_nonconst(val) for val in t.jump_targets.values())


def _sink_arbitrary_storage(t: TaintResult, v: ValueSets) -> bool:
    # arbitrary_write adds `slot == SENTINEL_SLOT`: UNSAT for every
    # constant slot that is not the sentinel itself
    return any(
        _nonconst(slot) or slot[0] == _SENTINEL_SLOT
        for slot in t.sstore_slots.values()
    )


def _sink_delegatecall(t: TaintResult, v: ValueSets) -> bool:
    # delegatecall pins `target == ACTORS.attacker`
    return any(
        site["kind"] == "DELEGATECALL"
        and (
            _nonconst(site["target"])
            or site["target"][0] == ATTACKER_ADDRESS
        )
        for site in t.call_sites.values()
    )


def _sink_ether_thief(t: TaintResult, v: ValueSets) -> bool:
    # ether_thief needs the attacker's balance to GROW before its
    # CALL/STATICCALL post-hook observes it: a CALL moving nonzero
    # value does that (STATICCALL never carries value; a constant-zero
    # value moves nothing) — and so does SELFDESTRUCT in an earlier
    # transaction (vm/flow.py credits the heir's balance), so any
    # reachable SUICIDE keeps the module too
    if t.selfdestruct_sites:
        return True
    return any(
        site["kind"] == "CALL"
        and (_nonconst(site["value"]) or site["value"][0] > 0)
        for site in t.call_sites.values()
    )


def _sink_external_calls(t: TaintResult, v: ValueSets) -> bool:
    # external_calls pins `target == attacker AND UGT(gas, 2300)`
    return any(
        site["kind"] == "CALL"
        and (
            _nonconst(site["target"])
            or site["target"][0] == ATTACKER_ADDRESS
        )
        and (_nonconst(site["gas"]) or site["gas"][0] > _GAS_STIPEND)
        for site in t.call_sites.values()
    )


def _sink_integer(t: TaintResult, v: ValueSets) -> bool:
    # integer.py annotates ADD/SUB/MUL/EXP whose wrap condition is
    # satisfiable: all-constant, non-wrapping operands never are
    return bool(t.arith_unsafe_pcs)


def _sink_tx_origin(t: TaintResult, v: ValueSets) -> bool:
    # dependence_on_origin fires iff an ORIGIN-derived value reaches a
    # JUMPI guard — exactly the ORIGIN-provenance condition fact
    return bool(t.origin_condition_pcs)


def _sink_user_assertions(t: TaintResult, v: ValueSets) -> bool:
    # the satellite fix for the self-admitted dead MSTORE screen:
    # user_assertions fires on the AssertionFailed LOG1 topic or a
    # CONCRETE MSTORE of the MythX marker word (symbolic stores raise
    # LookupError in the module) — LOG1-topic / marker-scan evidence
    return assertion_evidence(t, v)


#: module class name -> predicate over (TaintResult, ValueSets);
#: True = the sink can carry the property, the module must mount.
#: A module absent here is decided by its opcode signature alone.
SINK_PREDICATES: Dict[
    str, Callable[[TaintResult, ValueSets], bool]
] = {
    "ArbitraryJump": _sink_arbitrary_jump,
    "ArbitraryStorage": _sink_arbitrary_storage,
    "ArbitraryDelegateCall": _sink_delegatecall,
    "EtherThief": _sink_ether_thief,
    "ExternalCalls": _sink_external_calls,
    "IntegerArithmetics": _sink_integer,
    "TxOrigin": _sink_tx_origin,
    "UserAssertions": _sink_user_assertions,
}


def module_applicable(
    module_name: str,
    features: Set[str],
    taint: Optional[TaintResult] = None,
    vsa: Optional[ValueSets] = None,
) -> bool:
    signature = MODULE_SIGNATURES.get(module_name)
    if signature is None:
        return True
    if not all(
        any(op in features for op in group) for group in signature
    ):
        return False
    if taint is None or taint.incomplete or vsa is None:
        return True  # conservative fallback: opcode screen decides
    predicate = SINK_PREDICATES.get(module_name)
    if predicate is None:
        return True
    return predicate(taint, vsa)


def screen_modules(
    features: Iterable[str],
    module_names: Iterable[str] = None,
    taint: Optional[TaintResult] = None,
    vsa: Optional[ValueSets] = None,
) -> Tuple[List[str], List[str]]:
    """(applicable, skipped) module class names for a feature set.

    With `taint`/`vsa` (a completed taint fixpoint + its value sets)
    the semantic sink predicates refine the opcode screen; without
    them — or on an incomplete fixpoint — the opcode layer alone
    decides. `module_names` defaults to every registered detection
    module."""
    feature_set = set(features)
    if module_names is None:
        from mythril_tpu_torch.analysis.module import ModuleLoader

        module_names = [
            type(module).__name__
            for module in ModuleLoader().get_detection_modules()
        ]
    applicable, skipped = [], []
    for name in module_names:
        (
            applicable
            if module_applicable(name, feature_set, taint=taint, vsa=vsa)
            else skipped
        ).append(name)
    return applicable, skipped
