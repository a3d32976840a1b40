"""Value-set facts extracted from the taint fixpoint.

The port's copy of the JAX package's analysis/static/vsa.py, with the
package renamed.

Where `taint.py` answers "who influences this sink", this pass
answers "what concrete values can it hold": the constant half of the
sink records is distilled into

- **resolved call targets** — CALL/CALLCODE/DELEGATECALL/STATICCALL
  sites whose callee address is a provable constant. These are the
  cross-contract facts ROADMAP item 4 needs: a corpus scheduler can
  pre-load a constant callee's code into the arena before the wave
  that calls it.
- **constant storage slots** — SSTORE/SLOAD sites with constant
  slots, split into read/written sets. A contract whose entire
  storage footprint is constant slots is the easy case for
  incremental re-analysis (item 3): a diff touching none of them
  cannot invalidate banked storage facts.
- **assertion-marker evidence** — the two concrete triggers the
  `UserAssertions` detector keys on: the AssertionFailed(string) LOG1
  topic and the MythX `0xcafecafe…` MSTORE marker word. The topic is
  checked against constant LOG1 topics from the taint pass; the
  marker is a byte scan over the raw code (a PUSHed marker always
  appears in the code bytes; the scan over-approximates into
  non-PUSH positions, which only ever mounts more).

The constants duplicate two values from
`analysis/module/modules/user_assertions.py` and
`laser/ethereum/transaction/symbolic.py` so `lint` keeps its
no-torch/no-smt import budget (same pattern as the engine's local
trigger-kind table).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from mythril_tpu_torch.analysis.static.taint import TaintResult

#: user_assertions.ASSERTION_FAILED_TOPIC — emit AssertionFailed(string)
ASSERTION_FAILED_TOPIC = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)
#: user_assertions.MSTORE_MARKER, as the hex byte pattern the code
#: scan looks for (30 bytes: "cafe" fifteen times)
MSTORE_MARKER_HEX = "cafe" * 15

#: transaction.symbolic._ATTACKER_DEFAULT — the actor address the
#: delegatecall/external-call properties pin the target to
ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF

#: don't let a pathological contract bloat stats()/lint_dict()
_EXPORT_CAP = 64


class ValueSets:
    """The distilled constant facts for one bytecode."""

    def __init__(self) -> None:
        #: pc -> constant callee address (all call kinds)
        self.resolved_call_targets: Dict[int, int] = {}
        #: pc -> call kind for the resolved targets
        self.call_kinds: Dict[int, str] = {}
        self.constant_storage_writes: Set[int] = set()
        self.constant_storage_reads: Set[int] = set()
        #: code bytes contain the MythX assertion marker word
        self.marker_in_code = False
        #: a constant LOG1 topic equals the AssertionFailed topic
        self.assert_topic_logged = False

    def stats(self) -> Dict:
        slots = sorted(
            self.constant_storage_writes | self.constant_storage_reads
        )
        return {
            "resolved_call_targets": {
                str(pc): hex(target)
                for pc, target in sorted(
                    self.resolved_call_targets.items()
                )[:_EXPORT_CAP]
            },
            "resolved_call_target_count": len(self.resolved_call_targets),
            "constant_storage_slots": [
                hex(s) for s in slots[:_EXPORT_CAP]
            ],
            "constant_storage_slot_count": len(slots),
        }


def value_sets(
    taint: Optional[TaintResult], code: bytes
) -> ValueSets:
    """Post-process the taint fixpoint's sink constants (+ the raw
    code scan). A missing/incomplete taint result yields only the
    byte-scan facts — still sound, just empty-handed."""
    out = ValueSets()
    out.marker_in_code = MSTORE_MARKER_HEX in code.hex()
    if taint is None or taint.incomplete:
        return out
    for pc, site in taint.call_sites.items():
        target = site["target"][0]
        if target is not None:
            out.resolved_call_targets[pc] = target
            out.call_kinds[pc] = site["kind"]
    for pc, slot in taint.sstore_slots.items():
        if slot[0] is not None:
            out.constant_storage_writes.add(slot[0])
    for pc, slot in taint.sload_slots.items():
        if slot[0] is not None:
            out.constant_storage_reads.add(slot[0])
    out.assert_topic_logged = any(
        topic[0] == ASSERTION_FAILED_TOPIC
        for topic in taint.log1_topics.values()
        if topic[0] is not None
    )
    return out


def assertion_evidence(
    taint: Optional[TaintResult], vsa: ValueSets
) -> bool:
    """Can the UserAssertions detector possibly fire? Either LOG1
    evidence (a topic that is — or might be — the AssertionFailed
    topic) or the MSTORE marker word somewhere in the code. With no
    usable taint result the caller must fall back to the opcode
    screen instead of consulting this."""
    if vsa.marker_in_code or vsa.assert_topic_logged:
        return True
    if taint is None or taint.incomplete:
        return True  # no flow facts: keep the module
    return any(
        topic[0] is None for topic in taint.log1_topics.values()
    )
