"""Path metadata carried for the pruner plugins.

Behavioral contract (consumed by dependency_pruner.py and
mutation_pruner.py; the reference equivalent lives at
mythril/laser/plugin/plugins/plugin_annotations.py):

- ``MutationAnnotation`` — a bare marker meaning "this path executed a
  state-mutating instruction". It must survive into nested call frames
  so an SSTORE inside a callee still marks the outer transaction.
- ``DependencyAnnotation`` — one transaction's dependency trace: which
  storage slots the path read, which it wrote per transaction number,
  whether it made an external call, and the basic-block trail walked.
- ``WSDependencyAnnotation`` — the world-state-level carrier that
  stacks one ``DependencyAnnotation`` per open state so the next
  transaction can resume its predecessor's trace.

Copies are *one level deep* for the read trace and block trail (a
branch's appends must not leak into its sibling), but the
per-transaction WRITE lists are shared across forks on purpose: the
pruner reads them as may-write sets, and cross-fork widening only ever
causes extra re-execution — see ``DependencyAnnotation.__copy__``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Set

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation


class MutationAnnotation(StateAnnotation):
    """Marker: the annotated path performed a world-state mutation
    (SSTORE, or a value-bearing CALL family instruction)."""

    __slots__ = ()

    @property
    def persist_over_calls(self) -> bool:
        # a mutation inside a callee frame is still a mutation of the
        # transaction — the mutation pruner checks the outermost state
        return True


class DependencyAnnotation(StateAnnotation):
    """One transaction's storage-dependency trace along a path."""

    def __init__(self) -> None:
        #: slots (concrete or symbolic terms) this path has SLOADed
        self.storage_loaded: List[Any] = []
        #: transaction number -> slots SSTOREd during that transaction
        self.storage_written: Dict[int, List[Any]] = {}
        #: the path issued CALL/STATICCALL/DELEGATECALL/CALLCODE
        self.has_call: bool = False
        #: basic-block trail, rooted at the synthetic entry block 0
        self.path: List[int] = [0]
        #: blocks already counted by the loop-aware block tracker
        self.blocks_seen: Set[int] = set()

    def __copy__(self) -> "DependencyAnnotation":
        twin = DependencyAnnotation()
        twin.storage_loaded = list(self.storage_loaded)
        # Shallow dict copy ON PURPOSE: the per-transaction write lists
        # stay SHARED across forks, so one branch's SSTOREs widen its
        # siblings' recorded write sets. The pruner treats these as
        # may-write sets — wider sets mean re-executing more
        # transactions, never fewer — so sharing costs pruning
        # precision but can never skip a transaction a sibling's write
        # made relevant (per-fork narrowed sets could, which risks
        # missed findings, not just precision).
        twin.storage_written = dict(self.storage_written)
        twin.has_call = self.has_call
        twin.path = list(self.path)
        twin.blocks_seen = set(self.blocks_seen)
        return twin

    def get_storage_write_cache(self, iteration: int) -> List[Any]:
        """The (created-on-demand) write list for transaction number
        `iteration`."""
        return self.storage_written.setdefault(iteration, [])

    def extend_storage_write_cache(self, iteration: int, value: Any) -> None:
        """Record a written slot, keeping insertion order and dropping
        duplicates (term equality — symbolic slots dedup structurally)."""
        cache = self.get_storage_write_cache(iteration)
        if value not in cache:
            cache.append(value)


class WSDependencyAnnotation(StateAnnotation):
    """Per-world-state stack of dependency traces: the end of
    transaction N pushes its trace; transaction N+1 pops it to seed
    its own annotation."""

    def __init__(self) -> None:
        self.annotations_stack: List[DependencyAnnotation] = []

    def __copy__(self) -> "WSDependencyAnnotation":
        twin = WSDependencyAnnotation()
        # Shallow by design, matching reference behavior: the copied
        # stacks are separate lists but share the carried trace
        # objects, and the adopter (dependency_pruner
        # get_dependency_annotation) pops WITHOUT copying — so two
        # world-state forks that each start a next transaction adopt
        # the same trace object. That sharing only ever widens the
        # recorded read/write sets (the pruner treats them as
        # may-sets), so it costs pruning precision, never soundness.
        twin.annotations_stack = list(self.annotations_stack)
        return twin
