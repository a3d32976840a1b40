"""Per-path metadata carriers.

Reference parity: mythril/laser/ethereum/state/annotation.py:8-50 —
the mechanism every plugin and detection module uses to attach
information to a GlobalState/WorldState that travels with path copies.
"""

from __future__ import annotations


class StateAnnotation:
    """Attached to a state and copied along with it.

    Subclasses decide whether the annotation survives transaction
    boundaries (persist_to_world_state) and message-call returns
    (persist_over_calls).
    """

    @property
    def persist_to_world_state(self) -> bool:
        """If True, the annotation is propagated to the world state at
        transaction end, and hence to all following transactions."""
        return False

    @property
    def persist_over_calls(self) -> bool:
        """If True, the annotation is kept on the issuing transaction's
        states across nested message calls."""
        return False

    @property
    def search_importance(self) -> int:
        """Relative priority hint for search strategies (higher = more
        interesting).  The reference exposes this for strategy
        extensions; default is neutral."""
        return 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotation that knows how to merge with a sibling when two
    states are joined by a merging strategy."""

    def check_merge_annotation(self, annotation: "MergeableStateAnnotation") -> bool:
        raise NotImplementedError

    def merge_annotation(self, annotation: "MergeableStateAnnotation"):
        raise NotImplementedError


class NoCopyAnnotation(StateAnnotation):
    """Annotation shared by reference between copies instead of being
    deep-copied — for heavy, effectively-immutable payloads."""

    def __copy__(self):
        return self

    def __deepcopy__(self, _):
        return self
