"""The selector mask feed of incremental re-analysis.

The port's copy of `SelectorMaskFeed` from the JAX package's
store/diff.py: a static summary wrapper that masks a fork's unchanged
selectors like statically-dead ones. The explorer takes
`selector_masks` and wraps each masked contract's static summary; with
static pruning off no summary exists to wrap, so the masks stay inert,
as in the JAX package.
"""

from __future__ import annotations

from typing import FrozenSet, Set, Tuple


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
