"""Dependency pruner: skip blocks no previous transaction can affect.

Covers mythril/laser/plugin/plugins/dependency_pruner.py. Transaction
1 is a learning pass: for every basic block the pruner records which
storage locations are read ("dependencies") and written along paths
through that block, plus whether a call sits on the path. From
transaction 2 on, a block that was already seen on this path only
re-executes when some storage write of the previous transaction may
alias one of the block's recorded reads — each aliasing question is a
single-equality solver query.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Set

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.plugins.plugin_annotations import (
    DependencyAnnotation,
    WSDependencyAnnotation,
)
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


def _may_alias(a, b) -> bool:
    """One equality query: can these two storage locations coincide?"""
    try:
        get_model((a == b,))
        return True
    except UnsatError:
        return False


def get_dependency_annotation(state: GlobalState) -> DependencyAnnotation:
    """This path's dependency annotation, falling back to one handed
    over from the previous transaction through the world-state stack
    (assumes bfs-like scheduling, as in the reference)."""
    existing = next(iter(state.get_annotations(DependencyAnnotation)), None)
    if existing is not None:
        return existing
    try:
        carried = get_ws_dependency_annotation(state).annotations_stack.pop()
    except IndexError:
        carried = DependencyAnnotation()
    state.annotate(carried)
    return carried


def get_ws_dependency_annotation(state: GlobalState) -> WSDependencyAnnotation:
    ws = state.world_state
    existing = next(iter(ws.get_annotations(WSDependencyAnnotation)), None)
    if existing is not None:
        return existing
    fresh = WSDependencyAnnotation()
    ws.annotate(fresh)
    return fresh


class DependencyPrunerBuilder(PluginBuilder):
    plugin_name = "dependency-pruner"

    def __call__(self, *args, **kwargs):
        return DependencyPruner()


class DependencyPruner(LaserPlugin):
    """Per-block read/write learning + cross-transaction alias pruning."""

    def __init__(self):
        self.iteration = 0
        #: block address -> storage locations read on paths through it
        self.reads_by_block: Dict[int, List[object]] = {}
        #: block address -> storage locations written on those paths
        self.writes_by_block: Dict[int, List[object]] = {}
        #: blocks with an external call somewhere on their path
        self.blocks_with_calls: Dict[int, bool] = {}
        #: every storage location read anywhere, across all paths
        self.all_reads: Set = set()

    # -- learning ------------------------------------------------------
    @staticmethod
    def _note(table: Dict[int, List[object]], path: List[int], loc) -> None:
        for block in path:
            bucket = table.setdefault(block, [])
            if loc not in bucket:
                bucket.append(loc)

    def _note_call(self, path: List[int]) -> None:
        for block in path:
            if block in self.writes_by_block:
                self.blocks_with_calls[block] = True

    # -- the pruning decision ------------------------------------------
    def wanna_execute(self, block: int, annotation: DependencyAnnotation) -> bool:
        """Re-execute `block` this transaction?"""
        if block in self.blocks_with_calls:
            return True
        # a read-free block can't observe any prior write
        if block not in self.reads_by_block:
            return False

        prior_writes = annotation.get_storage_write_cache(self.iteration - 1)

        if block in self.all_reads:
            # the block address itself shows up as a read location;
            # check whether any write-carrying block can hit it
            for written in self.writes_by_block:
                if _may_alias(written, block):
                    return True

        for written in prior_writes:
            for read in self.reads_by_block[block]:
                if _may_alias(written, read):
                    return True
            for read in annotation.storage_loaded:
                if _may_alias(written, read):
                    return True
        return False

    # -- wiring --------------------------------------------------------
    def initialize(self, symbolic_vm) -> None:
        self.__init__()

        @symbolic_vm.laser_hook("start_sym_trans")
        def next_iteration():
            self.iteration += 1

        def enter_block(state: GlobalState):
            try:
                block = state.get_current_instruction()["address"]
            except IndexError:
                raise PluginSkipState
            annotation = get_dependency_annotation(state)
            annotation.path.append(block)
            self._decide(block, annotation)

        symbolic_vm.post_hook("JUMP")(enter_block)
        symbolic_vm.post_hook("JUMPI")(enter_block)

        @symbolic_vm.pre_hook("SSTORE")
        def learn_write(state: GlobalState):
            annotation = get_dependency_annotation(state)
            slot = state.mstate.stack[-1]
            self._note(self.writes_by_block, annotation.path, slot)
            annotation.extend_storage_write_cache(self.iteration, slot)

        @symbolic_vm.pre_hook("SLOAD")
        def learn_read(state: GlobalState):
            annotation = get_dependency_annotation(state)
            slot = state.mstate.stack[-1]
            if slot not in annotation.storage_loaded:
                annotation.storage_loaded.append(slot)
            # annotate backwards immediately: the path may never reach
            # a STOP/RETURN
            self._note(self.reads_by_block, annotation.path, slot)
            self.all_reads.add(slot)

        def learn_call(state: GlobalState):
            annotation = get_dependency_annotation(state)
            self._note_call(annotation.path)
            annotation.has_call = True

        symbolic_vm.pre_hook("CALL")(learn_call)
        symbolic_vm.pre_hook("STATICCALL")(learn_call)

        def flush_path(state: GlobalState):
            """Fold the finished path's read/write sets into every
            block it crossed."""
            annotation = get_dependency_annotation(state)
            for slot in annotation.storage_loaded:
                self._note(self.reads_by_block, annotation.path, slot)
            for slot in annotation.storage_written:
                self._note(self.writes_by_block, annotation.path, slot)
            if annotation.has_call:
                self._note_call(annotation.path)

        symbolic_vm.pre_hook("STOP")(flush_path)
        symbolic_vm.pre_hook("RETURN")(flush_path)

        @symbolic_vm.laser_hook("add_world_state")
        def hand_over(state: GlobalState):
            if isinstance(state.current_transaction, ContractCreationTransaction):
                self.iteration = 0
                return
            ws_annotation = get_ws_dependency_annotation(state)
            annotation = get_dependency_annotation(state)
            # only the write cache survives into the next transaction
            annotation.path = [0]
            annotation.storage_loaded = []
            ws_annotation.annotations_stack.append(annotation)

    def _decide(self, block: int, annotation: DependencyAnnotation) -> None:
        if self.iteration < 2:
            return
        if block not in annotation.blocks_seen:
            annotation.blocks_seen.add(block)
            return
        if self.wanna_execute(block, annotation):
            return
        log.debug(
            "Skipping state: Storage slots %s not read in block at address %d",
            annotation.get_storage_write_cache(self.iteration - 1),
            block,
        )
        raise PluginSkipState
