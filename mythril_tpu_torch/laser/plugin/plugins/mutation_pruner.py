"""Mutation pruner: drop transactions that provably changed nothing.

Covers mythril/laser/plugin/plugins/mutation_pruner.py. A symbolic
transaction whose path neither touched a mutating opcode nor can move
a positive call value leaves the world state equivalent to its start
state, so keeping its end state only multiplies later transactions'
work; the pruner vetoes it at add_world_state time.
"""

from __future__ import annotations

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.plugins.plugin_annotations import MutationAnnotation
from mythril_tpu_torch.laser.plugin.signals import PluginSkipWorldState
from mythril_tpu_torch.laser.smt import UGT, symbol_factory
from mythril_tpu_torch.support.model import get_model

#: opcodes whose mere execution means the tx was not a no-op
MUTATING_OPS = ("SSTORE", "CALL", "STATICCALL")


class MutationPrunerBuilder(PluginBuilder):
    plugin_name = "mutation-pruner"

    def __call__(self, *args, **kwargs):
        return MutationPruner()


def _can_move_value(global_state: GlobalState) -> bool:
    """Is a strictly positive callvalue satisfiable on this path?"""
    value = global_state.environment.callvalue
    if isinstance(value, int):
        value = symbol_factory.BitVecVal(value, 256)
    query = global_state.world_state.constraints + [
        UGT(value, symbol_factory.BitVecVal(0, 256))
    ]
    try:
        get_model(query)
        return True
    except UnsatError:
        return False


class MutationPruner(LaserPlugin):
    """Tags mutating opcodes on the way through; vetoes untagged,
    value-free end states."""

    def initialize(self, symbolic_vm) -> None:
        def tag(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        for op in MUTATING_OPS:
            symbolic_vm.pre_hook(op)(tag)

        @symbolic_vm.laser_hook("add_world_state")
        def drop_clean_transaction(global_state: GlobalState):
            tx = global_state.current_transaction
            if isinstance(tx, ContractCreationTransaction):
                return  # deployments always matter
            if _can_move_value(global_state):
                return  # balances may have mutated
            if next(global_state.get_annotations(MutationAnnotation), None):
                return  # a mutating opcode ran
            raise PluginSkipWorldState
