"""Shared transaction launch path.

Both transaction drivers (symbolic + concolic) funnel through
`enqueue_transaction`: build the entry state, wire the inter-
transaction CFG edge, and push onto the engine worklist. The
reference duplicates this block in two modules
(mythril/laser/ethereum/transaction/{symbolic,concolic}.py); here it
exists once, parameterized by the optional caller pool that the
symbolic driver constrains senders to.
"""

from __future__ import annotations

from typing import Iterable, Optional

from mythril_tpu_torch.laser.ethereum.cfg import Edge, JumpType, Node
from mythril_tpu_torch.laser.smt import Or


def enqueue_transaction(
    laser_evm,
    transaction,
    caller_pool: Optional[Iterable] = None,
    environment_overrides: Optional[dict] = None,
) -> None:
    """Stage `transaction` for execution on `laser_evm`.

    `environment_overrides` pins Environment fields that default to
    fresh symbols (block_number, chainid, ...) — the concolic driver
    uses it to replay fixtures whose control flow depends on concrete
    block context (the reference must skip those: evm_test.py:33-60)."""
    entry = transaction.initial_global_state()
    entry.transaction_stack.append((transaction, None))
    for field, value in (environment_overrides or {}).items():
        setattr(entry.environment, field, value)

    if caller_pool is not None:
        entry.world_state.constraints.append(
            Or(*[transaction.caller == actor for actor in caller_pool])
        )

    node = Node(
        entry.environment.active_account.contract_name,
        function_name=entry.environment.active_function_name,
    )
    if laser_evm.requires_statespace:
        laser_evm.nodes[node.uid] = node

    origin_node = transaction.world_state.node
    if origin_node:
        if laser_evm.requires_statespace:
            laser_evm.edges.append(
                Edge(
                    origin_node.uid,
                    node.uid,
                    edge_type=JumpType.Transaction,
                    condition=None,
                )
            )
        node.constraints = entry.world_state.constraints

    entry.world_state.transaction_sequence.append(transaction)
    entry.node = node
    node.states.append(entry)
    laser_evm.work_list.append(entry)


def drain_open_states(laser_evm) -> list:
    """Take ownership of the engine's open world states."""
    taken = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    return taken
