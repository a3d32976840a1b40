"""State-space recording: CFG nodes/edges built while the engine runs.

Extracted from the engine loop (the reference interleaves this with
execution in svm.py:470-558) so the stepping core stays free of
bookkeeping. The recorder owns the node/edge tables the graph and
statespace-dump commands consume.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.laser.ethereum.cfg import Edge, JumpType, Node, NodeFlags
from mythril_tpu_torch.laser.ethereum.evm_exceptions import StackUnderflowException
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)

log = logging.getLogger(__name__)


class StateSpaceRecorder:
    """Collects basic-block nodes and typed edges as states branch."""

    def __init__(self, keep: bool = True) -> None:
        self.keep = keep
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []

    def observe(self, opcode: Optional[str], states: List) -> None:
        """Route each successor of a branching opcode into a fresh
        node; append every state to its node's trace."""
        if opcode == "JUMP":
            assert len(states) <= 1
            for s in states:
                self._open_block(s)
        elif opcode == "JUMPI":
            assert len(states) <= 2
            for s in states:
                self._open_block(
                    s, JumpType.CONDITIONAL, s.world_state.constraints[-1]
                )
        elif opcode in ("SLOAD", "SSTORE") and len(states) > 1:
            for s in states:
                self._open_block(
                    s, JumpType.CONDITIONAL, s.world_state.constraints[-1]
                )
        elif opcode == "RETURN":
            for s in states:
                self._open_block(s, JumpType.RETURN)

        for s in states:
            s.node.states.append(s)

    def _open_block(
        self, state, edge_type=JumpType.UNCONDITIONAL, condition=None
    ) -> None:
        code = state.environment.code
        try:
            byte_addr = code.instruction_list[state.mstate.pc]["address"]
        except IndexError:
            return

        block = Node(state.environment.active_account.contract_name)
        previous = state.node
        state.node = block
        block.constraints = state.world_state.constraints
        if self.keep:
            self.nodes[block.uid] = block
            self.edges.append(
                Edge(
                    previous.uid,
                    block.uid,
                    edge_type=edge_type,
                    condition=condition,
                )
            )

        if edge_type == JumpType.RETURN:
            block.flags |= NodeFlags.CALL_RETURN
        elif edge_type == JumpType.CALL:
            try:
                if "retval" in str(state.mstate.stack[-1]):
                    block.flags |= NodeFlags.CALL_RETURN
                else:
                    block.flags |= NodeFlags.FUNC_ENTRY
            except StackUnderflowException:
                block.flags |= NodeFlags.FUNC_ENTRY

        self._name_function(state, block, byte_addr)

    def _name_function(self, state, block: Node, byte_addr: int) -> None:
        env = state.environment
        code = env.code
        if isinstance(
            state.world_state.transaction_sequence[-1],
            ContractCreationTransaction,
        ):
            env.active_function_name = "constructor"
        elif byte_addr in code.address_to_function_name:
            env.active_function_name = code.address_to_function_name[byte_addr]
            block.flags |= NodeFlags.FUNC_ENTRY
            log.debug(
                "entering %s:%s",
                env.active_account.contract_name,
                env.active_function_name,
            )
        elif byte_addr == 0:
            env.active_function_name = "fallback"
        block.function_name = env.active_function_name
