"""Control-flow-graph bookkeeping for statespace outputs.

Reference parity: mythril/laser/ethereum/cfg.py:14-122 — `Node`
(states of one basic block + constraints + function name, globally
unique uid), `Edge` with `JumpType`, and `NodeFlags`. The reference
uses py-flags; a plain IntFlag covers the same surface.
"""

from __future__ import annotations

from enum import Enum, IntFlag
from typing import TYPE_CHECKING, List

from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints

if TYPE_CHECKING:
    from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

gbl_next_uid = 0  # node uid counter (reference: cfg.py:11)


class JumpType(Enum):
    """Edge categories in the call graph."""

    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags(IntFlag):
    FUNC_ENTRY = 1
    CALL_RETURN = 2


class Node:
    """One basic block: the states that passed through it plus the
    constraints under which it was reached."""

    def __init__(
        self,
        contract_name: str,
        start_addr: int = 0,
        constraints: Constraints = None,
        function_name: str = "unknown",
    ):
        constraints = constraints if constraints else Constraints()
        self.contract_name = contract_name
        self.start_addr = start_addr
        self.states: List["GlobalState"] = []
        self.constraints = constraints
        self.function_name = function_name
        self.flags = NodeFlags(0)

        global gbl_next_uid
        self.uid = gbl_next_uid
        gbl_next_uid += 1

    def get_cfg_dict(self) -> dict:
        code_lines = []
        for state in self.states:
            instruction = state.get_current_instruction()
            code_lines.append(
                "%d %s" % (instruction["address"], instruction["opcode"])
            )
        return {
            "contract_name": self.contract_name,
            "start_addr": self.start_addr,
            "function_name": self.function_name,
            "code": "\\n".join(code_lines),
        }


class Edge:
    """A directed edge between two CFG nodes."""

    def __init__(
        self,
        node_from: int,
        node_to: int,
        edge_type: JumpType = JumpType.UNCONDITIONAL,
        condition=None,
    ):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def __lt__(self, other: "Edge") -> bool:
        return self.node_from < other.node_from

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Edge)
            and self.node_from == other.node_from
            and self.node_to == other.node_to
            and self.type == other.type
        )

    def __hash__(self) -> int:
        return hash((self.node_from, self.node_to, self.type))

    @property
    def as_dict(self) -> dict:
        return {"from": self.node_from, "to": self.node_to}
