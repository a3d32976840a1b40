"""Helpers describing EVM operations for POST-style analysis.

Reference parity: mythril/analysis/ops.py:9-93 — `VarType`,
`Variable`, `get_variable` (concrete-or-symbolic classifier) and the
`Call` record SymExecWrapper extracts from the statespace.
"""

from __future__ import annotations

from enum import Enum

from mythril_tpu_torch.laser.ethereum import util
from mythril_tpu_torch.laser.smt import simplify


class VarType(Enum):
    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    """A value tagged with its concreteness."""

    def __init__(self, val, _type):
        self.val = val
        self.type = _type

    def __str__(self):
        return str(self.val)


def get_variable(i) -> Variable:
    try:
        return Variable(util.get_concrete_int(i), VarType.CONCRETE)
    except TypeError:
        return Variable(simplify(i), VarType.SYMBOLIC)


class Op:
    """Base for operations referencing node/state in the statespace."""

    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    """A recorded CALL-family operation."""

    def __init__(
        self,
        node,
        state,
        state_index,
        _type,
        to,
        gas,
        value=Variable(0, VarType.CONCRETE),
        data=None,
    ):
        super().__init__(node, state, state_index)
        self.to = to
        self.gas = gas
        self.type = _type
        self.value = value
        self.data = data
