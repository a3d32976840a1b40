"""GlobalState: one symbolic path state.

Reference parity: mythril/laser/ethereum/state/global_state.py:21-163 —
world state + environment + machine state + transaction stack + CFG
node + annotations. The load-bearing subtlety lives in `__copy__`: a
fork clones the mutable parts and then re-binds the environment's
active account into the cloned world state, the aliasing rule every
fork depends on. `new_bitvec` prefixes fresh symbols with the
transaction id so witnesses map back to transactions.
"""

from __future__ import annotations

from copy import copy
from typing import Dict, Iterable, List, Optional

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.environment import Environment
from mythril_tpu_torch.laser.ethereum.state.machine_state import MachineState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.smt import BitVec, symbol_factory

#: gas ceiling a fresh machine state starts with when none is supplied
_DEFAULT_GAS_LIMIT = 1_000_000_000


class GlobalState:
    """One state of the symbolic machine: a point on one path."""

    def __init__(
        self,
        world_state: WorldState,
        environment: Environment,
        node=None,
        machine_state: Optional[MachineState] = None,
        transaction_stack: Optional[List] = None,
        last_return_data=None,
        annotations: Optional[List[StateAnnotation]] = None,
    ):
        self.world_state = world_state
        self.environment = environment
        self.node = node
        self.mstate = machine_state or MachineState(gas_limit=_DEFAULT_GAS_LIMIT)
        self.transaction_stack = transaction_stack or []
        self.op_code = ""
        self.last_return_data = last_return_data
        self._annotations = annotations or []

    def __copy__(self) -> "GlobalState":
        twin = GlobalState(
            copy(self.world_state),
            copy(self.environment),
            self.node,
            copy(self.mstate),
            transaction_stack=list(self.transaction_stack),
            last_return_data=self.last_return_data,
            annotations=[copy(a) for a in self._annotations],
        )
        # re-bind the active account into the CLONED world state: a
        # handler mutating twin.environment.active_account.storage must
        # hit the twin's account object, never the original's
        twin.environment.active_account = twin.world_state[
            twin.environment.active_account.address
        ]
        twin.op_code = self.op_code
        return twin

    # -- accessors -------------------------------------------------------
    @property
    def accounts(self) -> Dict:
        return self.world_state.accounts

    def get_current_instruction(self) -> Dict:
        """The instruction record at the current pc (IndexError past
        the end of code — the engine treats that as an implicit STOP)."""
        listing = self.environment.code.instruction_list
        if self.mstate.pc < len(listing):
            return listing[self.mstate.pc]
        raise IndexError

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    @property
    def current_transaction(self):
        stack = self.transaction_stack
        return stack[-1][0] if stack else None

    def new_bitvec(self, name: str, size: int = 256, annotations=None) -> BitVec:
        """A fresh symbol namespaced by the running transaction."""
        prefix = self.current_transaction.id
        return symbol_factory.BitVecSym(
            f"{prefix}_{name}", size, annotations=annotations
        )

    # -- annotations -----------------------------------------------------
    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)
        if annotation.persist_to_world_state:
            self.world_state.annotate(annotation)

    def add_annotations(self, annotations: List[StateAnnotation]) -> None:
        """Bulk-attach annotations (used when propagating
        persist_over_calls annotations across frames)."""
        self._annotations += annotations

    def get_annotations(self, annotation_type: type) -> Iterable[StateAnnotation]:
        return (a for a in self._annotations if isinstance(a, annotation_type))
