"""Path-condition container.

Reference parity: mythril/laser/ethereum/state/constraints.py:9-108 —
a list of Bool constraints with a cached satisfiability check
(`is_possible`), copy-on-append semantics, and hashability so identical
constraint sets share solver-cache entries.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.smt import Bool, simplify, symbol_factory


class Constraints(list):
    """A collection of Bool path conditions."""

    def __init__(self, constraint_list: Optional[Iterable[Union[bool, Bool]]] = None):
        super().__init__(self._convert(c) for c in (constraint_list or []))

    @staticmethod
    def _convert(constraint: Union[bool, Bool]) -> Bool:
        if isinstance(constraint, bool):
            return symbol_factory.Bool(constraint)
        if isinstance(constraint, Bool):
            return constraint
        raise TypeError(f"invalid constraint type {type(constraint)}")

    @property
    def is_possible(self) -> bool:
        """True unless the constraint set is provably unsat.

        Funnels through the cached get_model entry point exactly like
        the reference (constraints.py:25-33 -> support/model.py:15), so
        repeated checks of the same path prefix are free.
        """
        from mythril_tpu_torch.support.model import get_model

        try:
            get_model(tuple(self))
        except UnsatError:
            return False
        return True

    def append(self, constraint: Union[bool, Bool]) -> None:
        super().append(simplify(self._convert(constraint)))

    def pop(self, index: int = -1) -> Bool:
        raise NotImplementedError("removing constraints is not supported")

    def __copy__(self) -> "Constraints":
        return Constraints(self[:])

    def copy(self) -> "Constraints":
        return self.__copy__()

    def __deepcopy__(self, _memodict=None) -> "Constraints":
        # Bool wrappers are immutable views over interned terms; a
        # shallow list copy is a correct deep copy.
        return self.__copy__()

    def __add__(self, constraints: List[Union[bool, Bool]]) -> "Constraints":
        result = self.__copy__()
        for c in constraints:
            result.append(c)
        return result

    def __iadd__(self, constraints: Iterable[Union[bool, Bool]]) -> "Constraints":
        for c in constraints:
            self.append(c)
        return self

    def __hash__(self):
        return hash(tuple(c.raw._id for c in self))
