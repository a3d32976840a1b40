"""Model: a satisfying assignment returned by the solver.

The port's copy of the JAX package's laser/smt/model.py.

Reference parity: mythril/laser/smt/model.py (wraps z3.ModelRef;
`eval` with `model_completion`). Here a model is a plain assignment
dict (see evalterm.py for the layout) plus evaluation.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.bitvec import BitVec
from mythril_tpu_torch.laser.smt.bool import Bool
from mythril_tpu_torch.laser.smt.evalterm import eval_term


class ModelDecl:
    def __init__(self, name: str):
        self._name = name

    def name(self) -> str:
        return self._name

    def __repr__(self):
        return self._name


class Model:
    """A concrete assignment for every free symbol of a query."""

    def __init__(self, assignment: Optional[Dict] = None):
        self.assignment: Dict = assignment or {}

    def decls(self):
        return [ModelDecl(k) for k in self.assignment]

    def __getitem__(self, item):
        name = item.name() if isinstance(item, ModelDecl) else str(item)
        return self.assignment.get(name)

    def eval(
        self, expression: Union[BitVec, Bool, terms.Term], model_completion: bool = False
    ):
        """Evaluate an expression under this model.

        Unassigned symbols default to 0 when model_completion is set
        (matching z3's completion); without completion they still
        evaluate (as 0) — callers in this codebase always complete.
        Returns a BitVec/Bool constant.
        """
        raw = expression.raw if hasattr(expression, "raw") else expression
        val = eval_term(raw, self.assignment)
        if raw.sort.kind == "bool":
            return Bool(terms.bool_const(bool(val)))
        return BitVec(terms.bv_const(val, raw.width))

    def eval_int(self, expression: Union[BitVec, Bool, terms.Term]) -> int:
        """Evaluate to a plain Python int (completion: unknowns -> 0)."""
        raw = expression.raw if hasattr(expression, "raw") else expression
        return int(eval_term(raw, self.assignment))
