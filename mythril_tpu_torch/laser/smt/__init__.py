"""The SMT abstraction layer: the port's own copy of the JAX package's
laser/smt (terms, concrete evaluation, the typed Bool/BitVec wrappers
and the helpers the arena decode builds with). Nothing here imports
jax or the JAX package; the term DAG and its simplifications are the
same code, so a path condition decoded here has the structure of the
one the JAX package decodes. The surface is the JAX package's: arrays,
uninterpreted functions, models, and the host solver stack
(`Solver`, `Optimize`, `IndependenceSolver`).
"""

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.array import Array, BaseArray, K
from mythril_tpu_torch.laser.smt.bitvec import BitVec
from mythril_tpu_torch.laser.smt.bitvec_helper import (
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Concat,
    Extract,
    If,
    LShR,
    SGT,
    SLT,
    SignExt,
    Sum,
    UDiv,
    UGE,
    UGT,
    ULE,
    ULT,
    URem,
    SRem,
    ZeroExt,
)
from mythril_tpu_torch.laser.smt.bool import And, Bool, Implies, Not, Or, Xor, is_false, is_true
from mythril_tpu_torch.laser.smt.expression import Expression, simplify
from mythril_tpu_torch.laser.smt.function import Function
from mythril_tpu_torch.laser.smt.model import Model


class SymbolFactory:
    """Factory for symbols and values (reference: symbol_factory)."""

    @staticmethod
    def Bool(value: bool, annotations=None) -> Bool:
        return Bool(terms.bool_const(value), annotations)

    @staticmethod
    def BoolVal(value: bool, annotations=None) -> Bool:
        return Bool(terms.bool_const(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations=None) -> Bool:
        return Bool(terms.bool_var(name), annotations)

    @staticmethod
    def BitVecVal(value: int, size: int, annotations=None) -> BitVec:
        return BitVec(terms.bv_const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int, annotations=None) -> BitVec:
        return BitVec(terms.bv_var(name, size), annotations)


symbol_factory = SymbolFactory()

from mythril_tpu_torch.laser.smt.solver import (  # noqa: E402  (needs symbol_factory)
    IndependenceSolver,
    Optimize,
    Solver,
)

__all__ = [
    "Array",
    "BaseArray",
    "K",
    "BitVec",
    "Bool",
    "And",
    "Or",
    "Not",
    "Xor",
    "Implies",
    "is_false",
    "is_true",
    "Expression",
    "simplify",
    "Function",
    "Model",
    "Solver",
    "Optimize",
    "IndependenceSolver",
    "symbol_factory",
    "If",
    "UGT",
    "UGE",
    "ULT",
    "ULE",
    "SGT",
    "SLT",
    "Concat",
    "Extract",
    "URem",
    "SRem",
    "UDiv",
    "LShR",
    "Sum",
    "SignExt",
    "ZeroExt",
    "BVAddNoOverflow",
    "BVMulNoOverflow",
    "BVSubNoUnderflow",
    "terms",
]
