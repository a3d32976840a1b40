"""Execution-frame view used by every opcode handler.

A `Frame` is a thin lens over one `GlobalState`: it owns the working
copy for the current instruction and exposes the handful of verbs the
semantics need (pop/push with word coercion, constraint recording,
fresh-symbol minting, forking for branches). Handlers never touch the
incoming state — the dispatch core hands them a private copy, mirroring
the copy-then-mutate rule of the reference's StateTransition decorator
(mythril/laser/ethereum/instructions.py:95-198) without per-handler
boilerplate.
"""

from __future__ import annotations

from copy import copy as _shallow_copy
from typing import List, Tuple, Union

from mythril_tpu_torch.laser.smt import (
    BitVec,
    Bool,
    If,
    simplify,
    symbol_factory,
)

Word = Union[int, BitVec, Bool]


def as_word(item: Word) -> BitVec:
    """Coerce a raw stack element to a 256-bit word. Bools become
    If(b,1,0); ints are wrapped as constants."""
    if isinstance(item, Bool):
        return If(
            item,
            symbol_factory.BitVecVal(1, 256),
            symbol_factory.BitVecVal(0, 256),
        )
    if isinstance(item, int):
        return symbol_factory.BitVecVal(item, 256)
    return item


def concrete_of(item: Word) -> int:
    """The concrete integer behind `item`; TypeError when symbolic
    (callers degrade gracefully, as throughout the reference)."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.symbolic:
            raise TypeError("symbolic word")
        return item.value
    if isinstance(item, Bool):
        if item.value is None:
            raise TypeError("symbolic bool")
        return int(item.value)
    raise TypeError(f"not a word: {type(item)}")


class Frame:
    """One opcode's working context."""

    __slots__ = ("state", "op", "loader")

    def __init__(self, state, op: str, loader=None):
        self.state = state
        self.op = op
        self.loader = loader

    # -- shorthands ----------------------------------------------------
    @property
    def ms(self):
        return self.state.mstate

    @property
    def env(self):
        return self.state.environment

    @property
    def world(self):
        return self.state.world_state

    @property
    def stack(self):
        return self.state.mstate.stack

    @property
    def memory(self):
        return self.state.mstate.memory

    # -- stack verbs ---------------------------------------------------
    def pop(self) -> BitVec:
        """Pop coerced to a 256-bit word (simplified, like the
        reference's pop_bitvec)."""
        item = self.stack.pop()
        if isinstance(item, (Bool, int)):
            return as_word(item)
        return simplify(item)

    def pop_raw(self) -> Word:
        """Pop without coercion (Bool stays Bool)."""
        return self.stack.pop()

    def pops(self, n: int) -> Tuple[BitVec, ...]:
        return tuple(self.pop() for _ in range(n))

    def pops_raw(self, n: int) -> Tuple[Word, ...]:
        return tuple(self.stack.pop() for _ in range(n))

    def push(self, item: Word) -> None:
        self.stack.append(item)

    # -- symbolic bookkeeping ------------------------------------------
    def require(self, constraint) -> None:
        """Record a path constraint on the world state."""
        self.world.constraints.append(constraint)

    def fresh(self, name: str, bits: int = 256, annotations=None) -> BitVec:
        """Mint a transaction-scoped fresh symbol."""
        return self.state.new_bitvec(name, bits, annotations)

    def concrete(self, item: Word) -> int:
        return concrete_of(item)

    # -- control -------------------------------------------------------
    def fork(self) -> "Frame":
        """An independent copy of the current state, for branch
        successors."""
        return Frame(_shallow_copy(self.state), self.op, self.loader)

    def done(self) -> List:
        """The default single-successor result."""
        return [self.state]

    # -- instruction metadata ------------------------------------------
    @property
    def here(self) -> dict:
        """The instruction dict currently being executed."""
        return self.state.get_current_instruction()

    @property
    def byte_addr(self) -> int:
        return self.here["address"]
