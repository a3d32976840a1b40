"""EVM machine µ-state: pc, stack, memory, gas bounds.

Reference parity: mythril/laser/ethereum/state/machine_state.py —
`MachineStack` (1024-capped list, :17-80) and `MachineState`
(:83-264) with the quadratic memory-gas rule (`calculate_memory_gas`,
:137) and `mem_extend` (:158).
"""

from __future__ import annotations

from typing import List, Union

from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    OutOfGasException,
    StackOverflowException,
    StackUnderflowException,
)
from mythril_tpu_torch.laser.ethereum.state.memory import Memory
from mythril_tpu_torch.laser.smt import BitVec, Expression, simplify, symbol_factory
from mythril_tpu_torch.support.opcodes import GAS_MEMORY, GAS_QUADRATIC_DENOM


class MachineStack(list):
    """The EVM operand stack, capped at 1024 entries."""

    STACK_LIMIT = 1024

    def __init__(self, default_list=None):
        super().__init__(default_list or [])

    def append(self, element: Union[int, Expression]) -> None:
        if isinstance(element, int):
            element = symbol_factory.BitVecVal(element, 256)
        if super().__len__() >= self.STACK_LIMIT:
            raise StackOverflowException(
                f"reached the EVM stack limit of {self.STACK_LIMIT}"
            )
        super().append(element)

    def pop(self, index=-1) -> Union[int, Expression]:
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("popping from an empty stack")

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException("stack index out of range")

    def __add__(self, other):
        raise NotImplementedError("stack concatenation is not allowed")

    def __iadd__(self, other):
        raise NotImplementedError("stack concatenation is not allowed")


class MachineState:
    """The machine portion of a global state (per call frame)."""

    def __init__(
        self,
        gas_limit: int,
        pc: int = 0,
        stack: MachineStack = None,
        subroutine_stack: MachineStack = None,
        memory: Memory = None,
        constraints=None,
        depth: int = 0,
        max_gas_used: int = 0,
        min_gas_used: int = 0,
    ):
        self.pc = pc
        self.constraints = constraints
        self.stack = MachineStack(stack)
        self.subroutine_stack = MachineStack(subroutine_stack)
        self.memory = memory or Memory()
        self.gas_limit = gas_limit
        self.min_gas_used = min_gas_used  # lower bound, concrete path
        self.max_gas_used = max_gas_used  # upper bound
        self.depth = depth

    # -- gas ------------------------------------------------------------
    def check_gas(self) -> None:
        """Raise OutOfGasException when even the minimum gas bound
        exceeds the frame's budget (reference: machine_state.py:125)."""
        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException()

    def calculate_extension_size(self, start: int, size: int) -> int:
        if self.memory_size > start + size:
            return 0
        new_size = ((start + size + 31) // 32) * 32
        return new_size - self.memory_size

    def calculate_memory_gas(self, start: int, size: int) -> int:
        """Gas cost of growing memory to cover [start, start+size)
        (Yellow Paper C_mem: 3w + w^2/512; reference:
        machine_state.py:137)."""
        if size == 0:
            return 0
        old_words = self.memory_size // 32
        new_words = max(old_words, (start + size + 31) // 32)
        cost = lambda w: GAS_MEMORY * w + w * w // GAS_QUADRATIC_DENOM
        return cost(new_words) - cost(old_words)

    def mem_extend(self, start: Union[int, BitVec], size: Union[int, BitVec]) -> None:
        """Extend memory (and charge gas bounds) for an access at
        [start, start+size) (reference: machine_state.py:158)."""
        if isinstance(start, BitVec):
            start = start.value if start.value is not None else 0
        if isinstance(size, BitVec):
            size = size.value if size.value is not None else 0
        if size == 0:
            return
        extend_gas = self.calculate_memory_gas(start, size)
        self.min_gas_used += extend_gas
        self.max_gas_used += extend_gas
        self.check_gas()
        if start + size > self.memory_size:
            self.memory.extend(((start + size + 31) // 32) * 32)

    # -- stack helpers ---------------------------------------------------
    def pop(self, amount: int = 1) -> Union[BitVec, List[BitVec]]:
        """Pop `amount` values; one value unwrapped, several as a list
        in pop order (reference: machine_state.py:219)."""
        if amount > len(self.stack):
            raise StackUnderflowException
        values = self.stack[-amount:][::-1]
        del self.stack[-amount:]
        return values[0] if amount == 1 else values

    @property
    def memory_size(self) -> int:
        return len(self.memory)

    @property
    def as_dict(self):
        """Serializable view (reference: machine_state.py:250) used by
        the statespace dump."""
        return dict(
            pc=self.pc,
            stack=self.stack,
            memory=self.memory,
            memsize=self.memory_size,
            gas=self.gas_limit,
            max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used,
        )

    @property
    def memory_dict(self):
        return self.memory

    def __copy__(self) -> "MachineState":
        new = MachineState(
            gas_limit=self.gas_limit,
            pc=self.pc,
            stack=MachineStack(self.stack),
            subroutine_stack=MachineStack(self.subroutine_stack),
            memory=self.memory.__copy__(),
            depth=self.depth,
            max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used,
        )
        return new

    def __str__(self):
        return f"MachineState(pc={self.pc}, stack={len(self.stack)})"
