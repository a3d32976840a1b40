"""EVM-level exception family raised by the symbolic interpreter.

Reference parity: mythril/laser/ethereum/evm_exceptions.py:1-43.
"""


class VmException(Exception):
    """Base class for every EVM-semantics failure inside a path."""


class StackUnderflowException(IndexError, VmException):
    """Popped from an empty machine stack."""


class StackOverflowException(VmException):
    """Pushed past the 1024-slot EVM stack limit."""


class InvalidJumpDestination(VmException):
    """JUMP/JUMPI target is not a JUMPDEST."""


class InvalidInstruction(VmException):
    """Opcode byte has no defined semantics."""


class OutOfGasException(VmException):
    """The minimum gas bound exceeded the transaction's gas budget."""


class WriteProtection(VmException):
    """A state-mutating opcode executed inside a STATICCALL frame."""
