"""Symbolic EVM state model (L2).

Reference parity: mythril/laser/ethereum/state/ — WorldState, Account,
Storage, GlobalState, MachineState, Memory, Calldata, Environment,
Constraints, StateAnnotation — rebuilt over mythril_tpu_torch's own SMT
layer (no z3).
"""
