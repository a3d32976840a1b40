"""Opcode table, host keccak oracle, backend probe."""
