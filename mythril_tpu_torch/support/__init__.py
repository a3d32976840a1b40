"""Opcode table, host keccak oracle, backend probe, the flag bag
(`support_args`), and the resilience layer (`resilience`, `breaker`)."""
