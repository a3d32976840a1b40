"""The EVM layer of the host engine; the port holds only the attacker
transaction's actors (transaction/symbolic.py)."""
