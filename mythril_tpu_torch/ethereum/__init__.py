"""The EVM contract model (evmcontract.py)."""
