"""EVM execution layers of the port."""
