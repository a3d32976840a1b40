"""Pure-python cryptographic primitives backing the EVM precompiles.

The reference pulls these from third-party native/python packages
(py_ecc for bn128, the coincurve/ethereum stack for secp256k1, a C
blake2b); none of those ship in this image, so the math lives here.
Precompiles only run on fully concrete inputs (symbolic inputs raise
NativeContractException upstream), so plain Python bigint speed is
fine — these are cold paths.
"""
