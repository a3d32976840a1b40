"""mythril_tpu_torch: the batched EVM interpreter ported to PyTorch and
CUDA for an NVIDIA H100.

A package beside the JAX one, imported without it: it imports torch and
never jax. Entry points build their tensors on the card unless the
caller passes `device="cpu"`:

- `laser.batch.make_batch` / `make_code_table` / `run`;
- `laser.conformance.run_cases` (VMTests replay);
- `ops.keccak.keccak256`.

The one hand-written kernel so far is keccak-f[1600] (csrc/keccak_f.cu,
bound in ops/keccak_cuda.py), built with nvcc at first use.
"""

__version__ = "0.1.0"
