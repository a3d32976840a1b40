"""Build of the CUDA sources under csrc/."""
