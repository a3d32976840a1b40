"""Tensor arithmetic and hashing, with the hand-written kernels' wrappers."""
