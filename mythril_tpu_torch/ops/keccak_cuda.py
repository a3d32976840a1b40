"""keccak-f[1600] through the hand-written CUDA kernel (csrc/keccak_f.cu).

The port's counterpart of the JAX package's Pallas kernel
(ops/keccak_pallas.py). `keccak_f(state)` takes ``[..., 25]`` int64
lanes. On a CPU tensor it runs the plain PyTorch version
(`ops.keccak.keccak_f`); on a CUDA tensor it launches the kernel on the
current stream, or raises. It never moves a CUDA tensor to the plain
path.

`LAUNCHES` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from mythril_tpu_torch.ops import keccak as _plain

LAUNCHES = 0

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from mythril_tpu_torch.native import build

        fn = build.load("keccak_f").keccak_f1600
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] on [..., 25] int64 lanes."""
    global LAUNCHES
    if state.dtype != torch.int64 or state.shape[-1] != 25:
        raise ValueError(
            f"keccak_f wants [..., 25] int64 lanes, got {tuple(state.shape)} "
            f"{state.dtype}")
    if state.device.type == "cpu":
        return _plain.keccak_f(state)
    if state.device.type != "cuda":
        raise ValueError(f"keccak_f runs on cpu or cuda, not {state.device}")
    if not state.is_contiguous():
        raise ValueError("keccak_f wants a contiguous state")
    out = torch.empty_like(state)
    n = state.numel() // 25
    if n == 0:
        return out
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _kernel_fn()(state.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"keccak_f1600 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
