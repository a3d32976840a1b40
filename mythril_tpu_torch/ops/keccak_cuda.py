"""keccak through the hand-written CUDA kernels (csrc/keccak_f.cu).

The port's counterparts of the JAX package's Pallas kernel
(ops/keccak_pallas.py):

- `keccak_f(state)`: keccak-f[1600] on ``[..., 25]`` int64 lanes;
- `keccak_sponge(mem, off, length, ok)`: the EVM step's whole SHA3
  phase, keccak-256 of ``mem[lane, off:off+length]`` for every lane
  where `ok` is set, as a u256 limb word ``[N, 16]`` int32 (zero
  elsewhere), in one launch.

On a CPU tensor each runs its plain PyTorch version (`ops.keccak.keccak_f`,
`ops.keccak.keccak_sponge_plain`); on a CUDA tensor it launches the
kernel on the current stream, or raises. It never moves a CUDA tensor to
the plain path.

`LAUNCHES` counts the keccak_f1600 launches made through this module,
`SPONGE_LAUNCHES` the keccak_sponge launches.
"""

from __future__ import annotations

import ctypes

import torch

from mythril_tpu_torch.native import build
from mythril_tpu_torch.ops import keccak as _plain

LAUNCHES = 0
SPONGE_LAUNCHES = 0

_FNS = {}


def _kernel_fn(name):
    fn = _FNS.get(name)
    if fn is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn = getattr(build.load("keccak_f"), name)
        fn.argtypes = {
            "keccak_f1600": [p, p, ll, p],
            "keccak_sponge": [p, ll, ll, p, p, p, p, ll, ctypes.c_int, p],
        }[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] on [..., 25] int64 lanes."""
    global LAUNCHES
    if state.dtype != torch.int64 or state.shape[-1] != 25:
        raise ValueError(
            f"keccak_f wants [..., 25] int64 lanes, got {tuple(state.shape)} "
            f"{state.dtype}")
    if not build.on_cuda([state], "keccak_f"):
        return _plain.keccak_f(state)
    if not state.is_contiguous():
        raise ValueError("keccak_f wants a contiguous state")
    out = torch.empty_like(state)
    n = state.numel() // 25
    if n == 0:
        return out
    build.launch(_kernel_fn("keccak_f1600"), state.get_device(), state.data_ptr(),
                 out.data_ptr(), n)
    LAUNCHES += 1
    return out


def keccak_sponge(mem: torch.Tensor, off: torch.Tensor, length: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """keccak-256 of mem[lane, off:off+length] where ok[lane], as a u256
    limb word [N, 16] int32; zero where ok is not set. mem is [N, C]
    uint8, off and length int32 [N], ok bool [N]. Bytes past the row's
    end read as zero; a length outside [0, 136 * SPONGE_MAX_BLOCKS)
    hashes nothing and gives zero."""
    global SPONGE_LAUNCHES
    shape = mem.shape
    if mem.dtype != torch.uint8 or len(shape) != 2:
        raise ValueError(f"mem must be uint8 [N, C], got {tuple(shape)} {mem.dtype}")
    n = shape[0]
    if (off.dtype, length.dtype, ok.dtype) != (torch.int32, torch.int32, torch.bool) or not (
            off.shape == length.shape == ok.shape == (n,)):
        raise ValueError(
            f"off, length and ok must be int32, int32 and bool [{n}], got "
            f"{off.dtype} {tuple(off.shape)}, {length.dtype} {tuple(length.shape)}, "
            f"{ok.dtype} {tuple(ok.shape)}")
    if not build.on_cuda([mem, off, length, ok], "keccak_sponge"):
        return _plain.keccak_sponge_plain(mem, off, length, ok)
    if mem.stride(1) != 1 or not (off.is_contiguous() and length.is_contiguous()
                                  and ok.is_contiguous()):
        raise ValueError("keccak_sponge wants rows of contiguous bytes and contiguous "
                         "off, length and ok")
    out = torch.empty((n, 16), dtype=torch.int32, device=mem.device)
    if n == 0:
        return out
    build.launch(_kernel_fn("keccak_sponge"), mem.get_device(), mem.data_ptr(),
                 mem.stride(0), shape[1], off.data_ptr(), length.data_ptr(), ok.data_ptr(),
                 out.data_ptr(), n, _plain.SPONGE_MAX_BLOCKS)
    SPONGE_LAUNCHES += 1
    return out
