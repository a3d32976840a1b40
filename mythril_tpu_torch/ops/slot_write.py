"""Per-lane slot write through the hand-written CUDA kernel (csrc/slot_write.cu).

For every lane whose mask is set, ``buf[lane, idx[lane], ...] =
val[lane, ...]``, in place. It is the port's counterpart of the JAX
package's Pallas probe kernel (tools/pallas_stack_probe.py:62,
`make_pallas_write`) and of the one-hot merges that the JAX step and
shadow pass use for the same function (step.py's consolidated stack
write, symbolic.py `_scatter2`, the branch journal and the evidence
banks).

- ``buf`` is ``[N, S]`` or ``[N, S, W]``, uint8, int32 or int64;
- ``idx`` is int64 ``[N]``; an index outside ``[0, S)`` writes nothing,
  as the one-hot merge does;
- ``mask`` is bool ``[N]``;
- ``val`` has ``buf``'s dtype and shape ``[N]`` or ``[N, W]``; it may
  be a strided view.

A second write ``(idx2, mask2, val2)`` may ride the same call; where
both land on one slot the second wins (the JAX step's nesting: the
result slot over SWAP's deep slot).

`slot_write` runs the plain PyTorch version (`slot_write_plain`) on a
CPU tensor and launches the kernel on the current stream for a CUDA
tensor, or raises. It never moves a CUDA tensor to the plain path.
`LAUNCHES` counts the kernel launches made through it.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0

DTYPES = (torch.uint8, torch.int32, torch.int64)

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from mythril_tpu_torch.native import build

        fn = build.load("slot_write").slot_write
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ctypes.c_int, ll, ll, ll, ll, ll, ll,
                       p, p, p, ll, ll,
                       p, p, p, ll, ll,
                       p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _writes(idx, mask, val, idx2, mask2, val2):
    out = [(idx, mask, val)]
    if idx2 is not None or mask2 is not None or val2 is not None:
        if idx2 is None or mask2 is None or val2 is None:
            raise ValueError("a second write needs idx2, mask2 and val2")
        out.append((idx2, mask2, val2))
    return out


def _check(buf, writes):
    if buf.dim() not in (2, 3) or buf.dtype not in DTYPES:
        raise ValueError(
            f"slot_write wants an [N, S] or [N, S, W] uint8/int32/int64 buffer, "
            f"got {tuple(buf.shape)} {buf.dtype}")
    n = buf.shape[0]
    row = tuple(buf.shape[2:])
    for idx, mask, val in writes:
        if idx.dtype != torch.int64 or tuple(idx.shape) != (n,):
            raise ValueError(f"idx must be int64 [{n}], got {tuple(idx.shape)} {idx.dtype}")
        if mask.dtype != torch.bool or tuple(mask.shape) != (n,):
            raise ValueError(f"mask must be bool [{n}], got {tuple(mask.shape)} {mask.dtype}")
        if val.dtype != buf.dtype or tuple(val.shape) != (n,) + row:
            raise ValueError(
                f"val must be {buf.dtype} {(n,) + row}, got {tuple(val.shape)} {val.dtype}")
        for t in (idx, mask, val):
            if t.device != buf.device:
                raise ValueError(f"slot_write operands on {t.device} and {buf.device}")


def slot_write_plain(buf, idx, mask, val, idx2=None, mask2=None, val2=None):
    """The plain PyTorch version: one gather + where + index_put per
    write, in order, so a second write to the same slot wins."""
    n, s = buf.shape[:2]
    lanes = torch.arange(n, device=buf.device)
    for i, m, v in _writes(idx, mask, val, idx2, mask2, val2):
        ok = m & (i >= 0) & (i < s)
        slot = i.clamp(0, s - 1)
        cur = buf[lanes, slot]
        buf[lanes, slot] = torch.where(ok.reshape((n,) + (1,) * (buf.dim() - 2)), v, cur)
    return buf


def slot_write(buf, idx, mask, val, idx2=None, mask2=None, val2=None):
    """buf[lane, idx[lane]] = val[lane] where mask[lane], in place (and a
    second write that wins a tie). Returns `buf`."""
    global LAUNCHES
    writes = _writes(idx, mask, val, idx2, mask2, val2)
    _check(buf, writes)
    if buf.device.type == "cpu":
        return slot_write_plain(buf, idx, mask, val, idx2, mask2, val2)
    if buf.device.type != "cuda":
        raise ValueError(f"slot_write runs on cpu or cuda, not {buf.device}")
    n, s = buf.shape[:2]
    w = buf.shape[2] if buf.dim() == 3 else 1
    esz = buf.element_size()
    b_elem = buf.stride(2) * esz if buf.dim() == 3 else 0
    args = []
    for i, m, v in writes + [(None, None, None)] * (2 - len(writes)):
        if i is None:
            args += [None, None, None, 0, 0]
            continue
        if not (i.is_contiguous() and m.is_contiguous()):
            raise ValueError("slot_write wants contiguous idx and mask")
        v_elem = v.stride(1) * esz if v.dim() == 2 else 0
        args += [i.data_ptr(), m.data_ptr(), v.data_ptr(), v.stride(0) * esz, v_elem]
    if n == 0:
        return buf
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = _kernel_fn()(buf.data_ptr(), esz, n, s, w, buf.stride(0) * esz,
                          buf.stride(1) * esz, b_elem, *args, stream)
    if rc != 0:
        raise RuntimeError(f"slot_write launch failed: cudaError {rc}")
    LAUNCHES += 1
    return buf
