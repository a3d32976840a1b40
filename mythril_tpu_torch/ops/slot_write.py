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

Two forms, one kernel:

- `slot_write(buf, idx, mask, val)` writes one table; a second write
  ``(idx2, mask2, val2)`` may ride the same call, and where both land
  on one slot the second wins (the JAX step's nesting: the result slot
  over SWAP's deep slot);
- `slot_write_many(idx, mask, [(buf, val), ...])` writes up to
  `MAX_TABLES` tables that share one ``(idx, mask)``, each with its own
  dtype, slot count and row, in one launch.

On a CPU tensor each runs its plain PyTorch version (`slot_write_plain`,
`slot_write_many_plain`); on a CUDA tensor it launches the kernel on the
current stream, or raises. It never moves a CUDA tensor to the plain
path. `LAUNCHES` counts the kernel launches of both forms,
`MANY_LAUNCHES` those of `slot_write_many`.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from mythril_tpu_torch.native import build

LAUNCHES = 0
MANY_LAUNCHES = 0

DTYPES = (torch.uint8, torch.int32, torch.int64)
MAX_TABLES = 8
#: a lane's row elements over all its tables: the kernel gives each
#: vector of a lane's rows a thread of one block
MAX_ROW_ELEMENTS = 1024

_DESC = struct.Struct("13q")  # csrc/slot_write.cu kDescWords

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("slot_write").slot_write_many
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, p, p, p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check_index(idx, mask, n):
    if idx.dtype != torch.int64 or idx.shape != (n,):
        raise ValueError(f"idx must be int64 [{n}], got {tuple(idx.shape)} {idx.dtype}")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"mask must be bool [{n}], got {tuple(mask.shape)} {mask.dtype}")


def _check_table(buf, val, n):
    """The row's element count of one (buf, val) table of n lanes."""
    shape = buf.shape
    if buf.dtype not in DTYPES or not 2 <= len(shape) <= 3 or shape[0] != n:
        raise ValueError(
            f"slot_write wants an [{n}, S] or [{n}, S, W] uint8/int32/int64 buffer, "
            f"got {tuple(shape)} {buf.dtype}")
    if val.dtype != buf.dtype or val.shape != (n,) + shape[2:]:
        raise ValueError(f"val must be {buf.dtype} {(n,) + tuple(shape[2:])}, got "
                         f"{tuple(val.shape)} {val.dtype}")
    return shape[2] if len(shape) == 3 else 1


def _writes(idx, mask, val, idx2, mask2, val2):
    out = [(idx, mask, val)]
    if idx2 is not None or mask2 is not None or val2 is not None:
        if idx2 is None or mask2 is None or val2 is None:
            raise ValueError("a second write needs idx2, mask2 and val2")
        out.append((idx2, mask2, val2))
    return out


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


def slot_write_many_plain(idx, mask, tables):
    """The plain version of `slot_write_many`: `slot_write_plain` table
    by table."""
    for buf, val in tables:
        slot_write_plain(buf, idx, mask, val)


def _desc(buf, val, val2):
    """One table's descriptor for the kernel: pointers, byte strides, the
    slot count and the row as `vecs` vectors of `width` bytes. A row that
    is contiguous in the buffer and in its values moves in the widest
    vector (16, 8, 4, 2 or 1 B) that every base and stride allows, any
    other row element by element."""
    esz = buf.element_size()
    shape = buf.shape
    b_lane, b_slot, *b_row = buf.stride()
    v_lane, *v_row = val.stride()
    ptr_b, ptr_v = buf.data_ptr(), val.data_ptr()
    w = shape[2] if len(shape) == 3 else 1
    contiguous = w == 1 or (b_row[0] == 1 and v_row[0] == 1)
    if val2 is None:
        ptr_v2 = v2_lane = v2_elem = 0
    else:
        v2_lane, *v2_row = val2.stride()
        ptr_v2 = val2.data_ptr()
        contiguous = contiguous and (w == 1 or v2_row[0] == 1)
        v2_lane *= esz
        v2_elem = v2_row[0] * esz if w > 1 else esz
    b_lane, b_slot, v_lane = b_lane * esz, b_slot * esz, v_lane * esz
    if contiguous:
        g = math.gcd(w * esz, ptr_b, ptr_v, ptr_v2, b_lane, b_slot, v_lane, v2_lane)
        width = min(16, g & -g)
        return _DESC.pack(ptr_b, ptr_v, ptr_v2, b_lane, b_slot, width, v_lane, width,
                          v2_lane, width if val2 is not None else 0, shape[1],
                          w * esz // width, width)
    return _DESC.pack(ptr_b, ptr_v, ptr_v2, b_lane, b_slot, b_row[0] * esz, v_lane,
                      v_row[0] * esz, v2_lane, v2_elem, shape[1], w, esz)


def _launch(idx, mask, idx2, mask2, tables, row_elems, many=False):
    """Launch the kernel on `tables` = [(buf, val, val2 or None), ...],
    whose rows hold `row_elems` elements per lane in all; `many` marks a
    `slot_write_many` launch. No lanes, no launch."""
    global LAUNCHES, MANY_LAUNCHES
    if row_elems > MAX_ROW_ELEMENTS:
        raise ValueError(f"slot_write: {row_elems} row elements per lane; at most "
                         f"{MAX_ROW_ELEMENTS} fit one block")
    if not (idx.is_contiguous() and mask.is_contiguous()
            and (idx2 is None or (idx2.is_contiguous() and mask2.is_contiguous()))):
        raise ValueError("slot_write wants contiguous idx and mask")
    n = idx.shape[0]
    if n == 0:
        return
    build.launch(_kernel_fn(), idx.get_device(), len(tables),
                 b"".join(_desc(*t) for t in tables), idx.data_ptr(), mask.data_ptr(),
                 None if idx2 is None else idx2.data_ptr(),
                 None if mask2 is None else mask2.data_ptr(), n)
    LAUNCHES += 1
    MANY_LAUNCHES += many


def slot_write(buf, idx, mask, val, idx2=None, mask2=None, val2=None):
    """buf[lane, idx[lane]] = val[lane] where mask[lane], in place (and a
    second write that wins a tie). Returns `buf`."""
    n = buf.shape[0] if buf.dim() else -1
    operands = [buf]
    for i, m, v in _writes(idx, mask, val, idx2, mask2, val2):
        _check_index(i, m, n)
        row = _check_table(buf, v, n)
        operands += (i, m, v)
    if not build.on_cuda(operands, "slot_write"):
        return slot_write_plain(buf, idx, mask, val, idx2, mask2, val2)
    _launch(idx, mask, idx2, mask2, [(buf, val, val2)], row)
    return buf


def slot_write_many(idx, mask, tables):
    """buf[lane, idx[lane]] = val[lane] where mask[lane], in place, for
    every (buf, val) of `tables` (at most MAX_TABLES, one launch)."""
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"slot_write_many takes 1 to {MAX_TABLES} tables, got {len(tables)}")
    n = idx.shape[0] if idx.dim() else -1
    _check_index(idx, mask, n)
    row_elems = sum(_check_table(buf, val, n) for buf, val in tables)
    operands = [idx, mask, *(t for table in tables for t in table)]
    if not build.on_cuda(operands, "slot_write_many"):
        slot_write_many_plain(idx, mask, tables)
        return
    _launch(idx, mask, None, None, [(buf, val, None) for buf, val in tables], row_elems,
            many=True)
