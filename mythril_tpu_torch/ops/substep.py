"""The substeps of one specialized loop iteration through the hand-written
CUDA kernel (csrc/substep.cu).

`substep_run(batch, code, table, phases, counts, stack_tid=None)` runs
the `depth` substeps a `step.PhaseSet` asks for after a full step:
`block_depth` block substeps (blockjit.py) when it is > 0, else
`fuse_depth - 1` fused substeps (specialize.py), over `table` (the
block-program or the fuse table, u8 [codes, width]). It updates the
batch's stack, pc, sp, gas bounds and coverage bitmap (and `stack_tid`,
the symbolic shadow's stack, when given) in place and returns the batch;
`counts` (int64 [2] on the batch's device) gains the lanes executed and
the block heads entered.

The kernel replaces no TPU kernel: it is the port of two XLA device
functions, the JAX package's `fused_substep` and `block_substep` (with
their symbolic twins), whose every iteration would otherwise be dozens
of eager launches a substep. On a CPU tensor the wrapper runs the plain
version (`substep_plain`: the plain substeps of specialize.py and
blockjit.py, `depth` times over the batch); on a CUDA tensor it
launches the kernel on the current stream, or raises. `LAUNCHES`
counts the kernel launches, `FUSE_LAUNCHES` and `BLOCK_LAUNCHES` those
of each mode.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from mythril_tpu_torch.native import build

LAUNCHES = 0
FUSE_LAUNCHES = 0
BLOCK_LAUNCHES = 0

#: csrc/substep.cu Params: 24 eight-byte fields, in order
_PARAMS = struct.Struct("24q")
#: the most substeps one launch takes (csrc/substep.cu kMaxDepth)
MAX_DEPTH = 8
#: the most an op may lower sp (csrc/substep.cu kMaxDrop: the kernel's
#: slot index spans the slots an iteration can reach under it)
MAX_DROP = 6

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        lib = build.load("substep")
        if lib.substep_params_bytes() != _PARAMS.size:
            raise RuntimeError("csrc/substep.cu Params does not match ops/substep.py")
        if lib.substep_max_depth() != MAX_DEPTH:
            raise RuntimeError("csrc/substep.cu kMaxDepth does not match ops/substep.py")
        from mythril_tpu_torch.laser.batch.step import _META_NP

        net = _META_NP[:, 3]
        if net.min() < -MAX_DROP or net.max() > 1:
            raise RuntimeError("an opcode's net_sp lies outside [-MAX_DROP, 1], which the "
                               "substep kernel's slot index assumes")
        fn = lib.substep_run
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def plan(phases):
    """(depth, block mode) of a PhaseSet's substeps an iteration."""
    if phases is None:
        return 0, False
    if phases.block_depth > 0:
        return phases.block_depth, True
    return max(0, phases.fuse_depth - 1), False


def substep_plain(batch, code, table, phases, counts, stack_tid=None,
                  track_coverage: bool = True):
    """The plain version: the plain substep, `depth` times over every
    lane, in place."""
    from mythril_tpu_torch.laser.batch.blockjit import block_substep
    from mythril_tpu_torch.laser.batch.specialize import fused_substep

    depth, block = plan(phases)
    for _ in range(depth):
        if block:
            batch, n_exec, n_blocks = block_substep(
                batch, code, table, track_coverage=track_coverage,
                stack_tid=stack_tid, phases=phases)
            counts[1] += n_blocks
        else:
            batch, n_exec = fused_substep(batch, code, table, track_coverage,
                                          stack_tid=stack_tid)
        counts[0] += n_exec
    return batch


def _check(batch, code, table, counts, stack_tid):
    n = batch.pc.shape[0]
    want = [
        ("pc", batch.pc, torch.int32, (n,)), ("sp", batch.sp, torch.int32, (n,)),
        ("status", batch.status, torch.int32, (n,)),
        ("code_id", batch.code_id, torch.int32, (n,)),
        ("gas_min", batch.gas_min, torch.int64, (n,)),
        ("gas_max", batch.gas_max, torch.int64, (n,)),
        ("gas_budget", batch.gas_budget, torch.int64, (n,)),
        ("stack", batch.stack, torch.int32, (n, batch.stack.shape[1], 16)),
        ("pc_seen", batch.pc_seen, torch.int32, (n, batch.pc_seen.shape[1])),
        ("code.ops", code.ops, torch.uint8, tuple(code.ops.shape)),
        ("code.length", code.length, torch.int32, (code.ops.shape[0],)),
        ("table", table, torch.uint8, (code.ops.shape[0], table.shape[-1])),
        ("counts", counts, torch.int64, (2,)),
    ]
    if stack_tid is not None:
        want.append(("stack_tid", stack_tid, torch.int32, (n, batch.stack.shape[1])))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"substep_run: {name} must be a contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if code.ops.shape[1] < 34:
        raise ValueError("substep_run: code.ops rows must hold 33 bytes of padding")


def substep_run(batch, code, table, phases, counts, stack_tid=None,
                track_coverage: bool = True):
    """Run one iteration's substeps in place (see the module docstring).
    Returns the batch."""
    global LAUNCHES, FUSE_LAUNCHES, BLOCK_LAUNCHES
    depth, block = plan(phases)
    if depth == 0:
        return batch
    _check(batch, code, table, counts, stack_tid)
    operands = [batch.pc, batch.stack, code.ops, table, counts]
    if stack_tid is not None:
        operands.append(stack_tid)
    if not build.on_cuda(operands, "substep_run"):
        return substep_plain(batch, code, table, phases, counts, stack_tid, track_coverage)
    if depth > MAX_DEPTH:
        raise ValueError(f"substep_run: {depth} substeps a launch, the kernel takes at most "
                         f"{MAX_DEPTH}")
    if batch.stack.data_ptr() % 16:
        raise ValueError("substep_run: the stack must start on a 16-byte boundary (the "
                         "kernel moves a slot as four 16-byte copies)")
    from mythril_tpu_torch.laser.batch.step import _meta, _unhandled

    dev = batch.pc.device
    meta = _meta(dev)
    # a bool tensor is one byte an element: the kernel reads it as u8
    unhandled = _unhandled(phases, dev) if block and phases.pruned else None
    n = batch.pc.shape[0]
    params = _PARAMS.pack(
        code.ops.data_ptr(), code.ops.shape[1], code.ops.shape[0], code.length.data_ptr(),
        table.data_ptr(), table.shape[1],
        batch.code_id.data_ptr(), batch.pc.data_ptr(), batch.status.data_ptr(),
        batch.sp.data_ptr(), batch.gas_min.data_ptr(), batch.gas_max.data_ptr(),
        batch.gas_budget.data_ptr(), batch.stack.data_ptr(), batch.stack.shape[1],
        0 if stack_tid is None else stack_tid.data_ptr(),
        batch.pc_seen.data_ptr() if track_coverage else 0, batch.pc_seen.shape[1],
        0 if unhandled is None else unhandled.data_ptr(), meta.data_ptr(),
        counts.data_ptr(), n, depth, int(block))
    build.launch(_kernel_fn(), dev.index, params)
    LAUNCHES += 1
    BLOCK_LAUNCHES += block
    FUSE_LAUNCHES += not block
    return batch
