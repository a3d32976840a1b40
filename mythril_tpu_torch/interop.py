"""Carry state between the JAX package and the port, as numpy arrays.

The port never imports the JAX package; these functions take and give
plain numpy in the JAX package's layout and dtypes: the fields of its
`make_batch(..., as_numpy=True)`, a `jax.device_get` of a final batch,
its CodeTable, and its (lo, hi) uint32 keccak lane pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.state import (
    CodeTable,
    StateBatch,
    batch_from_fields,
    field_to_numpy,
)
from mythril_tpu_torch.support.accel import resolve_device


def batch_from_numpy(fields, device=None) -> StateBatch:
    """A StateBatch on `device` (the card unless named) from a JAX
    StateBatch of numpy arrays (any NamedTuple with the same field
    order)."""
    return batch_from_fields(tuple(fields), resolve_device(device))


def batch_to_numpy(batch: StateBatch) -> StateBatch:
    """A StateBatch of numpy arrays in the JAX dtypes (uint32 words, gas
    and coverage; uint8 bytes; int32 scalars; bool none), exactly."""
    return StateBatch(*(field_to_numpy(name, t)
                        for name, t in zip(StateBatch._fields, batch)))


def code_table_from_numpy(table, device=None) -> CodeTable:
    """The port's CodeTable from the JAX one's (ops, jumpdest, length)."""
    device = resolve_device(device)
    ops, jumpdest, length = (np.asarray(x) for x in table)
    return CodeTable(
        torch.tensor(ops.astype(np.uint8), device=device),
        torch.tensor(jumpdest.astype(bool), device=device),
        torch.tensor(length.astype(np.int32), device=device),
    )


def lanes_from_lohi(lo, hi, device=None) -> torch.Tensor:
    """(lo, hi) uint32 keccak lane pairs -> int64 lanes (lo | hi << 32)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    lanes = (lo | (hi << np.uint64(32))).view(np.int64)
    return torch.tensor(lanes, device=resolve_device(device))


def lanes_to_lohi(lanes: torch.Tensor):
    """int64 lanes -> (lo, hi) numpy uint32 pairs."""
    u = lanes.detach().cpu().numpy().view(np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))
