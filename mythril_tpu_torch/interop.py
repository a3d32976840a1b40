"""Carry state between the JAX package and the port, as numpy arrays.

The port never imports the JAX package; these functions take and give
plain numpy in the JAX package's layout and dtypes: the fields of its
`make_batch(..., as_numpy=True)`, a `jax.device_get` of a final batch,
its CodeTable, its SymBatch, its (lo, hi) uint32 keccak lane pairs, and
its device-prepass outcomes (as JSON).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mythril_tpu_torch.laser.batch.state import (
    CodeTable,
    StateBatch,
    batch_from_fields,
    field_to_numpy,
)
from mythril_tpu_torch.laser.batch.symbolic import SymBatch
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


#: SymBatch fields that are uint32 in the JAX package (limb words, and
#: the saturated call gas that the port holds in int64)
SYM_UINT32_FIELDS = ("ev_a", "ev_b", "ev_gas", "ar_va", "ar_vb")


def symbatch_to_numpy(symb: SymBatch) -> SymBatch:
    """A SymBatch of numpy arrays in the JAX dtypes, field by field (its
    `base` by `batch_to_numpy`; `ar_count` a 0-d int32 array), exactly."""
    rest = [t.detach().cpu().numpy().astype(
                np.uint32 if name in SYM_UINT32_FIELDS else np.int32)
            for name, t in zip(SymBatch._fields[1:], symb[1:])]
    return SymBatch(batch_to_numpy(symb.base), *rest)


def symbatch_from_numpy(fields, device=None) -> SymBatch:
    """A SymBatch on `device` (the card unless named) from a JAX SymBatch
    of numpy arrays (`jax.device_get` of one)."""
    device = resolve_device(device)
    rest = [torch.tensor(np.asarray(arr).astype(np.int64 if name == "ev_gas" else np.int32),
                         device=device)
            for name, arr in zip(SymBatch._fields[1:], tuple(fields)[1:])]
    return SymBatch(batch_from_numpy(fields[0], device), *rest)


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


def outcome_to_json(outcome) -> str:
    """A device-prepass outcome (the JAX package's explorer's or the
    port's) as JSON: sets and tuples become lists (sets sorted), numpy
    scalars plain numbers. `outcome_from_json` reads it back as the
    outcome the host walk takes (`SymExecWrapper(prepass_outcome=)`)."""

    def plain(x):
        if isinstance(x, dict):
            return {str(k): plain(v) for k, v in x.items()}
        if isinstance(x, (set, frozenset)):
            return sorted(plain(v) for v in x)
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, np.generic):
            return x.item()
        return x

    return json.dumps(plain(outcome), sort_keys=True)


def outcome_from_json(text: str) -> dict:
    """The outcome `outcome_to_json` wrote, with `covered_branches` as
    (pc, direction) tuples."""
    outcome = json.loads(text)
    if "covered_branches" in outcome:
        outcome["covered_branches"] = [tuple(b) for b in outcome["covered_branches"]]
    return outcome
