"""Batch run loop: iterate the step until every lane halts.

The JAX package's `_run_impl` runs the step under one jit'd
`lax.while_loop`. Here the loop is Python: while `i < max_steps` and any
lane is RUNNING (one host read per iteration), run `unroll` steps.
"""

from __future__ import annotations

import torch

from mythril_tpu_torch.laser.batch.state import CodeTable, StateBatch, Status
from mythril_tpu_torch.laser.batch.step import step
from mythril_tpu_torch.support import hostsync


def _any_running(batch: StateBatch) -> bool:
    return bool(hostsync.read(torch.any(batch.status == Status.RUNNING)))


def run(batch: StateBatch, code: CodeTable, max_steps: int = 4096,
        unroll: int = 1, track_coverage: bool = True):
    """Run all lanes to completion (or step budget). Returns
    (final_batch, steps_executed).

    The batch is copied once on entry and the copy is stepped in place,
    so the caller's batch is left as it was. `steps_executed` counts in
    multiples of `unroll`, as the JAX loop does."""
    b = StateBatch(*(t.clone() for t in batch))
    i = 0
    while i < max_steps and _any_running(b):
        for _ in range(unroll):
            b = step(b, code, track_coverage=track_coverage)
        i += unroll
    return b, i
