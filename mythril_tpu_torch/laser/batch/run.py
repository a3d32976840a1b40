"""Batch run loop: iterate the step until every lane halts.

The JAX package's `_run_impl` runs the step under one jit'd
`lax.while_loop`. Here the loop is Python: while `i < max_steps` and any
lane is RUNNING (one host read per iteration), run `unroll` steps.

`wave_run` is the generic wave entry (the JAX package's, less its
compile-plane lookup, which waits for the port's compile cache) and
`run_resilient` runs `run` under the device-dispatch fault ladder.
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


def wave_run(batch: StateBatch, code: CodeTable, max_steps: int = 4096,
             unroll: int = 1, track_coverage: bool = True):
    """The generic wave entry: `run`, bit for bit. (The JAX package's
    consults its compile plane first; the port has none yet.)"""
    return run(batch, code, max_steps=max_steps, unroll=unroll,
               track_coverage=track_coverage)


def _sync(batch: StateBatch) -> None:
    """Wait for the card, so that an asynchronous CUDA fault surfaces
    inside the caller's containment rather than at a later read."""
    if batch.pc.device.type == "cuda":
        torch.cuda.synchronize(batch.pc.device)


def run_resilient(
    batch: StateBatch,
    code: CodeTable,
    max_steps: int = 4096,
    unroll: int = 1,
    track_coverage: bool = True,
    retries: int = 2,
    allow_split: bool = True,
):
    """`run` under the device-dispatch fault ladder
    (support/resilience.py): CUDA OOM and runtime errors are retried
    with exponential backoff, then — still failing — the batch is split
    in half and each half re-enters THIS function (an OOM'd card often
    carries the reduced capacity), recursing down to single lanes before
    DeviceDispatchError reaches the caller, which degrades the work to
    the host instead of crashing the run. Every attempt runs on the
    batch's own device: nothing falls back to the CPU.

    Every rung of the ladder carries the caller's exact kwargs (`unroll`,
    `track_coverage`), and each attempt synchronizes the card, so an
    asynchronous fault surfaces inside the containment. Logic errors
    propagate untouched — only classified device faults enter the
    ladder."""
    from mythril_tpu_torch.exceptions import DeviceDispatchError
    from mythril_tpu_torch.support.resilience import (
        DegradationLog,
        DegradationReason,
        RetryPolicy,
        retry_device_dispatch,
    )

    policy = RetryPolicy(attempts=retries + 1)

    def _go():
        out, steps = run(
            batch, code, max_steps=max_steps, unroll=unroll,
            track_coverage=track_coverage,
        )
        _sync(out)
        return out, steps

    try:
        return retry_device_dispatch(_go, label="batch-run", policy=policy)
    except DeviceDispatchError:
        n = int(batch.pc.shape[0])
        if not allow_split or n < 2:
            raise
        DegradationLog().record(
            DegradationReason.DEVICE_SPLIT_DISPATCH,
            site="batch-run",
            detail=f"retrying as 2x{n // 2}-lane dispatches",
        )
        half = n // 2
        halves = (
            StateBatch(*(t[:half] for t in batch)),
            StateBatch(*(t[half:] for t in batch)),
        )
        outs, steps = [], 0
        for part in halves:
            out_p, steps_p = run_resilient(
                part, code, max_steps=max_steps, unroll=unroll,
                track_coverage=track_coverage, retries=retries,
                allow_split=allow_split,
            )
            outs.append(out_p)
            steps = max(steps, int(steps_p))
        merged = StateBatch(*(torch.cat([a, b], dim=0) for a, b in zip(*outs)))
        return merged, steps
