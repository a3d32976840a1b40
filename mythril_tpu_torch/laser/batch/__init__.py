"""Batched concrete EVM interpreter (PyTorch)."""

from mythril_tpu_torch.laser.batch.state import (  # noqa: F401
    CodeTable,
    StateBatch,
    Status,
    make_batch,
    make_code_table,
)
from mythril_tpu_torch.laser.batch.step import step  # noqa: F401
from mythril_tpu_torch.laser.batch.run import run  # noqa: F401
