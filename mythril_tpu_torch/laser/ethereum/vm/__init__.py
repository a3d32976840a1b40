"""The table-driven symbolic EVM.

Importing this package populates the opcode TABLE (each semantics
module registers its handlers on import) and exposes the `Instruction`
facade the engine and tests drive. Covers the reference's full
instruction surface (mythril/laser/ethereum/instructions.py) with a
registry + combinator layout instead of a 2.4k-line handler class.
"""

from __future__ import annotations

import logging
from typing import Callable, List

from mythril_tpu_torch.laser.ethereum.vm import core
from mythril_tpu_torch.laser.ethereum.vm import (  # noqa: F401  (handler registration)
    context,
    data,
    flow,
    stackops,
    syscalls,
)
from mythril_tpu_torch.laser.ethereum.vm.core import TABLE, canonical, run_opcode
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame
from mythril_tpu_torch.laser.ethereum.vm.syscalls import transfer_ether

log = logging.getLogger(__name__)

__all__ = ["Instruction", "transfer_ether", "TABLE", "run_opcode", "Frame"]


class Instruction:
    """One opcode bound to its hooks; `evaluate` produces successor
    states. Resume mode (`post=True`) runs the `/post` half of the
    CALL/CREATE family after a nested frame returns."""

    def __init__(
        self,
        op_code: str,
        dynamic_loader,
        pre_hooks: List[Callable] = None,
        post_hooks: List[Callable] = None,
    ) -> None:
        self.op_code = op_code.upper()
        self.dynamic_loader = dynamic_loader
        self._before = list(pre_hooks or ())
        self._after = list(post_hooks or ())

    def evaluate(self, global_state, post: bool = False) -> List:
        log.debug(
            "Executing %s at pc=%d", self.op_code, global_state.mstate.pc
        )
        for hook in self._before:
            hook(global_state)
        successors = run_opcode(
            self.op_code, global_state, loader=self.dynamic_loader, post=post
        )
        for hook in self._after:
            hook(global_state)
        return successors
