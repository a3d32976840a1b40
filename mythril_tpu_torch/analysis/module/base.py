"""DetectionModule interface.

Reference parity: mythril/analysis/module/base.py:29-94 — modules
declare name/swc_id/description, an entry point (CALLBACK modules hook
opcodes; POST modules scan the finished statespace), and pre/post hook
opcode lists; `execute(target)` is the engine-facing entry.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from enum import Enum
from typing import List, Optional, Set

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    """POST modules scan the statespace after execution; CALLBACK
    modules run from opcode hooks during execution (preferred — POST
    slows the analysis down)."""

    POST = 1
    CALLBACK = 2


class DetectionModule(ABC):
    """Base class for every detection rule."""

    name = "Detection Module Name / Title"
    swc_id = "SWC-000"
    description = "Detection module description"
    entry_point: EntryPoint = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []

    def __init__(self) -> None:
        self.issues: List[Issue] = []
        self.cache: Set[int] = set()

    def reset_module(self):
        # also drop the dedupe cache: it scopes one analysis, and a
        # long-lived process (corpus mode, tests) would otherwise
        # suppress identical addresses across unrelated contracts
        # (the reference only clears `issues`, which leaks exactly that
        # way when its API is driven in-process)
        self.issues = []
        self.cache = set()

    def execute(self, target: GlobalState) -> Optional[List[Issue]]:
        from mythril_tpu_torch.observe.querylog import query_context

        log.debug("Entering analysis module: %s", self.__class__.__name__)
        # solver queries issued inside a module carry the "module"
        # origin in the query flight recorder (observe/querylog.py)
        with query_context("module"):
            result = self._execute(target)
        log.debug("Exiting analysis module: %s", self.__class__.__name__)
        return result

    @abstractmethod
    def _execute(self, target) -> Optional[List[Issue]]:
        """Module main method (override this)."""

    def __repr__(self) -> str:
        return (
            "<DetectionModule name={0.name} swc_id={0.swc_id} "
            "pre_hooks={0.pre_hooks} post_hooks={0.post_hooks} "
            "description={0.description}>"
        ).format(self)
