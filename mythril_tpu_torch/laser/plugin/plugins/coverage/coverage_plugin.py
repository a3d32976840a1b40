"""Instruction-coverage measurement.

Covers mythril/laser/plugin/plugins/coverage/coverage_plugin.py: which
fraction of each bytecode's instructions ever executed. Rather than a
boolean mask per bytecode, coverage is a set of executed instruction
indices per code blob — same percentages, O(executed) memory, and the
index set doubles as the uncovered-frontier query the coverage-guided
strategy needs. (Unsound under sparse pruning, as in the reference.)
"""

from __future__ import annotations

import logging
from typing import Dict

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)


class CoveragePluginBuilder(PluginBuilder):
    plugin_name = "coverage"

    def __call__(self, *args, **kwargs):
        return InstructionCoveragePlugin()


class CodeCoverage:
    """Executed-instruction indices for one bytecode."""

    __slots__ = ("total", "seen")

    def __init__(self, total: int):
        self.total = total
        self.seen = set()

    @property
    def percentage(self) -> float:
        return len(self.seen) / float(self.total) * 100 if self.total else 0.0

    def __iter__(self):  # (total, mask) view for reporting/tests
        yield self.total
        yield [i in self.seen for i in range(self.total)]


class InstructionCoveragePlugin(LaserPlugin):
    """Records the pc of every executed state, keyed by bytecode."""

    def __init__(self):
        self.coverage: Dict[str, CodeCoverage] = {}
        self._tx_base = 0
        self._tx_no = 0

    def _touched(self) -> int:
        return sum(len(cc.seen) for cc in self.coverage.values())

    def initialize(self, symbolic_vm) -> None:
        self.coverage = {}
        self._tx_base = 0
        self._tx_no = 0

        @symbolic_vm.laser_hook("execute_state")
        def mark(global_state: GlobalState):
            code = global_state.environment.code.bytecode
            cc = self.coverage.get(code)
            if cc is None:
                cc = CodeCoverage(
                    len(global_state.environment.code.instruction_list)
                )
                self.coverage[code] = cc
            if global_state.mstate.pc < cc.total:
                cc.seen.add(global_state.mstate.pc)

        @symbolic_vm.laser_hook("start_sym_trans")
        def tx_begin():
            self._tx_base = self._touched()

        @symbolic_vm.laser_hook("stop_sym_trans")
        def tx_end():
            log.info(
                "Number of new instructions covered in tx %d: %d",
                self._tx_no,
                self._touched() - self._tx_base,
            )
            self._tx_no += 1

        @symbolic_vm.laser_hook("stop_sym_exec")
        def summarize():
            for code, cc in self.coverage.items():
                if cc.total:
                    log.info(
                        "Achieved %.2f%% coverage for code: %s",
                        cc.percentage,
                        code,
                    )

    def is_instruction_covered(self, bytecode, index) -> bool:
        cc = self.coverage.get(bytecode)
        return cc is not None and index in cc.seen
