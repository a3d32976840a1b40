"""Per-opcode wall-time profiler.

Covers mythril/laser/plugin/plugins/instruction_profiler.py, with two
deliberate divergences: the reference's builder name collides with the
dependency pruner ("dependency-pruner", a bug flagged in SURVEY.md
§2.1) — here it is "instruction-profiler"; and instead of storing a
(start, end) record per executed instruction, the profiler folds each
duration into a running (count, total, min, max) accumulator, so
memory stays O(#opcodes) on million-instruction runs.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)


class InstructionProfilerBuilder(PluginBuilder):
    plugin_name = "instruction-profiler"

    def __call__(self, *args, **kwargs):
        return InstructionProfiler()


class _OpStats:
    __slots__ = ("count", "total", "lo", "hi")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.lo = float("inf")
        self.hi = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.lo = min(self.lo, seconds)
        self.hi = max(self.hi, seconds)


class InstructionProfiler(LaserPlugin):
    """Times every instruction via the all-opcode instr hooks; logs a
    per-opcode summary when symbolic execution stops."""

    def __init__(self):
        self.stats: Dict[str, _OpStats] = {}
        self._tick = None

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.instr_hook("pre", None)
        def stamp(op_code: str):
            def before(global_state: GlobalState):
                self._tick = time.monotonic()

            return before

        @symbolic_vm.instr_hook("post", None)
        def fold(op_code: str):
            def after(global_state: GlobalState):
                elapsed = time.monotonic() - self._tick
                self.stats.setdefault(op_code, _OpStats()).add(elapsed)

            return after

        @symbolic_vm.laser_hook("stop_sym_exec")
        def report():
            grand_total = sum(s.total for s in self.stats.values())
            if not grand_total:
                return
            lines = [f"Total: {grand_total} s"]
            for op in sorted(self.stats):
                s = self.stats[op]
                lines.append(
                    "[%-12s] %8.4f %%,  nr %6d,  total %8.4f s,"
                    "  avg %8.4f s,  min %8.4f s,  max %8.4f s"
                    % (
                        op,
                        s.total * 100 / grand_total,
                        s.count,
                        s.total,
                        s.total / s.count,
                        s.lo,
                        s.hi,
                    )
                )
            log.info("\n".join(lines) + "\n")
