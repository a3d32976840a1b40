"""Built-in laser plugins (reference: mythril/laser/plugin/plugins/)."""

from mythril_tpu_torch.laser.plugin.plugins.benchmark import BenchmarkPluginBuilder
from mythril_tpu_torch.laser.plugin.plugins.call_depth_limiter import CallDepthLimitBuilder
from mythril_tpu_torch.laser.plugin.plugins.coverage.coverage_plugin import (
    CoveragePluginBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.dependency_pruner import DependencyPrunerBuilder
from mythril_tpu_torch.laser.plugin.plugins.instruction_profiler import (
    InstructionProfilerBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.mutation_pruner import MutationPrunerBuilder
