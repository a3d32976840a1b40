from mythril_tpu_torch.laser.plugin.plugins.coverage.coverage_plugin import (
    CoveragePluginBuilder,
    InstructionCoveragePlugin,
)
