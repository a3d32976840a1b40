from mythril_tpu_torch.mythril.mythril_analyzer import MythrilAnalyzer  # noqa: F401
from mythril_tpu_torch.mythril.mythril_disassembler import (  # noqa: F401
    MythrilDisassembler,
)
