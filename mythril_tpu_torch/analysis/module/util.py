"""Hook-dictionary builder for detection modules.

Reference parity: mythril/analysis/module/util.py:14-43 — supports
plain opcode names and `PREFIX*` wildcards (e.g. `CALL*` hooks every
opcode starting with CALL).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.support.opcodes import OPCODES

log = logging.getLogger(__name__)
OP_CODE_LIST = list(OPCODES.keys())


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type: str = "pre"
) -> Dict[str, List[Callable]]:
    """Map opcode -> [module.execute] for the given modules."""
    hook_dict: Dict[str, List[Callable]] = defaultdict(list)
    for module in modules:
        hooks = module.pre_hooks if hook_type == "pre" else module.post_hooks
        for op_code in map(lambda x: x.upper(), hooks):
            if op_code in OP_CODE_LIST:
                hook_dict[op_code].append(module.execute)
            elif op_code.endswith("*"):
                for actual_hook in filter(
                    lambda x: x.startswith(op_code[:-1]), OP_CODE_LIST
                ):
                    hook_dict[actual_hook].append(module.execute)
            else:
                log.error(
                    "Encountered invalid hook opcode %s in module %s",
                    op_code,
                    module.name,
                )
    return dict(hook_dict)


def reset_callback_modules(module_names: Optional[List[str]] = None) -> None:
    """Clean the issue records of every callback-based module."""
    modules = ModuleLoader().get_detection_modules(EntryPoint.CALLBACK, module_names)
    for module in modules:
        module.reset_module()
