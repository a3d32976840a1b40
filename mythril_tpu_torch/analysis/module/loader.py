"""Singleton registry of detection modules.

Reference parity: mythril/analysis/module/loader.py:30-102 — registers
the 14 built-ins, filters by entry point and whitelist.
"""

from __future__ import annotations

from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.exceptions import DetectorNotFoundError
from mythril_tpu_torch.support.support_utils import Singleton

from mythril_tpu_torch.analysis.module.modules.arbitrary_jump import ArbitraryJump
from mythril_tpu_torch.analysis.module.modules.arbitrary_write import ArbitraryStorage
from mythril_tpu_torch.analysis.module.modules.delegatecall import ArbitraryDelegateCall
from mythril_tpu_torch.analysis.module.modules.dependence_on_origin import TxOrigin
from mythril_tpu_torch.analysis.module.modules.dependence_on_predictable_vars import (
    PredictableVariables,
)
from mythril_tpu_torch.analysis.module.modules.ether_thief import EtherThief
from mythril_tpu_torch.analysis.module.modules.exceptions import Exceptions
from mythril_tpu_torch.analysis.module.modules.external_calls import ExternalCalls
from mythril_tpu_torch.analysis.module.modules.integer import IntegerArithmetics
from mythril_tpu_torch.analysis.module.modules.multiple_sends import MultipleSends
from mythril_tpu_torch.analysis.module.modules.state_change_external_calls import (
    StateChangeAfterCall,
)
from mythril_tpu_torch.analysis.module.modules.suicide import AccidentallyKillable
from mythril_tpu_torch.analysis.module.modules.unchecked_retval import UncheckedRetval
from mythril_tpu_torch.analysis.module.modules.user_assertions import UserAssertions


class ModuleLoader(object, metaclass=Singleton):
    """Loads and filters detection modules; third-party modules register
    through `register_module`."""

    def __init__(self):
        self._modules: List[DetectionModule] = []
        self._register_mythril_modules()

    def register_module(self, detection_module: DetectionModule):
        if not isinstance(detection_module, DetectionModule):
            raise ValueError("The passed variable is not a valid detection module")
        self._modules.append(detection_module)

    def get_detection_modules(
        self,
        entry_point: Optional[EntryPoint] = None,
        white_list: Optional[List[str]] = None,
    ) -> List[DetectionModule]:
        result = self._modules[:]

        if white_list:
            available_names = [type(module).__name__ for module in result]
            for name in white_list:
                if name not in available_names:
                    raise DetectorNotFoundError(
                        "Invalid detection module: {}".format(name)
                    )
            result = [
                module for module in result if type(module).__name__ in white_list
            ]
        if entry_point:
            result = [module for module in result if module.entry_point == entry_point]
        return result

    def _register_mythril_modules(self):
        self._modules.extend(
            [
                ArbitraryJump(),
                ArbitraryStorage(),
                ArbitraryDelegateCall(),
                PredictableVariables(),
                TxOrigin(),
                EtherThief(),
                Exceptions(),
                ExternalCalls(),
                IntegerArithmetics(),
                MultipleSends(),
                StateChangeAfterCall(),
                AccidentallyKillable(),
                UncheckedRetval(),
                UserAssertions(),
            ]
        )
