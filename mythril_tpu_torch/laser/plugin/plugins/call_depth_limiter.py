"""Call-depth limiter (reference:
mythril/laser/plugin/plugins/call_depth_limiter.py:8-30): abandon
states that would nest calls deeper than the limit."""

from __future__ import annotations

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.signals import PluginSkipWorldState


class CallDepthLimitBuilder(PluginBuilder):
    plugin_name = "call-depth-limit"

    def __call__(self, *args, **kwargs):
        return CallDepthLimit(kwargs["call_depth_limit"])


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.pre_hook("CALL")
        def call_depth_hook(global_state: GlobalState):
            if len(global_state.transaction_stack) - 1 == self.call_depth_limit:
                raise PluginSkipWorldState
