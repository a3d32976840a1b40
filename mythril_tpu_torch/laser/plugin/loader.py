"""Singleton plugin loader (reference:
mythril/laser/plugin/loader.py:11-72)."""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Dict, List, Optional

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.support.support_utils import Singleton

if TYPE_CHECKING:
    from mythril_tpu_torch.laser.ethereum.svm import LaserEVM

log = logging.getLogger(__name__)


class LaserPluginLoader(object, metaclass=Singleton):
    """Registry of plugin builders; instruments VMs with the enabled
    set."""

    def __init__(self) -> None:
        self.laser_plugin_builders: Dict[str, PluginBuilder] = {}
        self.plugin_args: Dict[str, Dict] = {}

    def add_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin_builder: PluginBuilder) -> None:
        log.info("Loading laser plugin: %s", plugin_builder.plugin_name)
        if plugin_builder.plugin_name in self.laser_plugin_builders:
            log.warning(
                "Laser plugin with name %s was already loaded, skipping...",
                plugin_builder.plugin_name,
            )
            return
        self.laser_plugin_builders[plugin_builder.plugin_name] = plugin_builder

    def is_enabled(self, plugin_name: str) -> bool:
        if plugin_name not in self.laser_plugin_builders:
            return False
        return self.laser_plugin_builders[plugin_name].enabled

    def enable(self, plugin_name: str):
        if plugin_name not in self.laser_plugin_builders:
            return ValueError(f"Plugin with name: {plugin_name} was not loaded")
        self.laser_plugin_builders[plugin_name].enabled = True

    def instrument_virtual_machine(
        self, symbolic_vm: "LaserEVM", with_plugins: Optional[List[str]]
    ) -> None:
        for plugin_name, plugin_builder in self.laser_plugin_builders.items():
            enabled = (
                plugin_builder.enabled
                if not with_plugins
                else plugin_name in with_plugins
            )
            if not enabled:
                continue
            log.info("Instrumenting symbolic vm with plugin: %s", plugin_name)
            plugin = plugin_builder(**self.plugin_args.get(plugin_name, {}))
            plugin.initialize(symbolic_vm)
