"""Plugin builder interface (reference:
mythril/laser/plugin/builder.py:7-21)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin


class PluginBuilder(ABC):
    """Constructs one plugin instance per instrumented VM."""

    plugin_name = "Default Plugin Name"

    def __init__(self):
        self.enabled = True

    @abstractmethod
    def __call__(self, *args, **kwargs) -> LaserPlugin:
        """Construct the plugin."""
