"""Laser plugin runtime (reference: mythril/laser/plugin/)."""

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.laser.plugin.signals import (
    PluginSignal,
    PluginSkipState,
    PluginSkipWorldState,
)
