"""Plugin control-flow signals (reference:
mythril/laser/plugin/signals.py:1-27)."""


class PluginSignal(Exception):
    """Base signal plugins raise to direct the symbolic VM."""


class PluginSkipWorldState(PluginSignal):
    """Raised in an add_world_state hook: abandon that world state."""


class PluginSkipState(PluginSignal):
    """Raised in a state hook: abandon that path state."""
