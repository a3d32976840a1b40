"""Laser plugin interface (reference:
mythril/laser/plugin/interface.py:4-23)."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from mythril_tpu_torch.laser.ethereum.svm import LaserEVM


class LaserPlugin:
    """A unit of optional engine functionality; `initialize` is called
    with the VM and typically registers hooks. Plugins direct the engine
    by raising the signals in signals.py."""

    def initialize(self, symbolic_vm: "LaserEVM") -> None:
        raise NotImplementedError
