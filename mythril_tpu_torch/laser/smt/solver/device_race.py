"""The chip-occupancy flag of the JAX package's
laser/smt/solver/device_race.py (`DEVICE_BUSY`, `_BusyCounter`). The
race stage itself (`DeviceRace`) comes with the host solver stack."""

from __future__ import annotations

import threading


class _BusyCounter:
    """Reentrant chip-occupancy count. A plain Event breaks under
    nesting: a per-contract explorer finishing inside an overlapped
    corpus prepass would clear the flag the prepass still relies on,
    re-enabling races that queue behind multi-second waves."""

    def __init__(self) -> None:
        self._count = 0
        self._mu = threading.Lock()

    def acquire(self) -> None:
        with self._mu:
            self._count += 1

    def release(self) -> None:
        with self._mu:
            if self._count > 0:
                self._count -= 1

    def is_set(self) -> bool:
        with self._mu:
            return self._count > 0


#: chip-occupancy flag: held (counted) while a device exploration owns
#: the card; races started then would queue behind multi-second waves
#: and answer long after the host solve, so they are not started
DEVICE_BUSY = _BusyCounter()
