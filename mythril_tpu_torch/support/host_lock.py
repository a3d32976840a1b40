"""The host symbolic-state lock.

Every piece of host-side symbolic machinery is process-global by
design (reference parity: mythril/support/support_utils.py documents
its singletons as explicitly not thread-safe): the hash-consed term
arena, the incremental CDCL blast session, the model cache. A device
wave, by contrast, touches none of it: a concrete wave and its numpy
readbacks are pure tensor work.

That split is what lets the analysis service (service/engine.py) run
its device waves on one thread while its host pool walks contracts on
others, provided every host walk takes this lock: in-process walks
serialize here. Coarse on purpose: the win is device-vs-host overlap,
not host-vs-host concurrency.

The port's copy of the JAX package's support/host_lock.py.
"""

from __future__ import annotations

import threading

HOST_SYMBOLIC_LOCK = threading.Lock()
