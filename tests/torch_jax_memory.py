"""Give back the JAX package's compiled programs after a port test module.

The port's parity tests run JAX functions beside the port's on the CPU,
and JAX keeps every compiled executable for the life of the process. A
test worker runs many modules one after another, so a module that
imports `release_jax_executables` (an autouse, module-scoped fixture)
drops JAX's caches and returns the freed heap to the system when it
ends: 1-2 GB for each of the modules that compile JAX waves and steps.
What the tests check does not change; a later module that needs a
released program compiles it again (from the persistent compile cache
where the suite's conftest keeps one).
"""

import ctypes
import gc
import sys

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    yield
    jax = sys.modules.get("jax")
    if jax is None:
        return
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass  # not glibc: the freed heap stays with the process
