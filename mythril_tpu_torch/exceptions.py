"""Top-level exception types.

The port's copy of the JAX package's exceptions.py (reference parity:
mythril/exceptions.py:1-48).
"""


class MythrilBaseException(Exception):
    """The base exception for the framework."""


class CompilerError(MythrilBaseException):
    """Solc compilation failed."""


class UnsatError(MythrilBaseException):
    """A solver query had no model (reference: mythril/exceptions.py)."""


class SolverTimeOutException(UnsatError):
    """A solver query timed out (treated as unsat by issue builders)."""


class NoContractFoundError(MythrilBaseException):
    """The supplied input contained no contract."""


class CriticalError(MythrilBaseException):
    """Fatal user-facing error; the CLI prints it and exits."""


class AddressNotFoundError(MythrilBaseException):
    """The searched address was not found."""


class DetectorNotFoundError(MythrilBaseException):
    """An unknown detection module name was requested."""


class IllegalArgumentError(ValueError):
    """An argument combination is invalid."""


# -- resilience taxonomy (support/resilience.py) ---------------------------
# Resource exhaustion and infrastructure faults are first-class
# OUTCOMES of an analysis, not crashes: these types carry the fault to
# the supervisor layer, which degrades the affected lane/contract and
# keeps the corpus running.


class DeadlineExpiredError(MythrilBaseException):
    """The run's wall-clock deadline expired (--deadline with
    --on-timeout=fail; partial mode reports instead of raising)."""


class WatchdogTimeout(MythrilBaseException):
    """A guarded native call wedged past its watchdog budget and was
    abandoned — the callee's state (e.g. a CDCL clause session) must be
    treated as lost and rebuilt."""


class DeviceDispatchError(MythrilBaseException):
    """A device dispatch kept failing after retries and the reduced-
    capacity fallback — the caller degrades the work to the host."""


class InjectedFault(MythrilBaseException):
    """A deterministic fault fired by the injection harness
    (support/resilience.py arm_fault). Never raised in production runs."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}" + (f": {detail}" if detail else ""))
        self.site = site
