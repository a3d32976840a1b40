"""Global runtime flag bag.

The port's copy of the JAX package's support/support_args.py (reference
parity: mythril/support/support_args.py:1-16): a singleton `args` read
by deep layers without explicit plumbing. It holds the flags the port's
layers read so far; each keeps the JAX package's name and meaning.

`static_prune` defaults to False here: the static pre-analysis
(analysis/static) is not ported, and the explorer raises if it is
asked for. `specialize` is False for the same reason (no specialized
kernels).
"""

from __future__ import annotations

from mythril_tpu_torch.support.support_utils import Singleton


class Args(object, metaclass=Singleton):
    def __init__(self):
        # --parallel-solving: a query the CDCL leaves unknown gets one
        # portfolio search where the analysis runs (one card: several
        # are ROADMAP Queue 1 item 8)
        self.parallel_solving = False
        # Reproducible-report mode (CLI --deterministic-solving):
        # marathon solves get a conflict budget derived from the query
        # timeout instead of running to the wall, and the race is
        # forgone, so verdicts are a pure function of the query whenever
        # the wall valve doesn't fire.
        self.deterministic_solving = False
        # The escalation ladder's wall cap, in seconds, for the host-CDCL
        # pass over one wave's device survivors. Queries past the cap are
        # recorded SPRINT_PREEMPTED with the actual cap and retried next
        # wave; 0 defers every survivor (no host solve).
        # (CLI --sprint-cap-s.)
        self.sprint_cap_s = 5.0
        # Static pre-analysis (analysis/static, CLI --no-static-prune):
        # not ported; True makes the explorer raise NotImplementedError.
        self.static_prune = False
        # Kernel specialization (laser/batch/specialize.py): not ported;
        # True makes the explorer raise NotImplementedError.
        self.specialize = False
        # Pipelined wave engine: up to two waves in flight, the host's
        # evidence consume and flip solving overlapping the card's
        # execution of the next wave. Off = the lock-step schedule.
        # Off by default in the port (on in the JAX package): a wave's
        # step loop holds the GIL, so it measured no faster on the card.
        self.pipeline = False
        # Device ownership (CLI --device-ownership): a contract whose
        # exploration the completeness gates accept is reported from its
        # device evidence alone. auto owns; never would send
        # every contract to the host walk, which is not ported, so the
        # corpus analysis raises on it.
        self.device_ownership = "auto"


args = Args()
