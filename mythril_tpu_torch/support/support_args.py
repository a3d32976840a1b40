"""Global runtime flag bag.

The port's copy of the JAX package's support/support_args.py (reference
parity: mythril/support/support_args.py:1-16): a singleton `args` read
by deep layers without explicit plumbing. It holds the flags the port's
layers read so far; each keeps the JAX package's name and meaning.

`static_prune` and `static_answer` default to True, as in the JAX
package: `analyze` runs the static pass (analysis/static) unless the
caller passes --no-static-prune. `specialize` and `blockjit` default to
True, as in the JAX package: the explorer's waves run the
contract-specialized loop with block substeps unless the caller passes
--no-specialize or --no-blockjit.
"""

from __future__ import annotations

from mythril_tpu_torch.support.support_utils import Singleton


class Args(object, metaclass=Singleton):
    def __init__(self):
        # the host walk's knobs (CLI --solver-timeout, --call-depth-limit,
        # --enable-iprof); the JAX package's names and defaults
        self.solver_timeout = 10_000  # ms per query
        self.call_depth_limit = 3
        self.iprof = False
        # the device exploration before the host walk of one contract
        # (analysis/symbolic.py:SymExecWrapper) when no outcome is
        # injected: "auto" runs it on the wrapper's device, "never"
        # walks without it
        self.device_prepass = "auto"
        # its lanes a wave and its wall budget in seconds (CLI
        # --device-prepass-budget)
        self.device_prepass_lanes = 128
        self.device_prepass_budget = 12.0
        # the card's portfolio race beside the host CDCL marathon
        # (laser/smt/solver/solver.py, CLI --device-solving): "auto" and
        # "always" race wherever no exploration holds the card, "never"
        # starts none. The analyzer facade sets "never" for a walk while
        # its overlapped corpus prepass owns the card.
        self.device_solving = "auto"
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
        # CFG recovery + constant dataflow once per code hash, feeding
        # the detector pre-screen, the dispatcher-seed mask, and the
        # flip-frontier prune. On by default; the flag exists so a
        # suspected wrong prune is one switch away from a differential.
        self.static_prune = True
        # Static-answer triage tier (analysis/static taint + screen):
        # a contract whose semantic screen proves NO detection module
        # can fire is answered with an empty issue set at corpus
        # dispatch: no device, no walk. Rides the static_prune flag
        # (off under --no-static-prune) plus this knob (`serve
        # --no-static-answer`; analysis/corpus.py:analyze_corpus reads it).
        self.static_answer = True
        # Kernel specialization (laser/batch/specialize.py, CLI
        # --no-specialize): per-contract phase pruning plus superblock
        # fusion in the explorer's waves. On by default.
        self.specialize = True
        # Block-level JIT (laser/batch/blockjit.py, CLI --no-blockjit,
        # env MYTHRIL_NO_BLOCKJIT): block substeps instead of fused ones
        # where the contracts' lowered density pays. On by default.
        self.blockjit = True
        # Pipelined wave engine: up to two waves in flight, the host's
        # evidence consume and flip solving overlapping the card's
        # execution of the next wave. Off = the lock-step schedule.
        # Off by default in the port (on in the JAX package): a wave's
        # step loop holds the GIL, so it measured no faster on the card.
        self.pipeline = False
        # Device ownership (CLI --device-ownership): a contract whose
        # exploration the completeness gates accept is reported from its
        # device evidence alone. auto owns; never sends every contract
        # to the host walk, with its prepass outcome injected.
        self.device_ownership = "auto"
        # Tier circuit breakers (support/breaker.py, `serve
        # --no-breakers`): the explorer's device-solve tier and the
        # analysis service's device and kernel tiers. On by default.
        self.breakers = True
        # The run's wall-clock budget and what its expiry produces (CLI
        # --deadline, --on-timeout), mirrored here by the analyzer facade
        # for observability: the deep layers read the deadline itself
        # from support/resilience.py:run_deadline().
        self.run_deadline_s = None
        self.on_timeout = "partial"


args = Args()
