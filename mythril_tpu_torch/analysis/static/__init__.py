"""Host-side static bytecode analysis (the pre-dispatch layer).

Cooperating analyses over one shared IR (the disassembler's
instruction list), run once per code hash BEFORE any arena lane is
seeded or any detection module is mounted:

1. **CFG recovery** (`cfg.py`) — basic blocks + peephole PUSH-const
   jump-target resolution over `disassembler/asm.py` instructions.
   Distinct from the symbolic `laser/ethereum/cfg.py`: that graph is
   built DURING host execution; this one exists before anything runs.
2. **Dataflow** (`dataflow.py`) — abstract stack-height + constant
   lattice worklist over the blocks: resolves computed jumps whose
   targets are stack constants, flags definite stack-underflow and
   const-invalid-jumpdest blocks, and constant-folds JUMPI conditions
   into statically-dead branch directions.
3. **Attacker-taint fixpoint** (`taint.py`) — a second worklist pass
   propagating an attacker-influence lattice (calldata/caller/
   callvalue/returndata sources; conservative joins through memory,
   storage and the stack window) to the detector sinks: jump targets
   and branch guards, call targets/values, SSTORE slots, SELFDESTRUCT
   beneficiaries, LOG1 topics, ORIGIN-in-comparison.
4. **Value sets** (`vsa.py`) — the constant half of the sink facts
   distilled into resolved CALL/DELEGATECALL targets (ROADMAP item
   4's cross-contract facts), constant storage slots, and the
   UserAssertions marker/topic evidence.
5. **Detector pre-screen** (`screen.py`) — per-module opcode/feature
   signatures over the reachable instruction set PLUS semantic sink
   predicates over the taint/value-set facts, so
   `analysis/security.py` loads only modules that can possibly fire
   on this contract. When every module screens off the contract is
   `static_answerable`: the static-answer triage tier settles it
   with an empty issue set at corpus dispatch.
6. **Prune feed** (`summary.py` StaticSummary) — consumed by
   `laser/batch/seeds.py` (dispatcher seeds for statically-inert
   functions are dropped) and `laser/batch/explore.py` (dead branch
   directions never enter the flip frontier); also exports
   per-selector function fingerprints (item 3's incremental
   re-analysis key) and the taint lint checks behind
   `lint --fail-on`.

The whole pass is pure host work (no torch, no device):
`python -m mythril_tpu_torch lint` runs it standalone, and `analyze`
runs it as an always-on prepass unless --no-static-prune is given.
This is the port's copy of the JAX package's analysis/static, without
the corpus linker (`linkset.py`) and its exports, which only the
verdict store and routing triage read.

Manticore (arxiv 1907.03890) fronts symbolic exploration with exactly
this kind of CFG recovery; the Blockchain Superoptimizer (arxiv
2005.05912) shows how far pure constant propagation over EVM stack
code reaches without a solver — this layer is the batched-arena
adaptation of both.
"""

from __future__ import annotations

from mythril_tpu_torch.analysis.static.callgraph import (
    LINK_CHECKS,
    PROXY_IMPL_SLOTS,
    PROXY_SLOTS,
    UPGRADE_SELECTORS,
    ContractNode,
    implementation_from_init_code,
    link_node,
    link_stat_counts,
    minimal_proxy_target,
)
from mythril_tpu_torch.analysis.static.cfg import BasicBlock, recover_cfg
from mythril_tpu_torch.analysis.static.screen import (
    MODULE_SIGNATURES,
    SINK_PREDICATES,
    screen_modules,
)
from mythril_tpu_torch.analysis.static.summary import (
    LINT_CHECKS,
    LINT_SCHEMA_VERSION,
    StaticSummary,
    analysis_config_fingerprint,
    analyze_bytecode,
    clear_static_cache,
    static_cache_stats,
    summary_for,
)
from mythril_tpu_torch.analysis.static.taint import (
    TAINT_ATTACKER,
    TAINT_CALLER,
    TAINT_ORIGIN,
    TAINT_UNKNOWN,
    TaintResult,
    run_taint,
)
from mythril_tpu_torch.analysis.static.vsa import ValueSets, value_sets


def static_prune_enabled() -> bool:
    """One switch for every consumer (CLI --no-static-prune)."""
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "static_prune", True))


def static_answer_enabled() -> bool:
    """The static-answer triage tier's switch: rides the static-prune
    flag (off under --no-static-prune — full-mount parity) plus its
    own `args.static_answer` knob (the test conftest turns the tier
    off so wave/walk-mechanics suites keep their subject; the product
    default is on)."""
    from mythril_tpu_torch.support.support_args import args

    return static_prune_enabled() and bool(
        getattr(args, "static_answer", True)
    )


__all__ = [
    "BasicBlock",
    "ContractNode",
    "LINK_CHECKS",
    "LINT_CHECKS",
    "LINT_SCHEMA_VERSION",
    "PROXY_IMPL_SLOTS",
    "PROXY_SLOTS",
    "UPGRADE_SELECTORS",
    "MODULE_SIGNATURES",
    "SINK_PREDICATES",
    "StaticSummary",
    "TAINT_ATTACKER",
    "TAINT_CALLER",
    "TAINT_ORIGIN",
    "TAINT_UNKNOWN",
    "TaintResult",
    "ValueSets",
    "analysis_config_fingerprint",
    "analyze_bytecode",
    "clear_static_cache",
    "implementation_from_init_code",
    "link_node",
    "link_stat_counts",
    "minimal_proxy_target",
    "recover_cfg",
    "run_taint",
    "screen_modules",
    "static_answer_enabled",
    "static_cache_stats",
    "static_prune_enabled",
    "summary_for",
    "value_sets",
]
