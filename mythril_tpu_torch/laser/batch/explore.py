"""Device-led symbolic exploration, on the card.

The port of the JAX package's laser/batch/explore.py: the generational
frontier loop over the symbolic batch engine (symbolic.py). The card
executes a wave of lanes and constructs the path constraints (the
expression arena); the host decodes only the frontier branches it
wants to flip, solves them in one batched `device_solve_batch` dispatch
(enumeration, the SLS and the cube fan, all on the card), and seeds the
next wave with the witnesses. Forking at a symbolic JUMPI is the flip;
dead lanes are compacted away simply by not reseeding them.

`DeviceCorpusExplorer` stripes N contracts across one batch (contract
i owns a contiguous block of lanes), so a whole corpus advances in a
single wave; `DeviceSymbolicExplorer` is the single-contract view.
Exploration is multi-transaction: a successful lane whose storage
journal gained writes becomes a *carry*, the next transaction's start
state, its calldata joining the witness prefix (the mutation pruner:
non-mutating end states never become carries; carry dedup by
canonicalized journal is the dependency pruner). Observed reads of
never-written slots seed adversarial-storage (*poison*) start states.

The host logic is the JAX package's, kept line for line where it can
be, so the two explorers' outcomes (`_ContractTrack.outcome()`, the
dict `analysis/evidence.py` and `analysis/prepass.py` read) and stats
(`ExploreStats.as_dict()`) have the same keys, and their waves are
equal until the first SLS witness enters (the SLS streams differ: a
counter hash here, threefry there). What changes:

- every wave, readback and solve runs through the port's kernels on
  the card: `sym_run_inplace` (keccak_sponge, slot_write), `ArenaView`,
  `device_solve_batch` (portfolio_eval, portfolio_sls). Entry points
  take `device=None`, which means the card (`device="cpu"` runs the
  plain versions, as the tests do);
- the pipelined schedule: PyTorch has no asynchronous dispatch of a
  whole wave (`sym_run` reads the card about twice a step), so a wave
  runs on one worker thread, on its own CUDA stream, and its harvest
  joins it. Every device operation of a wave (the seed upload, the
  reseed into the spent wave's buffers, the run, the readback) runs on
  that thread and stream in dispatch order, so a reseed never overtakes
  the wave whose buffers it reuses; the readback (`ArenaView`) is host
  copies only, so the next reseed cannot corrupt a view still being
  consumed. It is off by default (`args.pipeline`): the wave's Python
  step loop holds the GIL, so the overlap is small and the schedule
  measured no faster than lock-step on the card;
- the host escalation ladder behind the device funnel
  (`_sprint_flips`: the host CDCL through `support/model.py:get_model`,
  under `args.sprint_cap_s`) is the JAX one; the survivors its cap
  defers are counted (`ladder_deferred`), and a zero cap defers them
  all;
- the static pass (`analysis/static`, on unless `args.static_prune` is
  off) prunes the flip frontier and the dispatcher seeds as in the JAX
  package; a contract whose pass raises explores unpruned and is
  recorded (`static-prepass-failed`, counted in `static_failed`);
- kernel specialization and blockjit (specialize.py, blockjit.py; on
  unless `args.specialize` is off, as in the JAX package): the waves run
  the corpus's union bucket, each loop iteration one pruned full step
  plus its substeps in one launch of `csrc/substep.cu`; the retry ladder
  re-dispatches on the generic kernel. A host-side setup failure falls
  back to the generic kernel as in the JAX package, but is recorded
  (`specialize-failed`, counted in `specialize_failed`), not only
  logged;
- the overlapped mode of the analyzer facade's corpus prepass
  (analysis/corpus.py `OverlappedPrepass`) is the JAX one: `host_lock`
  guards the flip bursts' host symbolic work (term decode, lowering, the
  ladder) while the card's batched solve runs lock-free, `lock_wanted`
  tells the owner a burst waits, `publish` hands out each track's
  outcome after every wave, and with a lock the budget bills active time
  (waves and flip solving), not the wall spent waiting on it;
- not ported, and refused rather than skipped: the multi-device mesh
  (`n_devices > 1`, `devices` of more than one card). Also left out: the metrics
  registry (`publish_explore_stats`, `solverstats.record_query`), the
  frontier steal protocol (`export_frontier`, `seed_frontier`) and the
  persistent compile cache.
"""

from __future__ import annotations

import hashlib
import json
import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from mythril_tpu_torch.exceptions import (
    DeviceDispatchError,
    SolverTimeOutException,
    UnsatError,
)
from mythril_tpu_torch.laser.batch.arena import ArenaView
from mythril_tpu_torch.laser.batch.checkpoint import (
    WaveCheckpointWriter,
    save_checkpoint,
)
from mythril_tpu_torch.laser.batch.state import (
    CodeTable,
    Status,
    make_batch,
    make_batch_numpy,
    make_code_table,
    storage_dict_from,
)
from mythril_tpu_torch.laser.batch.symbolic import (
    OPAQUE,
    make_sym_batch,
    reseed_wave_inplace,
    sym_run_inplace,
)
from mythril_tpu_torch.laser.smt.solver import capture as query_capture
from mythril_tpu_torch.laser.smt.solver import portfolio
from mythril_tpu_torch.laser.smt.solver.preprocess import lower
from mythril_tpu_torch.observe.querylog import (
    LOSS_SPRINT_PREEMPTED,
    QUERY_ORIGIN_FLIP,
    query_context,
)
from mythril_tpu_torch.observe.spans import flight_recorder, trace
from mythril_tpu_torch.support import resilience
from mythril_tpu_torch.support.accel import resolve_device
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)

DEFAULT_CALLER = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
DEFAULT_ADDRESS = 0x901D573B8CE8C997DE5F19173C32D966B4FA55FE

# the jsonv2 replay block context (analysis/report.py
# REPLAY_BLOCK_CONTEXT): the explorer executes under the SAME concrete
# environment the report claims for its test cases, so a banked
# witness replays by construction — even for asserts gated on
# ADDRESS/TIMESTAMP/NUMBER/BALANCE
REPLAY_ENV = {
    "timestamp": 0x5BFA4639,
    "number": 0x66E393,
    "gasprice": 0x773594000,
    "balance": 0,
}

TRIGGER_KINDS = {
    Status.INVALID: "assert-violation",
    Status.ERR_JUMP: "invalid-jump",
    Status.ERR_STACK: "stack-error",
    Status.KILLED: "selfdestruct",
}

#: event-kind byte -> call mnemonic (symbolic.py EV_*)
CALL_EVENT_KINDS = {4: "CALL", 5: "CALLCODE", 6: "DELEGATECALL", 7: "STATICCALL"}
WRAP_EVENT_OPS = {1: "addition", 2: "subtraction", 3: "multiplication"}
#: env sources the predictable-vars module hooks (DIFFICULTY is a leaf
#: for flippability but the reference module does not report it)
PREDICTABLE_SRCS = ("TIMESTAMP", "NUMBER", "COINBASE", "GASLIMIT", "BLOCKHASH")
GAS_STIPEND = 2300

#: carried next-transaction start states kept per contract per phase
CARRY_CAP = 16

#: the adversarial values poisoned-storage carries seed into observed
#: slots — the concolic stand-in for the host engine's symbolic
#: initial storage ("the contract may be in any prior state"). Two
#: carries per contract: MAX makes guarded reads pass and
#: receiving-side adds wrap (SWC-101); the attacker's address makes
#: storage-held callees resolve to the attacker (SWC-105/107/112 —
#: the reference solves `storage_slot == attacker` the same way).
POISON_VALUE = 2**256 - 1
POISON_ADDR = DEFAULT_CALLER
#: observed-slot cap per contract (per poison carry, many slots)
POISON_SLOTS = 8

#: msg.value seeded on the callvalue-axis carries of contracts whose
#: code reads CALLVALUE — the concolic stand-in for the host's
#: symbolic call value (1 ETH: passes `msg.value > 0` guards, small
#: enough that profit gates stay meaningful)
CALLVALUE_SEED = 10**18


class ExploreStats:
    """Counters proving the device did the stepping."""

    def __init__(self) -> None:
        # lane-steps executed on device, counting only lanes that were
        # still RUNNING at each step (the run loop's own count);
        # the raw product steps x lanes — which overcounts the halted
        # tail — is kept beside it for the utilization comparison
        self.device_steps = 0
        self.device_steps_raw = 0
        self.waves = 0
        self.transactions = 0  # deepest transaction index reached (1-based)
        self.arena_nodes = 0
        self.forks_tried = 0
        self.forks_feasible = 0
        # flip-witness sources in the DEVICE-FIRST funnel:
        # the batched on-chip dispatch answers first (device_sat, and
        # device_unsat for enumeration-owned unsats); the incremental
        # CDCL session is the escalation ladder behind it (host_sat)
        self.device_sat = 0
        self.device_unsat = 0
        #: queries decided by exhaustive enumeration (complete small
        #: spaces — the only device-owned unsat mode)
        self.device_enumerated = 0
        #: queries whose witness came from the cube-and-conquer fan
        self.device_cube_sat = 0
        self.host_sat = 0
        self.branches_covered = 0
        self.carries_banked = 0  # mutating end states promoted to tx N+1
        # device-cap observability: lanes that halted by *degrading* —
        # capacity overflow (ERR_MEM) or an off-device opcode
        # (UNSUPPORTED) — rather than by finishing. These lanes' work
        # falls back to the host engine, so the counters measure how
        # much of the modeled space the lean device caps actually
        # cover on this workload (laser/batch/state.py caps).
        self.lanes_degraded_mem = 0
        self.lanes_degraded_unsupported = 0
        # resilience observability: waves whose dispatch died past the
        # retry ladder (the exploration degraded instead of crashing),
        # and wave checkpoints flushed for resume
        self.device_faults = 0
        self.wave_checkpoints = 0
        # static-prune observability (analysis/static): flip targets
        # the pre-dispatch pass proved dead (never solved), dispatcher
        # seeds dropped for statically-inert functions, and how many
        # contracts carried a static summary at all
        self.static_pruned_flips = 0
        self.static_seeds_dropped = 0
        self.static_summaries = 0
        #: contracts whose semantic screen proved NO detection module
        #: can fire (summary.static_answerable) — the population the
        #: static-answer triage tier settles without any device work
        self.static_answered = 0
        # verdict-store incremental re-analysis (mythril_tpu/store):
        # unchanged-fork selectors whose dispatcher seeds and entry
        # flips this exploration masked — lanes spent only on changed
        # functions
        self.store_masked_selectors = 0
        # -- kernel specialization observability (specialize.py) ------
        #: 1 when the waves ran a contract-specialized kernel
        self.specialized = 0
        #: handler phases the wave kernel elided (union bucket)
        self.spec_pruned_phases = 0
        #: instructions advanced by fused substeps (superblock fusion)
        #: ON TOP of the full-step active count — total instructions
        #: executed is device_steps + spec_fused_steps
        self.spec_fused_steps = 0
        #: wave retries that fell back to the generic kernel (the
        #: resilience ladder never re-dispatches specialized)
        self.spec_fallbacks = 0
        # -- block-level JIT observability (blockjit.py) ---------------
        #: instructions advanced by block substeps ON TOP of the
        #: full-step active count (the blockjit twin of
        #: spec_fused_steps — a wave counts into one or the other,
        #: never both)
        self.blockjit_steps = 0
        #: lowered basic blocks entered through a block head by a
        #: block substep
        self.blockjit_blocks = 0
        #: basic blocks across this exploration's contracts that the
        #: lowering classified NOT lowerable (calls, storage/memory
        #: effects, env reads, unresolved jumps, foreign opcodes) —
        #: those blocks run on the generic per-opcode step, attributed
        #: here, never silently mis-executed
        self.blockjit_fallbacks = 0
        #: this explorer's kernel-cache lookups (process-wide LRU)
        self.kernel_cache_hits = 0
        self.kernel_cache_misses = 0
        #: first-call trace+compile wall of this run's kernel bucket
        self.kernel_compile_s = 0.0
        self.wall_s = 0.0
        # where the prepass wall goes: device wave execution vs host
        # flip solving (the two phases that can dominate)
        self.wave_exec_s = 0.0
        self.flip_solve_s = 0.0
        # -- pipelined wave engine observability ----------------------
        #: 1 when the double-buffered schedule ran this exploration
        self.pipelined = 0
        #: most waves simultaneously in flight (2 = the pipeline)
        self.waves_inflight_max = 0
        #: harvests that ran with another wave executing on device —
        #: the integer the ratio below normalizes (robust to rounding
        #: on tiny workloads)
        self.waves_overlapped = 0
        #: host-side work (evidence consume + flip solving + next-wave
        #: seeding) done WHILE a wave was executing on device
        self.wave_overlap_s = 0.0
        #: host blocked waiting on a wave's readiness (device working,
        #: host idle) / device span from dispatch to readiness
        self.device_wait_s = 0.0
        self.device_busy_s = 0.0
        #: overlap_s / busy_s — the fraction of device execution the
        #: host covered with concurrent work (0 in --no-pipeline runs)
        self.wave_overlap_ratio = 0.0
        #: fraction of the exploration wall with NO wave in flight
        self.device_idle_frac = 0.0
        #: bytes the compacted per-wave readback actually transferred,
        #: and what the full-table transfer would have cost
        self.evidence_bytes = 0
        self.evidence_bytes_full = 0
        self.evidence_bytes_per_wave = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


#: Explicit cross-engine merge semantics for EVERY ExploreStats field
#: (plus the optional "halt_reason" the stats dict may carry): a
#: multi-chip scheduler folds per-chunk stats dicts with these rules,
#: so a new counter cannot silently merge wrong. The policy equals the
#: JAX package's (tests/test_torch_explore.py pins it).
#:
#:   sum      additive work/byte/fault counters
#:   max      high-water marks and per-run mode flags (1 if ANY chunk
#:            ran pipelined/specialized; the deepest transaction)
#:   derived  ratios recomputed AFTER the merge from merged inputs
#:   last     non-numeric run verdicts (the newest chunk owns them)
MERGE_POLICY: Dict[str, str] = {
    "device_steps": "sum",
    "device_steps_raw": "sum",
    "waves": "sum",
    "transactions": "max",
    "arena_nodes": "max",
    "forks_tried": "sum",
    "forks_feasible": "sum",
    "device_sat": "sum",
    "device_unsat": "sum",
    "device_enumerated": "sum",
    "device_cube_sat": "sum",
    "host_sat": "sum",
    "branches_covered": "sum",
    "carries_banked": "sum",
    "lanes_degraded_mem": "sum",
    "lanes_degraded_unsupported": "sum",
    "device_faults": "sum",
    "wave_checkpoints": "sum",
    "static_pruned_flips": "sum",
    "static_seeds_dropped": "sum",
    "static_summaries": "sum",
    "static_answered": "sum",
    "store_masked_selectors": "sum",
    "specialized": "max",
    "spec_pruned_phases": "max",
    "spec_fused_steps": "sum",
    "spec_fallbacks": "sum",
    "blockjit_steps": "sum",
    "blockjit_blocks": "sum",
    "blockjit_fallbacks": "sum",
    "kernel_cache_hits": "sum",
    "kernel_cache_misses": "sum",
    "kernel_compile_s": "sum",
    "wall_s": "derived",
    "wave_exec_s": "sum",
    "flip_solve_s": "sum",
    "pipelined": "max",
    "waves_inflight_max": "max",
    "waves_overlapped": "sum",
    "wave_overlap_s": "sum",
    "device_wait_s": "sum",
    "device_busy_s": "sum",
    "wave_overlap_ratio": "derived",
    "device_idle_frac": "derived",
    "evidence_bytes": "sum",
    "evidence_bytes_full": "sum",
    "evidence_bytes_per_wave": "derived",
    "halt_reason": "last",
}


def merge_stats(dst: Dict, src: Dict) -> None:
    """Fold one engine's stats dict into `dst` under MERGE_POLICY.
    Unknown numeric keys sum (the policy-pin test keeps the set
    complete for ExploreStats fields); unknown non-numeric keys are
    ignored."""
    for key, value in src.items():
        policy = MERGE_POLICY.get(key)
        if policy == "derived":
            continue
        if policy == "last":
            dst[key] = value
            continue
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if policy == "max":
            dst[key] = max(dst.get(key, 0), value)
        else:  # "sum" and unregistered numeric keys
            dst[key] = dst.get(key, 0) + value


def lower_flips(batch, indices=None, lower_fn=lower) -> Tuple[List, List[int]]:
    """Lower flip queries (lists of Bool conditions) for the device
    stage: (lowered queries, their indices into `batch`). Queries that
    fail to lower are simply absent — the escalation ladder still sees
    them. `lower_fn` lets a caller lower with another package's `lower`
    (the parity tools)."""
    if indices is None:
        indices = range(len(batch))
    lowered_batch: List = []
    kept: List[int] = []
    for i in indices:
        try:
            lowered, _ = lower_fn([c.raw for c in batch[i]])
        except Exception as e:
            log.debug("lowering failed: %s", e)
            continue
        lowered_batch.append(lowered)
        kept.append(i)
    return lowered_batch, kept


def witness_bytes(assignment: Dict[str, int], calldata_len: int = 68) -> bytes:
    """The calldata a witness names: byte i from variable `cd<i>`, every
    other byte zero (`calldata_len` bytes, the explorer's default 68)."""
    data = bytearray(calldata_len)
    for name, value in assignment.items():
        if name.startswith("cd"):
            try:
                i = int(name[2:])
            except ValueError:
                continue
            if i < calldata_len:
                data[i] = value & 0xFF
    return bytes(data)


def lane_flip_candidate(view, lane: int, covered, attempted, dead=frozenset()):
    """The explorer's candidate rule for one lane: its first symbolic
    journal decision whose other direction is neither covered nor
    attempted becomes the candidate, its path condition decoded with the
    last decision inverted. Every target looked at is marked attempted.

    Returns (candidate, counts): candidate is (journal index, path
    condition, target) or None; counts has `tried` (targets a solve was
    considered for), `pruned` (targets in `dead`, the statically dead
    directions, blacklisted unsolved) and `opaque` (the targets whose
    prefix held an opaque decision: unflippable)."""
    counts = {"tried": 0, "pruned": 0, "opaque": []}
    for k, (pc, taken, tid) in enumerate(view.journal(lane)):
        target = (pc, not taken)
        if tid <= 0:
            continue  # concrete or opaque condition: nothing to flip
        if target in dead:
            # the static pass proved this direction infeasible or inert:
            # blacklist without spending a solve
            if target not in attempted:
                attempted.add(target)
                counts["pruned"] += 1
            continue
        if target in covered or target in attempted:
            continue
        attempted.add(target)
        counts["tried"] += 1
        conditions = view.path_condition(lane, k, flip_last=True)
        if conditions is None:
            counts["opaque"].append(target)
            continue
        return (k, conditions, target), counts
    return None, counts


def required_calldata_len(
    code_hex: str, default: int = 68, cap: int = 480
) -> int:
    """Static scan for the largest PUSH1..PUSH4 immediate that
    directly feeds a CALLDATALOAD, plus a word of margin: contracts
    reading high fixed offsets (hand-rolled dispatchers, packed
    multi-word args) are unreachable past the default 68-byte seed
    window otherwise — their guards could never be covered or flipped
    on device. Bounded by the device calldata envelope."""
    code = bytes.fromhex(code_hex[2:] if code_hex.startswith("0x") else code_hex)
    need = default
    i = 0
    while i < len(code):
        op = code[i]
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            if n <= 4 and i + n + 1 < len(code) and code[i + n + 1] == 0x35:
                off = int.from_bytes(code[i + 1 : i + 1 + n], "big")
                if off < cap:
                    need = max(need, off + 36)
            i += 1 + n
        else:
            i += 1
    return min(need, cap)


class _ContractTrack:
    """Per-contract exploration bookkeeping inside the striped batch."""

    def __init__(self, code_hex: str) -> None:
        self.code_hex = code_hex
        #: dispatcher seeds, computed once — selector recovery
        #: disassembles the contract, and doing that per PHASE for a
        #: whole corpus is seconds of GIL time stolen from overlapped
        #: host analyses
        self.selector_seeds: Optional[List[bytes]] = None
        #: static pre-analysis (analysis/static StaticSummary), set by
        #: the explorer when the static prepass is enabled; None means
        #: no pruning and no seed masking for this contract
        self.static = None
        #: the statically-dead branch directions — (jumpi_pc, taken)
        #: pairs the flip loop must never spend a solver attempt on
        self.static_dead: frozenset = frozenset()
        #: this contract's kernel-specialization bucket (step.PhaseSet,
        #: set by the explorer when specialization is on; the wave
        #: kernel is the union over the striped tracks)
        self.phases = None
        self.covered: Set[Tuple[int, bool]] = set()
        self.attempted: Set[Tuple[int, bool]] = set()
        self.corpus: List[Tuple[int, bytes]] = []  # (carry index, calldata)
        #: solver-derived inputs (flip/steer witnesses) — the seeds
        #: worth carrying into the next transaction phase ahead of
        #: mutation filler
        self.flip_corpus: List[bytes] = []
        #: kind -> [{pc, input, prefix, gas_min, gas_max}]; pc is the
        #: faulting instruction (the step kernel pins a halted lane's
        #: pc there), prefix the calldata of the transactions before
        #: the faulting one, gas bounds the lane's accumulated range
        self.triggers: Dict[str, List[Dict]] = {}
        self.exhausted = False  # no flips left last time we looked
        self.parent_inputs: List[bytes] = []  # last phase's distinct inputs
        #: concrete detection evidence, keyed (class, pc[, detail]) —
        #: every record carries the exhibiting lane's replayable input
        #: (analysis/evidence.py turns these into Issues)
        self.evidence: Dict[Tuple, Dict] = {}
        #: property-steering queries already dispatched (pc, kind)
        self.prop_attempted: Set[Tuple[int, int]] = set()
        # -- device-completeness accounting (ownership gate) ----------
        #: lanes of this contract that degraded (ERR_MEM/UNSUPPORTED):
        #: their work fell back to the host, so the device's view of
        #: the contract is partial
        self.degraded = 0
        #: a carry was dropped at CARRY_CAP: some tx-N+1 start state
        #: was never explored
        self.carry_overflow = False
        #: every finished phase ended with the frontier genuinely
        #: closed (exhausted, no retriable candidates) — False the
        #: moment a phase ends on budget/wave-cap instead
        self.frontier_closed = True
        #: never-written slots the device observed SLOADs of
        self.storage_reads: Set[int] = set()
        #: arith sites over opaque operands that never wrapped — each
        #: must be resolved (a wrap witness, or an ANSWERED node-site
        #: steering query at the same pc) or the contract stays
        #: host-owned
        self.opaque_sites: Set[int] = set()
        #: steering queries that got a genuine answer (unsat, or sat
        #: with the wrap then confirmed concretely) — attempts alone
        #: resolve nothing
        self.prop_resolved: Set[Tuple[int, int]] = set()
        #: branch targets whose path condition could not be decoded
        #: (opaque prefix): unflippable — complete only if some
        #: concrete lane covered them anyway
        self.opaque_branches: Set[Tuple[int, bool]] = set()
        #: the per-lane evidence bank overflowed: completeness inputs
        #: (opaque sites, storage reads) may be truncated
        self.event_overflow = False
        #: the synthetic adversarial-storage start states (MAX and
        #: attacker-address variants; grown in place as reads surface)
        self.poison_carries: List[Dict] = []
        #: does the bytecode read msg.value? (byte scan over-approxes
        #: into PUSH data — a harmless extra carry)
        self.uses_callvalue = 0x34 in bytes.fromhex(self.code_hex)
        #: this phase's transaction start states
        self.carries: List[Dict] = [{"journal": {}, "prefix": []}]
        if self.uses_callvalue:
            # the msg.value axis: one value-bearing start state
            self.carries.append(
                {"journal": {}, "prefix": [], "callvalue": CALLVALUE_SEED}
            )
        #: mutating end states collected for the NEXT transaction,
        #: keyed by canonicalized journal (the device mutation pruner)
        self.next_carries: Dict[Tuple, Dict] = {}
        self.idle = False  # no start states left for this phase
        #: contract finished EARLY (all ownership gates green in the
        #: final phase): its evidence is frozen, its lanes stop being
        #: seeded, and the published outcome is final mid-run — the
        #: ownership consumer (analysis/corpus.py) may skip the host
        #: walk without waiting for the whole corpus run to end
        self.parked = False
        self._final_outcome: Optional[Dict] = None

    def device_complete(self) -> bool:
        """True when the striped exploration covered this contract's
        bounded model end-to-end: every phase's frontier closed, no
        lane degraded off-device, no carry dropped, and every opaque
        arith site resolved (wrapped concretely, or steering-checked
        through its node form at the same pc). The ownership gate
        (analysis/corpus.py): a complete contract's issues come from
        the evidence bank alone and the host walk is skipped."""
        return all(self.completeness_gates().values())

    def completeness_gates(self) -> Dict[str, bool]:
        """The ownership conditions, individually — every value must be
        True for device_complete. Exported through outcome() so an
        incomplete contract SAYS which gate kept the host walk."""
        steered = {p for (p, k) in self.prop_resolved if k in (10, 11, 12)}
        unresolved = {
            pc
            for pc in self.opaque_sites
            if ("wrap", pc) not in self.evidence and pc not in steered
        }
        return {
            "steering_resolved": not self._unresolved_steering(),
            "frontier_closed": bool(self.frontier_closed),
            "no_degraded": self.degraded == 0,
            "no_carry_overflow": not self.carry_overflow,
            "no_event_overflow": not self.event_overflow,
            "arith_sites_resolved": not unresolved,
            # every unflippable (opaque-prefix) branch target must have
            # been covered concretely by some lane
            "opaque_branches_covered": self.opaque_branches <= self.covered,
            # an unseeded poisoned state means the storage dimension
            # was never sampled: whatever it would have exhibited is
            # unknown, so the host walk keeps the contract
            "poison_seeded": not self.unseeded_poison(),
        }

    def bank_carry(
        self,
        journal: Dict[int, int],
        prefix: List[bytes],
        parent: Optional[Dict] = None,
    ) -> bool:
        key = tuple(sorted(journal.items()))
        if key in self.next_carries:
            return False
        if len(self.next_carries) >= CARRY_CAP:
            # a DISTINCT mutated end state was dropped: the next
            # transaction's exploration is knowingly partial
            self.carry_overflow = True
            return False
        carry = {"journal": journal, "prefix": prefix}
        if parent:
            if parent.get("base"):
                # descendants of a poisoned start state keep its
                # synthetic initial storage: any witness they produce
                # must declare it
                carry["base"] = parent["base"]
            if parent.get("balance"):
                carry["balance"] = parent["balance"]
            # per-transaction msg.value trail (witness steps + the
            # attacker-profit gate)
            carry["prefix_values"] = parent.get("prefix_values", []) + [
                parent.get("callvalue", 0)
            ]
        self.next_carries[key] = carry
        return True

    def ensure_poison_carries(self) -> None:
        """Create/refresh the adversarial-storage start states from
        the observed never-written reads. Mutated in place: carries
        are referenced by index, and the next wave's make_batch reads
        the journals fresh."""
        if self.parked or not self.storage_reads:
            return
        if not self.poison_carries:
            # MAX and attacker-address variants run VALUE-FREE (a
            # value-bearing start reverts at every non-payable guard);
            # payable contracts get one extra MAX+msg.value combo for
            # the `balances[x] += msg.value` wrap family
            variants = 3 if self.uses_callvalue else 2
            for k in range(variants):
                # every poisoned state also holds a funded contract
                # balance (`send(this.balance)` shapes — the host
                # models balances symbolically; witnesses declare it)
                carry = {
                    "journal": {},
                    "prefix": [],
                    "base": {},
                    "balance": CALLVALUE_SEED,
                }
                if k == 2:
                    carry["callvalue"] = CALLVALUE_SEED
                self.poison_carries.append(carry)
                self.carries.append(carry)
            self._n_uniform_poison = variants
        values = (POISON_VALUE, POISON_ADDR, POISON_VALUE)
        # only the uniform variant carries take the all-slot refresh:
        # per-slot singles (appended below) must keep their lone-slot
        # isolation across waves
        uniform = self.poison_carries[
            : getattr(self, "_n_uniform_poison", len(self.poison_carries))
        ]
        for value, carry in zip(values, uniform):
            for slot in sorted(self.storage_reads)[:POISON_SLOTS]:
                if slot not in carry["journal"]:
                    # a new slot means the poisoned state changed: it
                    # deserves a fresh seeding pass
                    carry["seeded"] = False
                carry["journal"][slot] = value
                carry["base"][slot] = value
        # Per-slot SINGLES: uniform poison blocks guarded paths (a
        # MAX-poisoned `minInvestment` reverts the same function whose
        # poisoned balance would wrap), so each observed slot also gets
        # lone-slot MAX and attacker-address states — the closest
        # concolic analogue of the solver picking per-slot values.
        keys = getattr(self, "_poison_keys", None)
        if keys is None:
            keys = self._poison_keys = set()
        # MAX singles only: the attacker-address dimension rides the
        # all-ADDR variant (callee/owner slots resolve together there),
        # while wrap-guard interplay needs each slot isolated at MAX
        for slot in sorted(self.storage_reads)[:POISON_SLOTS - 2]:
            k = (slot, POISON_VALUE)
            if k in keys or len(self.poison_carries) >= 9:
                continue
            keys.add(k)
            carry = {
                "journal": {slot: POISON_VALUE},
                "prefix": [],
                "base": {slot: POISON_VALUE},
                "balance": CALLVALUE_SEED,
            }
            if self.uses_callvalue:
                carry["callvalue"] = CALLVALUE_SEED
            self.poison_carries.append(carry)
            self.carries.append(carry)

    def unseeded_poison(self) -> List[int]:
        return [
            i
            for i in self.poison_indices()
            if not self.carries[i].get("seeded")
        ]

    def still_exhausted(self) -> bool:
        """True when the last reseed found this frontier exhausted AND
        no lane has covered anything new since that verdict — the
        condition under which an early phase end (budget, wave cap,
        stop) cannot have left live work here."""
        return (
            self.exhausted
            and len(self.covered) == getattr(self, "_exhausted_cov", -1)
        )

    def finalize_if_complete(self) -> bool:
        """Early per-contract finality, checked after every reseed of
        the LAST transaction phase: once this contract's frontier is
        provably closed (idle this phase, or exhausted with stable
        coverage) and every other ownership gate is green, freeze it —
        snapshot the outcome as final, stop seeding its lanes, and
        stop consuming its events. The frozen claim stays sound
        because nothing can mutate the track afterwards; the consumer
        gets ownership ~as soon as the contract converges instead of
        at the end of the whole corpus run."""
        if self.parked:
            return True
        if getattr(self, "_poison_pending_serial", None) is not None:
            # a freshly-seeded poison stripe is scheduled for a wave
            # that has not been HARVESTED yet (under the pipelined
            # schedule that wave may still be two dispatches out) —
            # its results must land before completeness can claim the
            # storage dimension was sampled
            return False
        gates = self.completeness_gates()
        gates["frontier_closed"] = self.idle or self.still_exhausted()
        if not all(gates.values()):
            return False
        self.frontier_closed = True
        self.exhausted = True
        self._exhausted_cov = len(self.covered)
        self.parked = True
        out = self.outcome()
        out["final_for_contract"] = True
        self._final_outcome = out
        return True

    def _unresolved_steering(self) -> bool:
        """A steering query that was dispatched but never got a real
        answer — sprint-capped, lowering-failed, or sat-but-never-
        confirmed-concretely — leaves its property OPEN: the host walk
        must keep the contract."""
        for key in self.prop_attempted:
            pc, k = key
            if key in self.prop_resolved:
                continue
            if k in (10, 11, 12) and ("wrap", pc) in self.evidence:
                continue
            if k in (4, 6):
                mnemonic = {4: "CALL", 6: "DELEGATECALL"}[k]
                rec = self.evidence.get(("call", pc, mnemonic))
                if rec is not None and rec.get("to_attacker"):
                    continue
            return True
        return False

    def result_stored_in_block(self, pc: int) -> bool:
        """Static stand-in for the wrap-usage check when the result is
        term-opaque: does the basic block continuing at `pc` reach one
        of integer.py's promotion sites (SSTORE, RETURN, CALL — or a
        JUMPI, whose in-block condition chain the result feeds) before
        a plain control transfer? Linear byte sweep, PUSH data skipped
        — the `SLOAD ADD ... SSTORE` / `MUL ... GT ... JUMPI` compiler
        shapes this covers have no interior branches."""
        cached = getattr(self, "_stored_memo", None)
        if cached is None:
            cached = self._stored_memo = {}
        hit = cached.get(pc)
        if hit is not None:
            return hit
        code = bytes.fromhex(self.code_hex)
        at = pc
        out = False
        for _ in range(48):
            if at >= len(code):
                break
            op = code[at]
            if op in (0x55, 0xF3, 0xF1, 0x57):
                out = True  # SSTORE / RETURN / CALL / JUMPI use sites
                break
            if op in (0x00, 0x56, 0xFD, 0xFE, 0xFF):
                break  # STOP/JUMP/REVERT/INVALID/SELFDESTRUCT
            at += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
        cached[pc] = out
        return out

    def poison_indices(self) -> List[int]:
        return [
            i
            for i, c in enumerate(self.carries)
            if any(c is p for p in self.poison_carries)
        ]

    def advance_phase(self) -> bool:
        """Promote the banked carries to the next transaction's start
        states; False when exploration of this contract is over."""
        if self.parked:
            return False  # frozen — state must not be touched
        # inputs that exercised branches last transaction are the best
        # seeds for the next one: a branch direction that was a dead
        # end under empty storage may open under the carried journal,
        # and the global covered-set keeps it off the flip frontier.
        # SOLVER-DERIVED witnesses first (they opened branches nothing
        # else reaches), then the rest latest-first — plain
        # reversed(corpus) buries a wave's flip witnesses behind its
        # own mutation filler and they fall out of the seed window.
        seen = set()
        self.parent_inputs = [
            data
            for data in reversed(self.flip_corpus)
            if not (data in seen or seen.add(data))
        ] + [
            data
            for _, data in reversed(self.corpus)
            if not (data in seen or seen.add(data))
        ]
        self.flip_corpus = []
        # fresh phase, fresh poison: the carried states already hold
        # last phase's written slots; new never-written reads surface
        # their own synthetic start state
        self.poison_carries = []
        self.storage_reads = set()
        self._poison_keys = set()
        self._poison_pending_serial = None
        if not self.next_carries:
            self.idle = True
            # keep a placeholder so the lane stripe stays shape-stable
            self.carries = [{"journal": {}, "prefix": []}]
            return False
        self.carries = list(self.next_carries.values())
        self.next_carries = {}
        self.attempted = set()
        self.exhausted = False
        return True

    @staticmethod
    def _hexify_rec(rec: Dict) -> Dict:
        """Internal records hold raw bytes; the outcome dict carries hex
        strings — including the per-property witnesses (w_unchecked /
        w_profit) banked beside call records."""
        out = dict(
            rec,
            input=rec["input"].hex(),
            prefix=[p.hex() for p in rec["prefix"]],
        )
        for k in ("w_unchecked", "w_profit"):
            w = out.get(k)
            if w is not None:
                out[k] = dict(
                    w,
                    input=w["input"].hex(),
                    prefix=[p.hex() for p in w["prefix"]],
                )
        return out

    def outcome(self) -> Dict:
        return {
            "covered_branches": sorted(self.covered),
            "corpus_size": len(self.corpus),
            "triggers": {
                kind: [
                    dict(
                        t,
                        input=t["input"].hex(),
                        prefix=[p.hex() for p in t["prefix"]],
                    )
                    for t in bucket
                ]
                for kind, bucket in self.triggers.items()
            },
            "evidence": [self._hexify_rec(rec) for rec in self.evidence.values()],
            "device_complete": self.device_complete(),
            "completeness_gates": self.completeness_gates(),
            "degraded_lanes": self.degraded,
        }


class _WavePayload:
    """One wave's host-side seed snapshot: everything needed to (a)
    dispatch it, (b) re-dispatch it cold after a fault, (c) flush its
    checkpoint from a background thread, and (d) consume its results
    — all WITHOUT touching live track state, which later harvests
    mutate in place while this wave is still in flight."""

    __slots__ = (
        "inputs", "flat", "lane_carry", "carries", "storage_seed",
        "callvalues", "balances", "synthetic", "serial",
    )

    def __init__(
        self, inputs, flat, lane_carry, carries, storage_seed,
        callvalues, balances, synthetic, serial,
    ) -> None:
        self.inputs = inputs
        self.flat = flat
        self.lane_carry = lane_carry
        self.carries = carries
        self.storage_seed = storage_seed
        self.callvalues = callvalues
        self.balances = balances
        self.synthetic = synthetic
        self.serial = serial


class _Inflight:
    """A dispatched, not-yet-harvested wave: `future` runs on the
    explorer's wave thread (the pipelined schedule), or the wave ran
    inline and `result` holds (out, steps, active lane-steps, view,
    times, substep counts)."""

    __slots__ = ("payload", "future", "result", "dispatch_t", "failed")

    def __init__(self, payload: _WavePayload) -> None:
        self.payload = payload
        self.future = None
        self.result = None
        self.dispatch_t = None
        self.failed = None


class DeviceCorpusExplorer:
    """Explore a corpus of contracts in one lane-striped batch.

    Contract i owns lanes [i*L, (i+1)*L). Every wave advances the whole
    corpus in one `sym_run`; flips and reseeding happen per contract on
    the host between waves, and carries advance the whole corpus one
    attacker transaction at a time up to `transaction_count`. The waves
    and the solver run on `device` (None: the card).
    """

    def __init__(
        self,
        codes_hex: List[str],
        calldata_len: int = 68,
        lanes_per_contract: int = 32,
        waves: int = 4,
        steps_per_wave: int = 512,
        portfolio_candidates: int = 64,
        seed: int = 1,
        budget_s: Optional[float] = None,
        address: int = DEFAULT_ADDRESS,
        n_devices: Optional[int] = None,
        transaction_count: int = 1,
        empty_world: bool = True,
        host_lock=None,
        stop_event=None,
        publish=None,
        mem_cap: int = 16384,
        storage_cap: int = 128,
        deadline=None,
        checkpoint_path=None,
        pipeline: Optional[bool] = None,
        devices=None,
        specialize: Optional[bool] = None,
        selector_masks: Optional[Dict[int, Tuple]] = None,
        device=None,
    ) -> None:
        from mythril_tpu_torch.laser.batch.seeds import code_cap_bucket
        from mythril_tpu_torch.support.support_args import args as _flags

        if (n_devices is not None and n_devices > 1) or (
            devices is not None and len(devices) > 1
        ):
            raise NotImplementedError(
                "the multi-device mesh is not ported: the explorer runs "
                "on one card"
            )
        self.device = resolve_device(
            devices[0] if devices is not None and len(devices) else device
        )
        self.tracks = [
            _ContractTrack(c[2:] if c.startswith("0x") else c) for c in codes_hex
        ]
        self.codes = [bytes.fromhex(t.code_hex) for t in self.tracks]
        #: verdict-store incremental masks (store/diff.py): {track
        #: index: (frozenset of unchanged selector bytes, frozenset of
        #: their (jumpi_pc, taken) entry directions)}. They ride the
        #: static feeds, so with static pruning off they stay inert.
        self.selector_masks = dict(selector_masks or {})
        #: contracts whose static pass raised: they explore unpruned,
        #: each recorded as `static-prepass-failed` (port-only, beside
        #: `ladder_deferred`: ExploreStats keeps the JAX package's keys)
        self.static_failed = self._attach_static_feeds()
        self.lanes_per_contract = lanes_per_contract
        self.calldata_len = calldata_len
        self.waves = waves
        self.steps_per_wave = steps_per_wave
        self.portfolio_candidates = portfolio_candidates
        self.budget_s = budget_s
        self.address = address
        self.transaction_count = max(1, transaction_count)
        # False when foreign accounts may carry code (on-chain
        # loading): device lanes then hand CALLs to the host instead
        # of treating them as transfers
        self.empty_world = empty_world
        # Overlapped mode (analysis/corpus.py): waves run in a prepass
        # thread while the main thread analyzes; `host_lock` guards the
        # process-global symbolic state (support/host_lock.py) around
        # flip decode+solve bursts, and the budget switches to ACTIVE
        # time (waves + flip solving) so wall spent blocked on the lock
        # doesn't count against the prepass. `stop_event` lets the
        # owner end the exploration when its own work is done.
        self.host_lock = host_lock
        self.stop_event = stop_event
        #: resilience supervision (support/resilience.py): an expired
        #: `deadline` — or a delivered SIGINT/SIGTERM — reads as a stop
        #: request at every wave/budget boundary, and `checkpoint_path`
        #: flushes each wave's seeded frontier to npz BEFORE dispatch,
        #: so a wave killed mid-flight replays exactly (replay_wave)
        self.deadline = deadline
        self.checkpoint_path = checkpoint_path
        #: double-buffered wave pipelining (args.pipeline, off by
        #: default): up to two waves in flight, wave N+1 seeded from
        #: the frontier known BEFORE wave N's results, so the host's
        #: evidence consume + flip solving for wave N overlap the
        #: card's execution of wave N+1. Off until a wave releases the
        #: GIL: on the card it overlaps about 1% of a wave and measured
        #: no faster than lock-step (PERF.md)
        self.pipeline = (
            bool(getattr(_flags, "pipeline", False))
            if pipeline is None
            else bool(pipeline)
        )
        #: background npz flusher (checkpoint.py): the per-wave
        #: seeded-frontier flush serializes off the critical path
        self._ckpt_writer = (
            WaveCheckpointWriter() if checkpoint_path else None
        )
        #: the most recently harvested wave's device buffers — the next
        #: dispatch reseeds into them in place: None forces the cold
        #: make_batch upload path
        self._carcass = None
        #: the wave thread and its CUDA stream (pipelined schedule),
        #: made at the first dispatch
        self._wave_pool: Optional[ThreadPoolExecutor] = None
        self._stream = None
        self._wave_serial = 0
        self._halt_reason = None
        #: set while this explorer wants/holds the host lock — the
        #: overlapped owner only needs to yield between analyses when
        #: a flip burst is actually waiting, not once per contract
        self.lock_wanted = threading.Event()
        # `publish(track_index, outcome_so_far)` after every wave: in
        # overlapped mode the owner consumes partial outcomes for
        # contracts it analyzes before the exploration completes —
        # wave-1 triggers/coverage already pre-empt most of what the
        # final outcome would (dict writes are GIL-atomic; the value is
        # freshly built, never mutated after publication)
        self.publish = publish
        #: per reseed: flip candidates, opaque targets, queries lowered,
        #: device-solve ms, verdicts by mode, witnesses, invalid
        #: witnesses, survivors the host ladder's cap deferred
        self.reseed_log: List[Dict] = []
        #: device survivors the host ladder's cap deferred (retried next
        #: wave), over the whole run
        self.ladder_deferred = 0
        #: per harvested wave: serial, transaction, steps, active
        #: lane-steps, lanes, ms of seeding, run, readback, the host's
        #: wait at the harvest and the wave's wall to the end of its
        #: consume, and whether it was reseeded in place
        self.wave_log: List[Dict] = []
        #: device model capacities per lane: corpus callers pass lean
        #: caps and the degraded-lane counters report what the trade
        #: costs
        self.mem_cap = mem_cap
        self.storage_cap = storage_cap
        self.rng = random.Random(seed)
        self.stats = ExploreStats()
        self.stats.pipelined = int(self.pipeline)
        self.stats.static_summaries = sum(
            1 for t in self.tracks if t.static is not None
        )
        self.stats.static_answered = sum(
            1
            for t in self.tracks
            if t.static is not None and t.static.static_answerable
        )
        from mythril_tpu_torch.store.diff import SelectorMaskFeed as _MaskFeed

        self.stats.store_masked_selectors = sum(
            len(t.static.mask_selectors)
            for t in self.tracks
            if isinstance(t.static, _MaskFeed)
        )
        self._phase_allowance: Optional[float] = None

        # code capacity bucketed to powers of two (one shape class per
        # size, as the JAX package's compile cache wants)
        cap = code_cap_bucket(max((len(c) for c in self.codes), default=1))
        self.code_table = make_code_table(self.codes, code_cap=cap, device=self.device)
        # host copy for the background checkpoint writer: the table
        # never changes, so it is read off the card once
        self._code_table_host = CodeTable(
            *(t.detach().cpu().numpy() for t in self.code_table)
        )
        self.code_ids = np.repeat(
            np.arange(len(self.codes), dtype=np.int32), lanes_per_contract
        )
        #: 1 when the specialization setup raised on the host and the
        #: waves run the generic kernel (recorded `specialize-failed`;
        #: port-only, beside `static_failed`)
        self.specialize_failed = 0
        self._kernel = None
        self._fuse_tbl = None
        self.kernel_phases = None
        self._attach_specialized_kernel(specialize, cap)

    # -- kernel specialization -----------------------------------------
    def _attach_specialized_kernel(self, specialize: Optional[bool], cap: int) -> None:
        """Per-track opcode signatures (the static summary's when one is
        attached, a linear sweep otherwise) union into ONE wave bucket,
        with the block-program table (blockjit on and profitable) or
        the fuse table beside the code table. --no-specialize leaves the
        generic kernel. A host-side failure here falls back to the
        generic kernel, as in the JAX package, and is recorded as
        `specialize-failed`; the table's upload to the card is outside
        the fallback, and so is every launch."""
        from mythril_tpu_torch.laser.batch import specialize as _spec

        if specialize is None:
            specialize = _spec.specialize_enabled()
        if not specialize:
            return
        from mythril_tpu_torch.laser.batch import blockjit as _bj

        try:
            resilience.inject("explore.specialize")
            blockjit_on = _bj.blockjit_enabled()
            for track, code in zip(self.tracks, self.codes):
                track.phases = _spec.phases_for(
                    _spec.signature_for(code, track.static),
                    fuse=_spec.fuse_profitable(code, track.static),
                    block_depth=(
                        _bj.block_depth_for(code, track.static) if blockjit_on else 0
                    ),
                )
            phases = _spec.union_phases([t.phases for t in self.tracks])
            summaries = [t.static for t in self.tracks]
            if phases.block_depth > 0:
                # the block-program table replaces the fuse table: its
                # rows carry the fusible marks too
                table = _bj.build_block_table(self.codes, cap, summaries)
                fallbacks = sum(
                    _bj.block_stats(code, static)["blocks_unlowered"]
                    for code, static in zip(self.codes, summaries)
                )
            else:
                table = _spec.build_fuse_table(self.codes, cap, summaries)
                fallbacks = 0
        except Exception as why:
            self.specialize_failed = 1
            resilience.DegradationLog().record(
                resilience.DegradationReason.SPECIALIZE_FAILED,
                site="explorer",
                detail=f"{type(why).__name__}: {why}; explores on the generic kernel",
            )
            return
        self._fuse_tbl = torch.from_numpy(table).to(self.device)
        self.kernel_phases = phases
        self.stats.blockjit_fallbacks = fallbacks
        cache = _spec.kernel_cache()
        h0, m0 = cache.hits, cache.misses
        self._kernel = cache.acquire(phases)
        self.stats.kernel_cache_hits += cache.hits - h0
        self.stats.kernel_cache_misses += cache.misses - m0
        self.stats.specialized = 1
        self.stats.spec_pruned_phases = len(phases.pruned)

    # -- static pre-analysis -------------------------------------------
    def _attach_static_feeds(self) -> int:
        """Run the host-side static pass once per contract (cached by
        code hash) BEFORE any lane is seeded: statically-dead branch
        directions never enter the flip frontier and inert functions
        never get dispatcher seeds. A failing pass is not fatal (the
        contract explores unpruned, as in the JAX package) but it is not
        silent either: it is recorded in the DegradationLog as
        `static-prepass-failed`. Returns the number of failed
        contracts."""
        from mythril_tpu_torch.analysis.static import static_prune_enabled

        if not static_prune_enabled():
            return 0
        from mythril_tpu_torch.analysis.static import summary_for

        failed = 0
        for ti, track in enumerate(self.tracks):
            try:
                track.static = summary_for(track.code_hex)
                mask = self.selector_masks.get(ti)
                if mask is not None:
                    # wrap the summary so the unchanged-fork selectors
                    # read as dead to seeding AND to the flip frontier
                    from mythril_tpu_torch.store.diff import SelectorMaskFeed

                    sels, directions = mask
                    track.static = SelectorMaskFeed(
                        track.static, sels, directions
                    )
                track.static_dead = frozenset(
                    track.static.prune_directions()
                )
            except Exception as why:
                failed += 1
                resilience.DegradationLog().record(
                    resilience.DegradationReason.STATIC_PREPASS_FAILED,
                    site="explorer",
                    detail=f"{type(why).__name__}: {why}; explores unpruned",
                    contract="sha256 "
                    + hashlib.sha256(self.codes[ti]).hexdigest()[:16],
                )
                track.static = None
                track.static_dead = frozenset()
        return failed

    # -- supervision ---------------------------------------------------
    def _stop_requested(self) -> bool:
        """One answer for every wave/budget/solve boundary: the owner's
        stop event, a delivered SIGINT/SIGTERM, or an expired deadline
        all read as "finish the current unit of work and wind down with
        partial outcomes". The first trigger is remembered so the final
        stats can say WHY the run ended early."""
        if self.stop_event is not None and self.stop_event.is_set():
            self._halt_reason = self._halt_reason or "stop-event"
            return True
        reason = resilience.interrupted_reason(self.deadline)
        if reason is not None:
            if self._halt_reason is None:
                self._halt_reason = reason
                resilience.DegradationLog().record(
                    reason, site="explorer",
                    detail="exploration wound down at a wave boundary",
                )
            return True
        return False

    # -- seeding -------------------------------------------------------
    def _seed_phase_inputs(
        self, offset: int = 0
    ) -> List[List[Tuple[int, bytes]]]:
        """Per contract: (carry index, calldata) pairs — every carry
        crossed with the dispatcher seeds, round-robin to the stripe.

        `offset` continues the same deterministic seed stream `offset`
        stripes further along — the pipelined schedule fills its
        second in-flight slot with the stream's next window (the only
        inputs derivable before any wave has been harvested)."""
        from mythril_tpu_torch.laser.batch.seeds import dispatcher_seeds

        stripes = []
        for track in self.tracks:
            if track.selector_seeds is None:
                # cache only the deterministic part (zero + dispatcher
                # selectors); the random filler below is re-drawn each
                # phase so later transactions don't replay identical
                # calldata. The static feed masks inert selectors out
                # of the wave seeding (drops logged at DEBUG there).
                before = track.static.seeds_dropped if track.static else 0
                track.selector_seeds = dispatcher_seeds(
                    track.code_hex, self.calldata_len, prune=track.static
                )
                if track.static is not None:
                    self.stats.static_seeds_dropped += (
                        track.static.seeds_dropped - before
                    )
            seeds = list(track.parent_inputs) + track.selector_seeds
            while len(seeds) < self.lanes_per_contract:
                seeds.append(
                    bytes(
                        self.rng.randrange(256)
                        for _ in range(self.calldata_len)
                    )
                )
            n_carries = len(track.carries)
            shift = offset * self.lanes_per_contract
            stripes.append(
                [
                    (
                        j % n_carries,
                        seeds[((j + shift) // n_carries) % len(seeds)],
                    )
                    for j in range(self.lanes_per_contract)
                ]
            )
        return stripes

    # -- solving -------------------------------------------------------
    def _lower_flips(self, batch, indices=None):
        """Lower flip queries for the device stage (`lower_flips`)."""
        return lower_flips(batch, indices)

    def _sprint_cap_s(self) -> float:
        """The escalation ladder's wall cap for one wave's host-CDCL
        pass (args.sprint_cap_s, CLI --sprint-cap-s)."""
        from mythril_tpu_torch.support.support_args import args as _flags

        return max(0.0, float(_flags.sprint_cap_s))

    def _sprint_flips(self, batch, out, skip=frozenset()):
        """The escalation ladder behind the device funnel (the JAX
        package's `_sprint_flips`): a host-CDCL pass over the device's
        UNKNOWN survivors of a wave's flip batch (`skip` holds the
        device-answered indices). Each query goes through `get_model`
        at 2000 ms, on the explorer's device (where the
        --parallel-solving escape searches); the pass as a whole is
        capped at `_sprint_cap_s()`,
        and every query past the cap is recorded SPRINT_PREEMPTED with
        the actual cap (`capture.capture_flip`), counted in
        `ladder_deferred` and retried next wave. A zero cap defers every
        survivor (no host solve).

        Writes assignments into `out` in place (`stats.host_sat` counts
        them); returns (capped, survivors): the index set that never got
        a REAL attempt (wall cap / stop request), and the capped and
        attempted-but-undecided indices (solver timeouts)."""
        t0 = time.perf_counter()
        sprint_span = trace("flip.solve.host", queries=len(batch))
        sprint_span.__enter__()
        survivors: List[int] = []
        capped: set = set()
        # the pass is time-capped as a whole: once hard queries have
        # eaten this much wall, the rest are recorded preempted and
        # retried next wave (they already had their batched device
        # attempt this wave)
        sprint_cap_s = self._sprint_cap_s()
        stopped = False
        with query_context(QUERY_ORIGIN_FLIP):
            for i, conditions in enumerate(batch):
                if i in skip or out[i] is not None:
                    continue
                # a stop request bounds post-stop work to the query in
                # flight
                if stopped or self._stop_requested():
                    stopped = True
                    capped.add(i)
                    continue
                if sprint_cap_s <= 0.0 or time.perf_counter() - t0 > sprint_cap_s:
                    survivors.append(i)
                    capped.add(i)
                    self.ladder_deferred += 1
                    # the loss artifact names the cap that preempted
                    # the query (the tuning knob for the ladder)
                    try:
                        lowered, _ = lower([c.raw for c in conditions])
                        query_capture.capture_flip(
                            lowered,
                            verdict="unknown",
                            wall_s=0.0,
                            engine="host-cdcl",
                            site="sprint_flips",
                            loss_reason=LOSS_SPRINT_PREEMPTED,
                            detail={"sprint_cap_s": sprint_cap_s},
                        )
                    except Exception:
                        log.debug("sprint-cap capture failed", exc_info=True)
                    continue
                try:
                    model = get_model(
                        tuple(conditions),
                        enforce_execution_time=False,
                        solver_timeout=2000,
                        device=self.device,
                    )
                    self.stats.host_sat += 1
                    out[i] = dict(model.assignment)
                except UnsatError:
                    pass
                except SolverTimeOutException:
                    survivors.append(i)
                # any other exception (a failed host build, a race that
                # cannot start) propagates: the JAX ladder's catch-all
                # would hide it as a timeout
        sprint_span.__exit__(None, None, None)
        if stopped:
            # post-stop, undecided queries get no further stage this
            # wave; capped ones stay retriable
            survivors = []
        self.stats.flip_solve_s += time.perf_counter() - t0
        return capped, survivors

    def _device_flips(self, out, lowered_batch, kept):
        """The device stage: ONE batched dispatch for the
        whole wave's flip frontier (device-first funnel). The dispatch
        runs the diversified SLS portfolio, exhaustive enumeration of
        small spaces, and the cube-and-conquer fan
        (portfolio.device_solve_batch) on the card; every SAT is
        witness-validated before it counts, and enumeration UNSATs are
        device-OWNED verdicts that never escalate.

        Writes witnesses into `out`; returns (answered, unsat): the
        device-decided index sets (the escalation ladder skips both).
        """
        answered: set = set()
        unsat: set = set()
        record = self._reseed_record
        record["lowered"] = len(lowered_batch)
        if not lowered_batch:
            return answered, unsat
        from mythril_tpu_torch.support import breaker as _cb

        if not _cb.allow(_cb.TIER_DEVICE_SOLVE):
            # breaker open: the whole frontier goes to the escalation
            # ladder — no doomed device dispatch
            return answered, unsat
        t0 = time.perf_counter()
        solve_stats: Dict = {}
        try:
            with trace("flip.solve.device", queries=len(lowered_batch)):
                verdicts = portfolio.device_solve_batch(
                    lowered_batch,
                    candidates=self.portfolio_candidates,
                    device=self.device,
                    stats=solve_stats,
                )
        except Exception as why:
            if not resilience.is_device_fault(why):
                raise
            # a faulted solver dispatch degrades this wave's frontier
            # to the ladder and feeds the breaker — repeated faults trip
            # it open and later waves skip the stage
            _cb.record(_cb.TIER_DEVICE_SOLVE, False, str(why))
            resilience.DegradationLog().record(
                resilience.DegradationReason.DEVICE_DISPATCH_FAILED,
                site="flip.solve.device",
                detail=str(why),
            )
            return answered, unsat
        _cb.record(_cb.TIER_DEVICE_SOLVE, True)
        dt = time.perf_counter() - t0
        per_query = dt / max(1, len(kept))
        by_via = record["verdicts"]
        for qi, (i, verdict) in enumerate(zip(kept, verdicts)):
            via = verdict.via if verdict.status != "unknown" else "unknown"
            by_via[via] = by_via.get(via, 0) + 1
            if verdict.status == "sat":
                self.stats.device_sat += 1
                out[i] = verdict.assignment
                answered.add(i)
            elif verdict.status == "unsat":
                # a complete enumeration exhausted the space: the
                # device owns this unsat — no escalation
                self.stats.device_unsat += 1
                answered.add(i)
                unsat.add(i)
            if verdict.via == "enum":
                self.stats.device_enumerated += 1
            elif verdict.via == "cube":
                self.stats.device_cube_sat += 1
            # flight recorder: the batched dispatch bypasses the host
            # solver, so these flip-frontier queries capture here
            query_capture.capture_flip(
                lowered_batch[qi],
                verdict=verdict.status,
                wall_s=per_query,
                hop=0,
                loss_reason=verdict.loss,
                detail={"via": verdict.via} if verdict.via else None,
            )
        record["solve_ms"] += dt * 1e3
        record["witness_invalid"] += int(solve_stats.get("witness_invalid", 0))
        self.stats.flip_solve_s += dt
        return answered, unsat

    def _witness_bytes(self, assignment: Dict[str, int]) -> bytes:
        return witness_bytes(assignment, self.calldata_len)

    # -- the wave ------------------------------------------------------
    def _batch_kwargs(self, payload) -> Dict:
        """make_batch's arguments for a payload (the cold build, the
        checkpoint flush)."""
        env = dict(REPLAY_ENV)
        env["balance"] = payload.balances
        return dict(
            code_ids=self.code_ids,
            calldata=[data for _, data in payload.flat],
            callvalue=payload.callvalues,
            caller=DEFAULT_CALLER,
            address=self.address,
            mem_cap=self.mem_cap,
            storage_cap=self.storage_cap,
            storage_seed=payload.storage_seed,
            empty_world=self.empty_world,
            **env,
        )

    def _prepare_wave(self, inputs: List[List[Tuple[int, bytes]]]):
        """Snapshot one wave's host-side seed data (a _WavePayload) and
        hand its checkpoint flush to the background writer.

        The snapshot matters: carry journals are mutated in place by
        later harvests (ensure_poison_carries), so both the dispatch
        and the asynchronously-written checkpoint must read copies
        taken at seeding time — the flushed frontier is the one that
        DISPATCHED, whatever the host learned afterwards."""
        flat = [pair for stripe in inputs for pair in stripe]
        L = self.lanes_per_contract
        carries = []
        for lane, (ci, _) in enumerate(flat):
            live = self.tracks[lane // L].carries[ci]
            snap = dict(live)
            snap["journal"] = dict(live["journal"])
            snap["prefix"] = list(live["prefix"])
            if live.get("base"):
                snap["base"] = dict(live["base"])
            if live.get("prefix_values"):
                snap["prefix_values"] = list(live["prefix_values"])
            carries.append(snap)
        payload = _WavePayload(
            inputs=inputs,
            flat=flat,
            lane_carry=[ci for ci, _ in flat],
            carries=carries,
            storage_seed=[c["journal"] for c in carries],
            callvalues=[c.get("callvalue", 0) for c in carries],
            balances=[
                c.get("balance", REPLAY_ENV["balance"]) for c in carries
            ],
            synthetic=np.array([bool(c.get("base")) for c in carries]),
            serial=self._wave_serial,
        )
        self._wave_serial += 1
        if self._ckpt_writer is not None:
            # flush the SEEDED frontier: a wave killed mid-flight
            # (fault, OOM, SIGKILL) leaves its exact inputs on disk,
            # and the engine is deterministic, so replay_wave
            # reproduces the lost wave bit-for-bit. The serialization
            # runs on the writer thread (atomic rename), overlapping
            # the dispatch instead of preceding it.
            path = self.checkpoint_path
            table = self._code_table_host
            steps = self.steps_per_wave

            def _flush(payload=payload):
                frontier = make_batch_numpy(
                    len(payload.flat), **self._batch_kwargs(payload)
                )
                save_checkpoint(
                    path,
                    frontier,
                    table,
                    step=steps,
                    extra={
                        "synthetic": payload.synthetic.astype(np.uint8)
                    },
                    atomic=True,
                )

            self._ckpt_writer.submit(_flush)
            self.stats.wave_checkpoints += 1
        return payload

    def _cold_sym(self, payload):
        """Full host-side batch build + upload (the first wave and the
        fault-retry path)."""
        base = make_batch(
            len(payload.flat), device=self.device, **self._batch_kwargs(payload)
        )
        sym = make_sym_batch(base)
        if payload.synthetic.any():
            # poisoned start states are SAMPLES of the host's symbolic
            # initial storage: reads of them must count as opaque so
            # arithmetic over them banks (wrap or opaque-site) events
            # instead of masquerading as path constants
            mark_synthetic(sym, payload.synthetic)
        return sym

    def _warm_sym(self, payload, carcass):
        """Reseed out of the previous wave's buffers, in place: the host
        uploads only the per-wave seed delta (calldata, values, a
        width-bucketed storage slab) — symbolic.reseed_wave_inplace.
        The slabs are built in numpy (torch.uint32 has no arithmetic on
        the CPU) and uploaded once."""
        from mythril_tpu_torch.ops import u256

        n = len(payload.flat)
        limbs = u256.LIMBS
        widest = max((len(j) for j in payload.storage_seed), default=0)
        w = 1
        while w < min(widest, self.storage_cap):
            w <<= 1
        skeys = np.zeros((n, w, limbs), np.uint32)
        svals = np.zeros((n, w, limbs), np.uint32)
        scnt = np.zeros((n,), np.int32)
        for i, journal in enumerate(payload.storage_seed):
            for j, (slot, value) in enumerate(
                list(journal.items())[: self.storage_cap]
            ):
                skeys[i, j] = u256.from_int(slot)
                svals[i, j] = u256.from_int(value)
                scnt[i] = j + 1
        cd_w = 1
        while cd_w < self.calldata_len:
            cd_w <<= 1
        cd = np.zeros((n, cd_w), np.uint8)
        cds = np.zeros((n,), np.int32)
        for i, (_ci, data) in enumerate(payload.flat):
            m = min(len(data), cd_w)
            if m:
                cd[i, :m] = np.frombuffer(bytes(data[:m]), np.uint8)
            cds[i] = len(data)
        cv = np.stack(
            [u256.from_int(int(v)) for v in payload.callvalues]
        ).astype(np.uint32)
        bal = np.stack(
            [u256.from_int(int(v)) for v in payload.balances]
        ).astype(np.uint32)
        return reseed_wave_inplace(
            carcass,
            self.code_ids,
            cd,
            cds,
            cv,
            bal,
            skeys,
            svals,
            scnt,
            payload.synthetic,
        )

    def _wave_job(self, payload, carcass, generic: bool = False):
        """One wave's device work, start to end: seed it (in place into
        `carcass` when there is one, else cold), run it on the
        specialized kernel (unless `generic`, or there is none), read it
        back. Returns (out, steps, active lane-steps, ArenaView, times:
        ms of the seeding, the run and the readback, and whether the
        seeding reused a spent wave's buffers, and (substep lane-steps,
        blocks entered) of a specialized run, else None). The view's
        fetch synchronizes the stream the wave ran on, so a CUDA fault
        of the wave surfaces here, inside the caller's containment."""
        t0 = time.perf_counter()
        sym = self._cold_sym(payload) if carcass is None else self._warm_sym(
            payload, carcass
        )
        t1 = time.perf_counter()
        sub = None
        if self._kernel is not None and not generic:
            # the contract-specialized kernel: pruned phases + block or
            # fused substeps (specialize.py, blockjit.py)
            out, steps, active, fused, blocks = self._kernel.sym_run(
                sym, self.code_table, self._fuse_tbl,
                max_steps=self.steps_per_wave, donate=True,
            )
            sub = (int(fused), int(blocks))
        else:
            out, steps, active = sym_run_inplace(
                sym, self.code_table, max_steps=self.steps_per_wave
            )
        t2 = time.perf_counter()
        view = ArenaView(out)
        t3 = time.perf_counter()
        times = {"seed_ms": (t1 - t0) * 1e3, "run_ms": (t2 - t1) * 1e3,
                 "readback_ms": (t3 - t2) * 1e3, "warm": carcass is not None}
        return out, steps, int(active), view, times, sub

    def _on_wave_thread(self, fn):
        """Run `fn` where the waves run: on the pipelined schedule, the
        explorer's one wave thread, on its own CUDA stream (a future is
        returned); lock-step, inline (the result is returned). One
        thread and one stream for every wave's device work keeps the
        reseed of a spent wave's buffers in order behind that wave."""
        if not self.pipeline:
            return None, fn()
        if self._wave_pool is None:
            self._wave_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="explore-wave"
            )
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(device=self.device)
        stream = self._stream

        def _job():
            ctx = torch.cuda.stream(stream) if stream is not None else nullcontext()
            with ctx:
                return fn()

        return self._wave_pool.submit(_job), None

    def _dispatch_wave(self, payload) -> "_Inflight":
        """Seed + dispatch one wave. Pipelined, the wave runs on the
        wave thread and the call returns at once, so the caller can
        keep consuming the previous wave while the card runs this one;
        lock-step, it runs inline. Classified dispatch-time faults are
        captured on the inflight record — harvest retries them through
        the ladder with correct wave attribution."""
        resilience.inject("explore.wave")
        fl = _Inflight(payload)
        fl.dispatch_t = time.perf_counter()
        carcass, self._carcass = self._carcass, None
        try:
            with trace("wave.dispatch", serial=payload.serial):
                fl.future, fl.result = self._on_wave_thread(
                    lambda: self._wave_job(payload, carcass)
                )
        except Exception as why:
            if not resilience.is_device_fault(why):
                raise
            # the wave never completed: its carcass is spent; harvest
            # re-dispatches it cold under the ladder
            fl.failed = why
        return fl

    def _retry_wave(self, fl):
        """The resilience ladder for a wave whose dispatch or readback
        faulted: cold re-dispatch from the retained host payload (the
        in-place warm path cannot replay — its input buffers are
        spent), synchronous, attributed to the faulted wave's serial,
        on the explorer's own device (never the CPU). Retries always run
        the GENERIC kernel: a fault on a specialized dispatch is not
        retried into the same specialized loop."""
        if self._kernel is not None:
            self.stats.spec_fallbacks += 1

        def _cold():
            future, result = self._on_wave_thread(
                lambda: self._wave_job(fl.payload, None, generic=True)
            )
            return result if future is None else future.result()

        return resilience.retry_device_dispatch(
            _cold,
            label="wave",
            policy=resilience.RetryPolicy(attempts=2, base_delay_s=0.2),
        )

    def _harvest_wave(self, fl) -> ArenaView:
        """Join the wave — the single point where the wave's faults
        surface, so the fault containment lives HERE, attributed to the
        wave that actually faulted even when a newer wave is already in
        flight — and take its compacted evidence readback (ArenaView,
        host copies only)."""
        wait0 = time.perf_counter()
        with trace("wave.harvest", serial=fl.payload.serial):
            if fl.failed is None:
                try:
                    result = fl.result if fl.future is None else fl.future.result()
                    resilience.inject("device.dispatch")
                    out, steps, active, view, times, sub = result
                except Exception as why:
                    if not resilience.is_device_fault(why):
                        raise
                    resilience.DegradationLog().record(
                        resilience.DegradationReason.ASYNC_DEVICE_FAULT,
                        site=f"wave#{fl.payload.serial}",
                        detail=str(why),
                    )
                    self._carcass = None
                    out, steps, active, view, times, sub = self._retry_wave(fl)
            else:
                out, steps, active, view, times, sub = self._retry_wave(fl)
        now = time.perf_counter()
        self.stats.device_wait_s += now - wait0
        if fl.dispatch_t is not None:
            self.stats.device_busy_s += max(0.0, now - fl.dispatch_t)
            # the retrospective device-execution span: dispatch to
            # readback-ready
            flight_recorder().add(
                "wave.device",
                fl.dispatch_t,
                now,
                track="device",
                serial=fl.payload.serial,
            )
        # the spent buffers are the next dispatch's reseed target
        # (everything the host needs is in the view's numpy)
        self._carcass = out
        self.stats.arena_nodes = max(self.stats.arena_nodes, view.count)
        self.stats.waves += 1
        self.stats.device_steps += int(active)
        if sub is not None:
            # instructions the substeps advanced beyond the full steps'
            # active count: a block wave counts into blockjit_steps, a
            # fuse-only wave into spec_fused_steps, never both
            fused, blocks = sub
            if self.kernel_phases.block_depth > 0:
                self.stats.blockjit_steps += fused
                self.stats.blockjit_blocks += blocks
            else:
                self.stats.spec_fused_steps += fused
        self.stats.device_steps_raw += int(steps) * len(fl.payload.flat)
        self.stats.evidence_bytes += view.bytes_fetched
        self.stats.evidence_bytes_full += view.bytes_full
        self.wave_log.append(dict(
            times, serial=fl.payload.serial, txn=self.stats.transactions - 1,
            steps=int(steps), active=int(active), lanes=len(fl.payload.flat),
            wait_ms=(now - wait0) * 1e3, wall_ms=None,
        ))
        return view

    def _consume_wave(self, view: ArenaView, payload) -> None:
        """Fold one harvested wave into the tracks: triggers, carries,
        coverage, evidence, poison bookkeeping. Pure host work — under
        the pipelined schedule this (plus the reseed's flip solving)
        is exactly what overlaps the next wave's device execution."""
        with trace("wave.consume", serial=payload.serial):
            return self._consume_wave_inner(view, payload)

    def _consume_wave_inner(self, view: ArenaView, payload) -> None:
        flat = payload.flat
        L = self.lanes_per_contract
        status, halt_pc = view.status, view.halt_pc
        gas_min, gas_max = view.gas_min, view.gas_max
        tables = view.storage_tables()
        self._lane_carry = payload.lane_carry
        self.stats.lanes_degraded_mem += int(
            (status == Status.ERR_MEM).sum()
        )
        self.stats.lanes_degraded_unsupported += int(
            (status == Status.UNSUPPORTED).sum()
        )
        self._pending_props: List[Tuple[int, int, List]] = []
        srcs_memo: Dict[int, set] = {}
        for t in self.tracks:
            # a poison stripe is accounted for once the wave CARRYING
            # it has been harvested (under pipelining that wave may be
            # a later serial than the next one harvested)
            pending = getattr(t, "_poison_pending_serial", None)
            if pending is not None and payload.serial >= pending:
                t._poison_pending_serial = None
        for lane, (ci, data) in enumerate(flat):
            track = self.tracks[lane // L]
            if track.idle or track.parked:
                # parked: the published-final claim stays sound only
                # because nothing (evidence, degradation, carries)
                # mutates a frozen track
                continue
            # the SNAPSHOT carry, not the live one: poison journals
            # are refreshed in place by harvests that may run between
            # this wave's dispatch and its consume (pipelining), and
            # the lane executed against the snapshot
            carry = payload.carries[lane]
            st = int(status[lane])
            if st in (Status.ERR_MEM, Status.UNSUPPORTED):
                track.degraded += 1
            kind = TRIGGER_KINDS.get(st)
            if kind is not None:
                bucket = track.triggers.setdefault(kind, [])
                pc = int(halt_pc[lane])
                # one witness per faulting pc is what a report needs
                if all(pc != t["pc"] for t in bucket) and len(bucket) < 64:
                    trig = {
                        "pc": pc,
                        "input": data,
                        "prefix": list(carry["prefix"]),
                        "gas_min": int(gas_min[lane]),
                        "gas_max": int(gas_max[lane]),
                        "call_value": carry.get("callvalue", 0),
                        "prefix_values": list(
                            carry.get("prefix_values", [])
                        ),
                    }
                    if carry.get("base"):
                        trig["initial_storage"] = {
                            hex(k): hex(v)
                            for k, v in carry["base"].items()
                        }
                    if carry.get("balance"):
                        trig["initial_balance"] = carry["balance"]
                    bucket.append(trig)
            if st in (Status.STOPPED, Status.RETURNED):
                # the device mutation pruner: only end states whose
                # journal gained writes become next-tx start states
                journal = storage_dict_from(tables, lane)
                if journal != carry["journal"]:
                    if track.bank_carry(
                        journal,
                        list(carry["prefix"]) + [data],
                        parent=carry,
                    ):
                        self.stats.carries_banked += 1
            rows = view.journal(lane)
            for pc, taken, _tid in rows:
                track.covered.add((pc, taken))
            self._consume_evidence(
                track,
                view,
                lane,
                data,
                carry,
                st,
                int(gas_min[lane]),
                int(gas_max[lane]),
                rows,
                srcs_memo,
            )
        for track in self.tracks:
            if not track.idle:
                # the concolic symbolic-initial-storage axis: observed
                # never-written reads become adversarial start states
                track.ensure_poison_carries()
        for ci, track in enumerate(self.tracks):
            track.corpus.extend(payload.inputs[ci])

    #: env-source opcode -> the predictable-vars module's operation text
    _ENV_OPERATION = {
        "TIMESTAMP": "The block.timestamp environment variable",
        "NUMBER": "The block.number environment variable",
        "COINBASE": "The block.coinbase environment variable",
        "GASLIMIT": "The block.gaslimit environment variable",
        "BLOCKHASH": "The block hash of a previous block",
    }

    def _consume_evidence(
        self, track, view, lane, data, carry, st, gmin, gmax, rows, srcs_memo
    ) -> None:
        """Fold one lane's banked events + journal provenance into the
        track's evidence map. Everything recorded here was CONCRETELY
        exhibited by the lane — the record's input/prefix replays it —
        so issue synthesis (analysis/evidence.py) needs no solver.

        Calls with a calldata-derived target additionally enqueue a
        STEERING query (path + target == attacker): its witness seeds a
        lane next wave, whose concrete execution then confirms the
        SWC-105/107/112 property the reference modules solve for."""

        def base(extra: Dict) -> Dict:
            rec = {
                "input": data,
                "prefix": list(carry["prefix"]),
                "gas_min": gmin,
                "gas_max": gmax,
                "call_value": carry.get("callvalue", 0),
                "prefix_values": list(carry.get("prefix_values", [])),
            }
            if carry.get("base"):
                # poisoned start state: the witness must declare the
                # synthetic initial storage it assumed
                rec["initial_storage"] = {
                    hex(k): hex(v) for k, v in carry["base"].items()
                }
            if carry.get("balance"):
                rec["initial_balance"] = carry["balance"]
            rec.update(extra)
            return rec

        halted_clean = st in (Status.STOPPED, Status.RETURNED)
        n_branches = int(view.br_cnt[lane])
        if int(view.ev_overflow[lane]):
            track.event_overflow = True
        if int(view.ev_cnt[lane]):
            for ev in view.events(lane):
                pc, k = ev["pc"], ev["kind"]
                if k in WRAP_EVENT_OPS:
                    exact = {
                        1: ev["a"] + ev["b"] >= 2**256,
                        2: ev["a"] < ev["b"],
                        3: ev["a"] * ev["b"] >= 2**256,
                    }[k]
                    key = ("wrap", pc)
                    if not exact:
                        # the device's wrap flag over-approximated (MUL
                        # uses a 128-bit hi check): whether any input
                        # wraps HERE is undecided on device. Mark the
                        # site opaque — ownership is withheld unless a
                        # steering query (kinds 10-12) or a later exact
                        # wrap resolves the same pc
                        track.opaque_sites.add(pc)
                    if exact and key not in track.evidence:
                        # "the wrapped value was USED" (integer.py's
                        # promotion rule): DAG reachability when the
                        # result is a term; for opaque results (taint-
                        # hashed mapping reads) the static in-block
                        # store/return check stands in
                        used = (
                            view.wrap_used(lane, ev["tid"])
                            if ev["tid"] > 0
                            else track.result_stored_in_block(pc)
                        )
                        if used:
                            track.evidence[key] = base(
                                {
                                    "class": "wrap",
                                    "pc": pc,
                                    "op": WRAP_EVENT_OPS[k],
                                }
                            )
                elif k in CALL_EVENT_KINDS:
                    mnemonic = CALL_EVENT_KINDS[k]
                    key = ("call", pc, mnemonic)
                    to_attacker = ev["a"] == DEFAULT_CALLER
                    rec = track.evidence.get(key)
                    if rec is None:
                        rec = track.evidence[key] = base(
                            {
                                "class": "call",
                                "pc": pc,
                                "kind": mnemonic,
                                "gas": ev["gas"],
                                "to_attacker": False,
                                "value_to_attacker": False,
                                "target_tainted": ev["tid"] != 0,
                                "unchecked": False,
                            }
                        )
                    rec["gas"] = max(rec["gas"], ev["gas"])
                    rec["target_tainted"] = rec["target_tainted"] or ev["tid"] != 0
                    if to_attacker and not rec["to_attacker"]:
                        # THIS lane exhibits the attacker-target
                        # property: its input is the witness worth
                        # reporting
                        rec.update(
                            to_attacker=True,
                            input=data,
                            prefix=list(carry["prefix"]),
                            gas_min=gmin,
                            gas_max=gmax,
                        )
                    if to_attacker:
                        # the stipend gate for attacker-targeted issues
                        # must see gas from a lane that ALSO proved the
                        # target — not the max over unrelated lanes
                        rec["attacker_gas"] = max(
                            rec.get("attacker_gas", 0), ev["gas"]
                        )
                    sent = sum(
                        carry.get("prefix_values", [])
                    ) + carry.get("callvalue", 0)
                    if to_attacker and ev["b"] > sent and not rec["value_to_attacker"]:
                        # the attacker PROFITS: receives more than the
                        # whole sequence sent in (ether_thief.py's
                        # balance-increase property). THIS lane's input
                        # replays the profit — bank it beside the shared
                        # record so the synthesized issue's witness
                        # exhibits the property it claims
                        rec["value_to_attacker"] = True
                        # explicit None/0 defaults: the merged issue
                        # dict must not inherit the shared record's
                        # initial_storage/balance when THIS lane ran
                        # without them (the witness would declare a
                        # synthetic start state it never assumed)
                        rec["w_profit"] = dict(
                            {"initial_storage": None, "initial_balance": 0},
                            **base({}),
                        )
                    if (
                        halted_clean
                        and n_branches == ev["aux"]
                        and not rec["unchecked"]
                    ):
                        # the lane ended with NO branch after the call:
                        # nothing ever constrained the return value.
                        # Same rule: the witness is this lane's input
                        rec["unchecked"] = True
                        rec["w_unchecked"] = dict(
                            {"initial_storage": None, "initial_balance": 0},
                            **base({}),
                        )
                    # steering: make a lane send the call to the
                    # attacker (confirms next wave, concretely)
                    if (
                        ev["tid"] > 0
                        and ev["gas"] > GAS_STIPEND
                        and k in (4, 6)
                        and not rec["to_attacker"]
                        and (pc, k) not in track.prop_attempted
                    ):
                        conds = self._steer_conditions(view, lane, ev)
                        if conds is not None:
                            track.prop_attempted.add((pc, k))
                            self._pending_props.append(
                                (lane // self.lanes_per_contract,
                                 self._lane_carry[lane],
                                 conds,
                                 (pc, k))
                            )
                elif k in (10, 11, 12):
                    # tainted arithmetic that has not wrapped on any
                    # lane yet: steer a lane into the wrap (the witness
                    # seeds next wave; the concrete wrap then banks as
                    # kind 1-3 and becomes evidence)
                    if (
                        ("wrap", pc) not in track.evidence
                        and (pc, k) not in track.prop_attempted
                    ):
                        conds = self._steer_wrap_conditions(view, lane, ev)
                        if conds is not None:
                            track.prop_attempted.add((pc, k))
                            self._pending_props.append(
                                (lane // self.lanes_per_contract,
                                 self._lane_carry[lane],
                                 conds,
                                 (pc, k))
                            )
                elif k in (8, 9):
                    access = "SSTORE" if k == 8 else "SLOAD"
                    key = ("state_acc", pc, access)
                    if key not in track.evidence:
                        track.evidence[key] = base(
                            {"class": "state_acc", "pc": pc, "access": access}
                        )
                elif k == 13:
                    track.storage_reads.add(ev["a"])
                elif k == 15:
                    track.opaque_sites.add(pc)
        for pc, taken, tid in rows:
            if tid == 0:
                continue
            srcs = srcs_memo.get(tid)
            if srcs is None:
                srcs = srcs_memo[tid] = view.dag_source_ops(tid)
            if "ORIGIN" in srcs:
                key = ("env", pc, "115")
                if key not in track.evidence:
                    track.evidence[key] = base(
                        {"class": "env", "pc": pc, "swc": "115", "operation": ""}
                    )
            hits = [s for s in PREDICTABLE_SRCS if s in srcs]
            if hits:
                swc = "116" if "TIMESTAMP" in hits else "120"
                key = ("env", pc, swc)
                if key not in track.evidence:
                    track.evidence[key] = base(
                        {
                            "class": "env",
                            "pc": pc,
                            "swc": swc,
                            "operation": self._ENV_OPERATION[hits[0]],
                        }
                    )

    def _steer_conditions(self, view, lane, ev):
        """Path-prefix + (target == attacker) [+ value > 0] for a call
        event — the property the reference's 105/107/112 modules query,
        phrased as a seed-derivation problem."""
        from mythril_tpu_torch.laser.smt import UGT, symbol_factory

        target = view.term(ev["tid"], lane)
        if target is None:
            return None
        path = view.path_condition(lane, ev["aux"] - 1, flip_last=False) or []
        attacker = symbol_factory.BitVecVal(DEFAULT_CALLER, 256)
        conds = path + [target == attacker]
        if ev["kind"] == 4 and ev["vtid"] > 0:
            value = view.term(ev["vtid"], lane)
            if value is not None:
                conds.append(UGT(value, symbol_factory.BitVecVal(0, 256)))
        return conds

    def _steer_wrap_conditions(self, view, lane, ev):
        """Path-prefix + the exact wrap predicate for a tainted arith
        site — the property integer.py solves at transaction end,
        phrased as a seed-derivation problem."""
        from mythril_tpu_torch.laser.smt import UDiv, UGT, ULT, symbol_factory

        operands = view.row_operand_terms(ev["tid"], lane)
        if operands is None:
            return None
        a, b = operands
        path = view.path_condition(lane, ev["aux"] - 1, flip_last=False) or []
        zero = symbol_factory.BitVecVal(0, 256)
        if ev["kind"] == 10:  # ADD wraps iff a + b < a
            wrap = ULT(a + b, a)
        elif ev["kind"] == 11:  # SUB wraps iff a < b
            wrap = ULT(a, b)
        else:  # MUL wraps iff b != 0 and a > MAX // b
            maxw = symbol_factory.BitVecVal(2**256 - 1, 256)
            wrap = UGT(a, UDiv(maxw, b))
            path = path + [b != zero]
        return path + [wrap]

    def _collect_flip_candidates(
        self, view: ArenaView, ci: int
    ) -> List[Tuple[int, List, Tuple[int, bool]]]:
        """Contract ci's un-attempted frontier branches this wave: one
        candidate per lane (`lane_flip_candidate`: the lane's first
        flippable uncovered target), each a (carry index, decoded path
        condition, target) triple. A flip witness stays bound to its
        source lane's carry — the path condition only holds under that
        start state."""
        track = self.tracks[ci]
        if track.parked:
            return []  # frozen: flags untouched
        if track.idle:
            track.exhausted = True
            return []
        L = self.lanes_per_contract
        candidates: List[Tuple[int, List, Tuple[int, bool]]] = []
        # every lane may contribute one candidate (bounded by the lane
        # count): surplus feasible witnesses still seed lanes, so
        # oversampling loses nothing — while under-sampling would
        # blacklist targets via `attempted` without ever solving them
        for lane in range(ci * L, (ci + 1) * L):
            found, counts = lane_flip_candidate(
                view, lane, track.covered, track.attempted, track.static_dead
            )
            self.stats.static_pruned_flips += counts["pruned"]
            self.stats.forks_tried += counts["tried"]
            # opaque decision upstream: unflippable. Recorded — the
            # ownership gate demands some concrete lane cover the
            # target anyway (poison samples usually do) before the
            # contract can be device-owned.
            track.opaque_branches.update(counts["opaque"])
            self._reseed_record["opaque"] += len(counts["opaque"])
            if found is not None:
                _k, conditions, target = found
                candidates.append((self._lane_carry[lane], conditions, target))
        return candidates

    def _reseed(
        self, view: ArenaView
    ) -> Tuple[Optional[List[List[Tuple[int, bytes]]]], int]:
        """(next-wave inputs, pending flip work): per contract, flip
        witnesses topped up with mutations of its corpus. Inputs are
        None when every contract's frontier is exhausted; the count is
        flip witnesses plus sprint-capped candidates still awaiting a
        genuine solve (so the phase loop never concludes exhaustion
        over queries nobody attempted).

        Candidates are collected across the WHOLE corpus first and
        solved as one batch, so hard queries share a single device
        dispatch instead of paying per-query latency. Only the
        host-symbolic stages (term decode + lowering, and the ladder's
        CDCL) hold the host lock; the device dispatch and the track
        bookkeeping are lock-free."""
        self._reseed_record = record = {
            "wave": self._wave_serial, "candidates": 0, "steering": 0,
            "opaque": 0, "lowered": 0, "solve_ms": 0.0, "verdicts": {},
            "witnesses": 0, "witness_invalid": 0, "deferred": 0,
        }
        deferred0 = self.ladder_deferred
        props = getattr(self, "_pending_props", [])
        self._pending_props = []
        guard = self.host_lock if self.host_lock is not None else nullcontext()
        self.lock_wanted.set()
        try:
            with guard:
                per_contract = [
                    self._collect_flip_candidates(view, ci)
                    for ci in range(len(self.tracks))
                ]
                flat = [c for cands in per_contract for c in cands]
                # property-steering queries ride the same funnel batch as
                # the flips (same cost model, same device dispatch)
                batch = [cond for _, cond, _ in flat] + [p[2] for p in props]
                solved: List[Optional[Dict[str, int]]] = [None] * len(batch)
                # the device-first funnel: the WHOLE frontier lowers
                # under the lock to one batched device dispatch, whose
                # cost does not grow with the query count and which
                # fires lock-free
                lowered_batch, kept = self._lower_flips(batch)
        finally:
            self.lock_wanted.clear()
        answered, device_unsat = self._device_flips(solved, lowered_batch, kept)
        # the escalation ladder: host CDCL only sees the device's unknown
        # survivors (and the queries that never lowered)
        self.lock_wanted.set()
        try:
            with guard:
                capped, _survivors = self._sprint_flips(batch, solved, skip=answered)
        finally:
            self.lock_wanted.clear()
        # a capped query that the device also failed to answer (or that
        # never compiled) had no genuine attempt; sprint-attempted and
        # device-answered ones (including device-owned unsats) are
        # spoken for
        retriable = {
            i
            for i in capped
            if solved[i] is None and i not in device_unsat and i < len(flat)
        }
        # steering witnesses: calldata that makes a banked call site
        # target the attacker — seeded below, confirmed concretely by
        # the next wave's event bank
        steer: Dict[int, List[Tuple[int, bytes]]] = {}
        for j, (tidx, carry_idx, _conds, key) in enumerate(props):
            assignment = solved[len(flat) + j]
            trk = self.tracks[tidx]
            if assignment is not None:
                witness = self._witness_bytes(assignment)
                steer.setdefault(tidx, []).append((carry_idx, witness))
                trk.flip_corpus.append(witness)
                # sat resolves the property only once a seeded lane
                # CONFIRMS it concretely (wrap/to_attacker evidence —
                # _unresolved_steering checks that side)
            elif len(flat) + j not in capped:
                # a genuine unsat answer closes the property
                trk.prop_resolved.add(key)
            else:
                # sprint-capped: never attempted — lift the mark so a
                # later wave retries instead of leaving it open forever
                trk.prop_attempted.discard(key)

        stripes: List[List[Tuple[int, bytes]]] = []
        track_has_payload: List[bool] = []
        n_flips = 0
        n_retriable = 0
        cursor = 0
        for ci, track in enumerate(self.tracks):
            if track.parked:
                # frozen stripe: shape-stable placeholder lanes (empty
                # calldata halts immediately); harvest ignores them
                stripes.append([(0, b"")] * self.lanes_per_contract)
                track_has_payload.append(False)
                continue
            fresh: List[Tuple[int, bytes]] = list(
                steer.get(ci, [])[: self.lanes_per_contract]
            )
            had_retriable = False
            for carry_idx, _cond, target in per_contract[ci]:
                assignment = solved[cursor]
                if cursor in retriable:
                    # never actually attempted (sprint cap): lift the
                    # blacklist so a later wave gets a real try
                    track.attempted.discard(target)
                    had_retriable = True
                    n_retriable += 1
                cursor += 1
                # every feasible witness seeds a lane (up to the stripe
                # width) — a solved flip discarded here would leave its
                # target blacklisted in `attempted` yet never explored
                if assignment is None or len(fresh) >= self.lanes_per_contract:
                    continue
                self.stats.forks_feasible += 1
                witness = self._witness_bytes(assignment)
                fresh.append((carry_idx, witness))
                track.flip_corpus.append(witness)
            # a frontier with un-attempted (capped) candidates is not
            # exhausted — it just hasn't had its turn with the solver
            track.exhausted = not fresh and not had_retriable
            if track.exhausted:
                # snapshot: if later waves (mutation-filled lanes of a
                # corpus that is still running for OTHER contracts)
                # uncover nothing new here, this frontier may claim
                # closure even when the PHASE ends on budget/wave-cap
                track._exhausted_cov = len(track.covered)
            track_has_payload.append(bool(fresh))
            n_flips += len(fresh)
            # mutation fill — and the poison carries' ONLY seed source:
            # synthetic start states are appended mid-phase, so no flip
            # or phase seed ever points at them; without this rotation
            # a poisoned state would exist but never execute
            poison_idx = track.poison_indices()
            fill_no = 0
            while len(fresh) < self.lanes_per_contract:
                carry_idx, parent = self.rng.choice(track.corpus)
                if poison_idx:
                    rotation = fill_no % (len(poison_idx) + 1)
                    if rotation < len(poison_idx):
                        carry_idx = poison_idx[rotation]
                fill_no += 1
                mutated = bytearray(parent)
                mutated[self.rng.randrange(len(mutated))] = self.rng.randrange(
                    256
                )
                fresh.append((carry_idx, bytes(mutated)))
            stripes.append(fresh[: self.lanes_per_contract])
        pending = n_flips + n_retriable
        # Poison continuation: adversarial-storage carries are created
        # AFTER the wave that observed the reads, so when the flip
        # frontier dries up in that same wave they have never run.
        # Give every unseeded poisoned state one dedicated stripe of
        # dispatcher seeds — the wave that concretely exhibits the
        # storage-dependent wraps/thefts the host finds with symbolic
        # storage.
        n_poison = 0
        for ci, track in enumerate(self.tracks):
            if track.idle or track.parked or track_has_payload[ci]:
                # flip/steer witnesses keep their stripe; the poison
                # pass waits for a drier wave
                continue
            # at most two poisoned states per wave: a full stripe per
            # state beats a sliver of every state
            pend = track.unseeded_poison()[:2]
            if not pend:
                continue
            seeds = list(track.selector_seeds or []) + list(
                track.parent_inputs or []
            )
            if not seeds:
                seeds = [b"\x00" * self.calldata_len]
            stripes[ci] = [
                (
                    pend[j % len(pend)],
                    seeds[(j // len(pend)) % len(seeds)],
                )
                for j in range(self.lanes_per_contract)
            ]
            for i in pend:
                track.carries[i]["seeded"] = True
            # the stripe is SCHEDULED but runs in the wave the NEXT
            # dispatch launches (serial self._wave_serial): finality
            # must wait for that wave's HARVEST (parking now would
            # freeze the track with the poison results discarded —
            # unsound ownership). Tagging the serial — rather than a
            # boolean the next harvest clears — keeps this sound under
            # pipelining, where an older wave is harvested after the
            # poison stripe was scheduled but before it runs.
            track._poison_pending_serial = self._wave_serial
            n_poison += 1
        pending += n_poison
        #: the phase loop must not plateau-break away a wave that
        #: carries freshly-seeded poison stripes
        self._poison_stripes_pending = n_poison
        record.update(
            candidates=len(flat),
            steering=len(props),
            witnesses=sum(1 for a in solved if a is not None),
            deferred=self.ladder_deferred - deferred0,
        )
        self.reseed_log.append(record)
        return (stripes if pending else None), pending

    # -- the phase loop ------------------------------------------------
    def _phase(self, txn: int) -> bool:
        """One attacker transaction's wave loop over the whole corpus;
        False when the wall-clock budget is exhausted. The schedule is
        either lock-step (--no-pipeline: dispatch, harvest, solve,
        repeat) or double-buffered (default: up to two waves in
        flight, host work overlapping device execution)."""
        if self.pipeline:
            return self._phase_pipelined(txn)
        return self._phase_sync(txn)

    def _plateau_break(self, plateaued: bool, n_flips: int) -> bool:
        """Coverage stalled and flips are drying up — but only once
        every poisoned state has had its seeding wave (those open
        value dimensions coverage cannot see); a wave whose stripes
        WERE just poison-seeded must run before the verdict counts."""
        quota = len(self.tracks) * self.lanes_per_contract
        return (
            plateaued
            and n_flips < max(1, quota // 4)
            and not getattr(self, "_poison_stripes_pending", 0)
            and not any(
                t.unseeded_poison() for t in self.tracks if not t.idle
            )
        )

    def _finalize_tracks(self) -> Tuple[List, bool]:
        """Early per-contract finality (last transaction phase only):
        contracts that just closed every ownership gate freeze NOW."""
        newly_parked = [
            t
            for t in self.tracks
            if not t.parked and t.finalize_if_complete()
        ]
        if newly_parked:
            self._publish_partial()
        return newly_parked, all(
            t.parked or t.idle for t in self.tracks
        )

    def _phase_sync(self, txn: int) -> bool:
        inputs = self._seed_phase_inputs()
        for wave_no in range(self.waves):
            if self._stop_requested():
                # honored before DISPATCHING a wave, not only at the
                # budget check — the last-wave break and the phase
                # advance both skip _budget_spent
                return False
            covered_before = sum(len(t.covered) for t in self.tracks)
            w0 = time.perf_counter()
            payload = self._prepare_wave(inputs)
            fl = self._dispatch_wave(payload)
            view = self._harvest_wave(fl)
            self._consume_wave(view, payload)
            self._wave_times.append(time.perf_counter() - w0)
            self.wave_log[-1]["wall_ms"] = self._wave_times[-1] * 1e3
            self.stats.wave_exec_s += self._wave_times[-1]
            if txn == 0 and wave_no == 0:
                # the first wave carries the one-time warm-up (the
                # kernels' first loads, the caching allocator's first
                # blocks); the budget governs the steady-state loop
                # after it
                self._t0 = time.perf_counter()
            self._publish_partial()
            if wave_no == self.waves - 1:
                # the wave cap ends the phase with the final wave's
                # results never reseeded: `exhausted` is stale for any
                # track whose coverage moved since its snapshot, so
                # only provably-still-exhausted frontiers stay closed
                for track in self.tracks:
                    if not track.idle and not track.still_exhausted():
                        track.frontier_closed = False
                break  # no next wave to seed; don't waste solver calls
            if self._budget_spent():
                return False
            covered_now = sum(len(t.covered) for t in self.tracks)
            plateaued = wave_no > 0 and covered_now == covered_before
            fresh, n_flips = self._reseed(view)
            if txn == self.transaction_count - 1:
                # early per-contract finality: a contract that just
                # closed all its ownership gates freezes NOW, and the
                # publisher announces it so the analysis loop can skip
                # its host walk without waiting for the corpus run
                _, all_done = self._finalize_tracks()
                if all_done:
                    return True  # everything owned or inert: run over
            if fresh is None:
                break  # every frontier exhausted: the plateau signal
            if self._plateau_break(plateaued, n_flips):
                break
            inputs = fresh
        return True

    def _phase_pipelined(self, txn: int) -> bool:
        """The double-buffered schedule: wave N+1 is seeded from the
        frontier known BEFORE wave N's results and dispatched ahead of
        wave N's consume, so the host's evidence consumption and flip
        solving for wave N overlap the device's execution of wave N+1
        (the flip witnesses land in wave N+2 — one wave later than the
        lock-step schedule, bought back by the extra dispatch slot).

        The in-flight queue holds at most two waves. Harvest order is
        dispatch order; the fault containment in _harvest_wave keeps
        per-wave attribution even when the fault is asynchronous."""
        from collections import deque

        inflight: "deque[_Inflight]" = deque()
        # the warm-up second slot rides free: the lock-step schedule
        # gets `waves` reseed generations, and so does this one
        dispatch_budget = self.waves + 1 if self.waves > 1 else self.waves
        dispatched = 0
        stop_dispatch = False
        finished = True
        harvested = 0

        def _launch(stripes) -> None:
            nonlocal dispatched
            payload = self._prepare_wave(stripes)
            inflight.append(self._dispatch_wave(payload))
            dispatched += 1
            self.stats.waves_inflight_max = max(
                self.stats.waves_inflight_max, len(inflight)
            )

        if self._stop_requested():
            return False
        _launch(self._seed_phase_inputs())
        if dispatch_budget > 1 and not self._stop_requested():
            # the second pipeline slot: the seed stream's next window —
            # the only inputs derivable before any harvest
            _launch(self._seed_phase_inputs(offset=1))

        try:
            while inflight:
                fl = inflight.popleft()
                w0 = time.perf_counter()
                view = self._harvest_wave(fl)
                h0 = time.perf_counter()
                overlapping = bool(inflight)  # device busy with wave N+1
                covered_before = sum(len(t.covered) for t in self.tracks)
                self._consume_wave(view, fl.payload)
                self._wave_times.append(time.perf_counter() - w0)
                self.wave_log[-1]["wall_ms"] = self._wave_times[-1] * 1e3
                self.stats.wave_exec_s += self._wave_times[-1]
                harvested += 1
                if txn == 0 and harvested == 1:
                    self._t0 = time.perf_counter()
                self._publish_partial()
                covered_now = sum(len(t.covered) for t in self.tracks)

                if not stop_dispatch and self._stop_requested():
                    stop_dispatch = True
                    finished = False
                if not stop_dispatch and dispatched >= dispatch_budget:
                    stop_dispatch = True  # the wave cap: drain what's left
                if not stop_dispatch and self._budget_spent():
                    stop_dispatch = True
                    finished = False
                if not stop_dispatch:
                    plateaued = harvested > 1 and covered_now == covered_before
                    fresh, n_flips = self._reseed(view)
                    if fresh is not None and not self._plateau_break(
                        plateaued, n_flips
                    ):
                        _launch(fresh)
                    # an exhausted/plateaued frontier on THIS wave only
                    # skips launching from it — a still-in-flight wave may
                    # carry flip witnesses that reopen it, and ITS harvest
                    # gets its own reseed verdict (the lock-step loop's
                    # break maps to the drain running out of launches).
                    # Per-contract finality is NOT checked here: every
                    # in-flight wave carries live stripes for every
                    # unparked track (mutation fill), so parking one now
                    # would discard results already executing — the
                    # lock-step schedule's mid-phase parking moves to the
                    # drain end below, where nothing is in flight.
                if overlapping:
                    self.stats.waves_overlapped += 1
                    self.stats.wave_overlap_s += time.perf_counter() - h0
        finally:
            # waves a fault past the ladder abandoned still run to their
            # end on the wave thread: wait for each and read its outcome
            for fl in inflight:
                if fl.future is not None:
                    fl.future.exception()

        # the phase's last harvested wave(s) were never reseeded: the
        # lock-step final-wave rule applies — only provably-still-
        # exhausted frontiers stay closed
        for track in self.tracks:
            if not track.idle and not track.still_exhausted():
                track.frontier_closed = False
        if txn == self.transaction_count - 1 and finished:
            self._finalize_tracks()
        return finished

    def _publish_partial(self) -> None:
        if self.publish is None:
            return
        for ci, track in enumerate(self.tracks):
            if track.parked:
                # the frozen FINAL outcome — final_for_contract lets
                # the ownership consumer act on it mid-run
                outcome = dict(track._final_outcome)
            else:
                outcome = track.outcome()
            # per-track copy: consumers annotate their stats dict
            # (witness_issues), so sharing one object across contracts
            # would let them clobber each other
            outcome["stats"] = dict(self.stats.as_dict(), partial=True)
            self.publish(ci, outcome)

    def _budget_spent(self) -> bool:
        return self._allowance_spent(self._phase_allowance)

    def _hard_stop(self) -> bool:
        """The +45s slack line past which even a phase's guaranteed
        opening wave is forfeit (billed in the mode's own currency:
        active time when overlapped, wall otherwise)."""
        if self.budget_s is None:
            return False
        if self.host_lock is not None:
            active = self.stats.wave_exec_s + self.stats.flip_solve_s
            return active > self.budget_s + 45
        return time.perf_counter() - self._t_start > self.budget_s + 45

    def _allowance_spent(self, allowance: Optional[float]) -> bool:
        if self._stop_requested():
            return True
        budget_s = allowance if allowance is not None else self.budget_s
        if budget_s is None:
            return False
        # predict the next wave from steady-state waves only — wave 0
        # carries the warm-up, so until a second wave has run the
        # prediction is optimistic by design (the overshoot is bounded
        # by one wave)
        predicted = (
            min(self._wave_times[1:]) if len(self._wave_times) > 1 else 0.0
        )
        if self.host_lock is not None:
            # overlapped: bill only ACTIVE time — wall spent waiting on
            # the lock is the main thread's analysis time, not ours
            active = self.stats.wave_exec_s + self.stats.flip_solve_s
            if active > budget_s + 45:
                return True
            steady = active - (
                self._wave_times[0] if self._wave_times else 0.0
            )
            return steady + predicted > budget_s
        # hard stop: the whole prepass — warm-up included — may cost at
        # most one warm-up allowance (45s, the JAX package's compile
        # allowance) on top of the steady-state budget; the first wave
        # itself cannot be interrupted from here
        if time.perf_counter() - self._t_start > budget_s + 45:
            return True
        elapsed = time.perf_counter() - self._t0
        return elapsed + predicted > budget_s

    def run(self) -> Dict:
        """Phase loop: one wave loop per attacker transaction, carries
        (mutated storage journals + their calldata prefixes) advancing
        between phases. Stops at `transaction_count`, on a corpus-wide
        dead end, or on the wall-clock budget."""
        from mythril_tpu_torch.laser.smt.solver.device_race import DEVICE_BUSY

        DEVICE_BUSY.acquire()
        try:
            with trace("explore.run", contracts=len(self.tracks)):
                return self._run_phases()
        finally:
            if self._wave_pool is not None:
                # every dispatched wave was harvested or abandoned; the
                # thread ends with the run (a later run() makes a new one)
                self._wave_pool.shutdown(wait=True)
                self._wave_pool = None
            if self._ckpt_writer is not None:
                # outcomes must never race their own checkpoints; close
                # also retires the worker thread
                self._ckpt_writer.close()
            if self._kernel is not None:
                # unpin this run's bucket (the cache may now evict it)
                from mythril_tpu_torch.laser.batch.specialize import kernel_cache

                kernel_cache().release(self._kernel)
            DEVICE_BUSY.release()

    def _run_phases(self) -> Dict:
        self._t_start = self._t0 = time.perf_counter()
        self._wave_times: List[float] = []
        for txn in range(self.transaction_count):
            if txn >= 2 and self._hard_stop():
                # A spent budget ends the CURRENT phase's wave loop but
                # phase 2 (the `-t 2` threat model) still gets its
                # unconditional opening wave; DEEPER phases only open
                # while inside the hard stop's +45s slack — without
                # this gate a `-t 4` corpus run overshoots by one
                # ~30-60s wave per remaining phase. Checked BEFORE
                # advance_phase(): the break must not first consume the
                # banked carries and wipe the last phase's corpus stats
                # (outcomes would publish corpus_size 0 after a full
                # phase of exploration).
                for track in self.tracks:
                    if track.next_carries:
                        # a banked tx-N+1 start state will never run
                        track.frontier_closed = False
                break
            if txn > 0:
                advanced = [t.advance_phase() for t in self.tracks]
                if not any(advanced):
                    break  # no contract mutated state: tx N+1 is moot
                for track in self.tracks:
                    track.corpus = []
            # Cumulative allowance per transaction phase: phase k may
            # spend at most (k+1)/T of the budget, so phase 1 cannot
            # eat the whole budget before the later transactions — the
            # `-t 2` threat model — ever execute (the last phase's
            # share is the full budget). Without this, a corpus-sized
            # wave bill starves phase 2 exactly when the multi-tx
            # exploration matters most.
            self._phase_allowance = (
                None
                if self.budget_s is None
                else self.budget_s * (txn + 1) / self.transaction_count
            )
            if txn == self.transaction_count - 1:
                # carries dropped during the LAST phase feed no further
                # phase: overflow there must not block completeness
                for track in self.tracks:
                    track._final_phase_overflow_base = track.carry_overflow
            self.stats.transactions = txn + 1
            try:
                with trace("phase", txn=txn, contracts=len(self.tracks)):
                    finished = self._phase(txn)
            except DeviceDispatchError as why:
                # a wave died past the retry ladder: the exploration
                # DEGRADES — every live frontier reopens (those
                # contracts go to the host walk), the banked evidence
                # and coverage so far stay valid, and the corpus run
                # continues instead of crashing
                resilience.DegradationLog().record(
                    resilience.DegradationReason.WAVE_ABANDONED,
                    site="explorer",
                    detail=str(why),
                )
                self.stats.device_faults += 1
                for track in self.tracks:
                    if not track.idle and not track.still_exhausted():
                        track.frontier_closed = False
                break
            # completeness accounting: a phase that ended on budget or
            # wave cap (or a stop request) leaves live frontiers open —
            # those contracts are NOT device-complete and the ownership
            # gate must send them to the host walk
            stopped = self._stop_requested()
            for track in self.tracks:
                if not track.idle and not track.exhausted:
                    track.frontier_closed = False
                if (
                    (not finished or stopped)
                    and not track.idle
                    and not track.still_exhausted()
                ):
                    # the PHASE ended early (budget/wave-cap/stop), but
                    # a track whose own frontier exhausted — and whose
                    # coverage hasn't moved since — is done regardless
                    # of why the corpus loop stopped; marking every
                    # track open here was the corpus-scale ownership
                    # killer (32-contract bench: 0 owned)
                    track.frontier_closed = False
            # A stop request (the owner's stop event, a signal, an
            # expired deadline) ends everything now.
            if stopped:
                break

        for track in self.tracks:
            base = getattr(track, "_final_phase_overflow_base", None)
            if base is not None:
                track.carry_overflow = base
        self.stats.branches_covered = sum(len(t.covered) for t in self.tracks)
        self.stats.wall_s = round(time.perf_counter() - self._t_start, 3)
        self.stats.wave_exec_s = round(self.stats.wave_exec_s, 3)
        self.stats.flip_solve_s = round(self.stats.flip_solve_s, 3)
        # pipeline observability: how much of the device's execution
        # span the host covered with concurrent work, how much of the
        # run the device sat idle, and what the compacted readback
        # transferred per wave (bench.py reports all three)
        busy = self.stats.device_busy_s
        wall = self.stats.wall_s
        self.stats.wave_overlap_ratio = (
            round(min(1.0, self.stats.wave_overlap_s / busy), 3)
            if busy > 0
            else 0.0
        )
        self.stats.device_idle_frac = (
            round(max(0.0, min(1.0, 1.0 - busy / wall)), 3)
            if wall > 0
            else 0.0
        )
        self.stats.evidence_bytes_per_wave = (
            int(self.stats.evidence_bytes / self.stats.waves)
            if self.stats.waves
            else 0
        )
        self.stats.device_wait_s = round(self.stats.device_wait_s, 3)
        self.stats.device_busy_s = round(self.stats.device_busy_s, 3)
        self.stats.wave_overlap_s = round(self.stats.wave_overlap_s, 3)
        if self._kernel is not None:
            # the bucket's first-call wall (0 once warm)
            self.stats.kernel_compile_s = round(self._kernel.compile_s, 3)
        stats = self.stats.as_dict()
        if self._halt_reason:
            # WHY the run ended early (deadline-expired / interrupted /
            # stop-event) — consumers mark the outcome partial with a
            # structured reason instead of guessing from counters
            stats["halt_reason"] = self._halt_reason
        return {
            "stats": stats,
            "contracts": [
                dict(t._final_outcome) if t.parked else t.outcome()
                for t in self.tracks
            ],
        }


#: ExploreStats fields that are wall-clock readings (the rest count)
TIME_STATS = frozenset({
    "wall_s", "wave_exec_s", "flip_solve_s", "wave_overlap_s",
    "device_wait_s", "device_busy_s", "wave_overlap_ratio",
    "device_idle_frac", "kernel_compile_s",
})


def _carry_record(carry: Dict) -> Dict:
    out = {k: v for k, v in carry.items() if k not in ("journal", "prefix", "base")}
    out["journal"] = sorted([hex(k), hex(v)] for k, v in carry["journal"].items())
    out["prefix"] = [p.hex() for p in carry["prefix"]]
    if carry.get("base"):
        out["base"] = sorted([hex(k), hex(v)] for k, v in carry["base"].items())
    return out


def wave_snapshot(explorer, payload) -> Dict:
    """What one consumed wave left behind, as plain JSON-able data: its
    serial and seeded calldata, per contract the coverage, attempted
    targets, triggers, evidence, start-state and banked carries and
    observed storage reads, and every stats counter but the times. Two
    explorers (this package's, or the JAX package's: only `tracks`,
    `stats` and `outcome()` are read) that ran the same waves give equal
    snapshots. Call it right after `_consume_wave(view, payload)`."""
    tracks = []
    for t in explorer.tracks:
        out = t.outcome()
        tracks.append({
            "covered": sorted(t.covered),
            "attempted": sorted(t.attempted),
            "triggers": out["triggers"],
            "evidence": sorted(out["evidence"], key=lambda e: json.dumps(e, sort_keys=True)),
            "carries": [_carry_record(c) for c in t.carries],
            "next_carries": [_carry_record(c) for c in t.next_carries.values()],
            "storage_reads": sorted(t.storage_reads),
        })
    stats = {k: v for k, v in explorer.stats.as_dict().items() if k not in TIME_STATS}
    doc = {"serial": payload.serial,
           "seeded": [[ci, data.hex()] for ci, data in payload.flat],
           "tracks": tracks, "stats": stats}
    return json.loads(json.dumps(doc, sort_keys=True))


def snapshot_waves(explorer) -> List[Dict]:
    """Make `explorer` append a `wave_snapshot` to the returned list
    after every wave it consumes (instance-level; for parity checks)."""
    records: List[Dict] = []
    consume = explorer._consume_wave

    def _consume(view, payload):
        consume(view, payload)
        records.append(wave_snapshot(explorer, payload))

    explorer._consume_wave = _consume
    return records


def mark_synthetic(sym, synthetic) -> None:
    """Make the seeded storage values of the `synthetic` lanes (a bool
    per lane: a poisoned start state, a sample of symbolic initial
    storage) opaque, in place — as the JAX package's wave dispatch and
    replay do."""
    dev = sym.sval_tid.device
    seeded = (
        torch.arange(sym.sval_tid.shape[1], device=dev)[None, :]
        < sym.base.storage_cnt[:, None]
    )
    mask = torch.as_tensor(np.asarray(synthetic, bool), device=dev)
    sym.sval_tid.masked_fill_(mask[:, None] & seeded, OPAQUE)


def replay_wave(path, expect_shape=None, device=None):
    """Re-execute a flushed wave checkpoint exactly, on `device` (None:
    the card).

    The explorer writes each wave's SEEDED frontier (StateBatch + code
    table + synthetic-storage mask) to `checkpoint_path` before the
    dispatch, so a run killed mid-wave loses nothing: this function
    reloads the npz (the JAX package's checkpoints too: the format is
    shared), rebuilds the symbolic batch — reapplying the synthetic
    mask the same way the wave dispatch did — and runs the wave to the
    same step budget. The engine is deterministic, so the replayed
    coverage/status/evidence equal the uninterrupted wave's.

    `expect_shape` (checkpoint.arena_shape dict, partial fine) makes a
    checkpoint written under a different arena shape refuse with a
    clear error instead of replaying garbage lanes.

    Returns (ArenaView, sym_out, steps)."""
    from mythril_tpu_torch import interop
    from mythril_tpu_torch.laser.batch.checkpoint import (
        load_checkpoint,
        load_checkpoint_extra,
    )

    batch, code, wave_steps = load_checkpoint(path, expect_shape=expect_shape)
    if code is None:
        raise ValueError("wave checkpoint carries no code table")
    sym = make_sym_batch(interop.batch_from_numpy(batch, device))
    synthetic = load_checkpoint_extra(path).get("synthetic")
    if synthetic is not None and synthetic.any():
        mark_synthetic(sym, synthetic.astype(bool))
    out, steps, _active = sym_run_inplace(
        sym, interop.code_table_from_numpy(code, device), max_steps=int(wave_steps)
    )
    return ArenaView(out), out, int(steps)


class DeviceSymbolicExplorer(DeviceCorpusExplorer):
    """Explore one contract's intra-transaction paths on device — the
    single-contract view the per-contract analysis path uses."""

    def __init__(
        self,
        code_hex: str,
        calldata_len: int = 68,
        lanes: int = 32,
        waves: int = 4,
        steps_per_wave: int = 2048,
        portfolio_candidates: int = 64,
        seed: int = 1,
        budget_s: Optional[float] = None,
        address: int = DEFAULT_ADDRESS,
        transaction_count: int = 1,
        empty_world: bool = True,
        pipeline: Optional[bool] = None,
        device=None,
    ) -> None:
        super().__init__(
            [code_hex],
            calldata_len=calldata_len,
            lanes_per_contract=lanes,
            waves=waves,
            steps_per_wave=steps_per_wave,
            portfolio_candidates=portfolio_candidates,
            seed=seed,
            budget_s=budget_s,
            address=address,
            transaction_count=transaction_count,
            empty_world=empty_world,
            pipeline=pipeline,
            device=device,
        )

    # single-contract views over the corpus bookkeeping
    @property
    def covered(self) -> Set[Tuple[int, bool]]:
        return self.tracks[0].covered

    @property
    def corpus(self) -> List[bytes]:
        return [data for _, data in self.tracks[0].corpus]

    @property
    def triggers(self) -> Dict[str, List[Dict]]:
        return self.tracks[0].triggers

    def run(self) -> Dict:
        outcome = super().run()
        single = outcome["contracts"][0]
        single["stats"] = outcome["stats"]
        return single
