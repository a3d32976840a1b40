"""Deterministic benchmark-corpus synthesis (the port's copy of the JAX
package's analysis/corpusgen.py: host-only, no tensors; for the same
arguments every generator returns the JAX bytes).

BASELINE.json config 3 calls for a 1k-contract SWC-style corpus; the
image ships only the reference's 13 precompiled fixtures
(tests/testdata/inputs/*.sol.o — the inputs the reference's own CLI
tests analyze). This module synthesizes an arbitrarily large corpus
from them by *constant mutation*: each replica keeps the original's
control-flow graph byte-for-byte but carries distinct function
selectors, addresses, and data constants, so no two replicas share
hash-consed terms, solver queries, or calldata witnesses — every
contract costs the analyzer real work, exactly like a family of
forked/redeployed contracts on mainnet (the regime the reference's
per-contract loop, mythril/mythril/mythril_analyzer.py:145-185, was
built for).

What is mutated (and why it is structure-preserving):

- the 4-byte immediate of a ``PUSH4`` directly followed by ``EQ`` —
  the Solidity dispatcher's selector-compare idiom (the same pattern
  the disassembler's function-recovery matches,
  mythril/disassembler/disassembly.py:63). New selectors re-route
  which calldata reaches which function but leave every jump target
  untouched.
- ``PUSH20`` immediates — hardcoded addresses.
- the low half of a ``PUSH32`` immediate when the value is not a
  mask/sentinel (not mostly 0x00/0xff bytes) — data constants.

Jump destinations are never touched: PUSH1..PUSH3 immediates (memory
offsets, jumpdests, small constants) and mask-like words are left
alone, so every replica disassembles to the same instruction skeleton
and exercises the same paths under symbolic calldata.

Determinism: the byte stream is a pure function of (family name,
replica index, corpus seed); two processes synthesize identical
corpora.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

PUSH1, PUSH32 = 0x60, 0x7F


def _instruction_starts(code: bytes) -> List[int]:
    """Offsets of instruction starts (linear sweep, PUSH data skipped)
    — mutation must never rewrite a byte that another sweep would read
    as an opcode."""
    starts = []
    pc = 0
    while pc < len(code):
        starts.append(pc)
        op = code[pc]
        pc += 1 + (op - PUSH1 + 1 if PUSH1 <= op <= PUSH32 else 0)
    return starts


def _masklike(word: bytes) -> bool:
    """True for sentinel/mask words (mostly 0x00/0xff or few distinct
    bytes) whose value is semantic — address masks, type(uint).max,
    -1 — rather than data."""
    extreme = sum(1 for b in word if b in (0x00, 0xFF))
    return extreme >= len(word) - 2 or len(set(word)) <= 2


def mutate_constants(code: bytes, rng: random.Random) -> bytes:
    """One structure-preserving replica of `code` (see module doc)."""
    out = bytearray(code)
    starts = _instruction_starts(code)
    for i, pc in enumerate(starts):
        op = code[pc]
        if not PUSH1 <= op <= PUSH32:
            continue
        width = op - PUSH1 + 1
        arg = bytes(code[pc + 1 : pc + 1 + width])
        if len(arg) < width:
            continue  # truncated trailing push (swarm hash tail)
        nxt = code[starts[i + 1]] if i + 1 < len(starts) else None
        if width == 4 and nxt == 0x14:  # PUSH4 <sel>; EQ — dispatcher
            out[pc + 1 : pc + 5] = rng.randbytes(4)
        elif width == 20:
            out[pc + 1 : pc + 21] = rng.randbytes(20)
        elif width == 32 and not _masklike(arg):
            out[pc + 17 : pc + 33] = rng.randbytes(16)
    return bytes(out)


def fixture_dir() -> Path:
    # one resolution rule for all fixture consumers: override ->
    # vendored in-repo copy -> reference checkout (goldens.py)
    from mythril_tpu_torch.analysis.goldens import GOLDEN_FIXTURES

    return GOLDEN_FIXTURES


def load_fixtures(
    inputs: Optional[Path] = None,
) -> List[Tuple[str, str]]:
    """[(family name, runtime hex)] for every precompiled fixture."""
    inputs = inputs or fixture_dir()
    out = []
    for f in sorted(inputs.glob("*.sol.o")):
        code = f.read_text().strip()
        if code.startswith("0x"):
            code = code[2:]
        if len(code) >= 8:
            out.append((f.stem, code))
    return out


def synth_corpus(
    n_contracts: int,
    seed: int = 2024,
    inputs: Optional[Path] = None,
) -> List[Tuple[str, str, str]]:
    """`n_contracts` (runtime_hex, creation_hex="", name) rows, the
    analyze_corpus input shape. Families round-robin; replica 0 of
    each family is the unmutated original so the corpus contains the
    real fixtures, and replica k > 0 is the k-th constant mutation."""
    families = load_fixtures(inputs)
    if not families:
        return []
    corpus: List[Tuple[str, str, str]] = []
    replica = 0
    while len(corpus) < n_contracts:
        for name, code_hex in families:
            if len(corpus) >= n_contracts:
                break
            if replica == 0:
                mutant_hex = code_hex
            else:
                rng = random.Random(f"{seed}:{name}:{replica}")
                mutant_hex = mutate_constants(
                    bytes.fromhex(code_hex), rng
                ).hex()
            corpus.append((mutant_hex, "", f"{name}#{replica}"))
        replica += 1
    return corpus


def loop_contract(iterations_cap: int = 0x7F) -> str:
    """A hand-assembled deep-loop runtime (BASELINE config-4 shape):
    `n = calldata[0..31] & cap; while (n) { acc += n; n -= 1 };
    storage[0] = acc; if (calldata[32] == 0xaa) assert(false)` — the
    loop count is attacker-chosen, so bounded-loop strategies and the
    device wave budget both get exercised, and the tail assert keeps a
    detectable SWC-110 behind real loop work."""
    loop = 0x0A  # JUMPDEST lands right after the 10-byte prologue
    # prologue: n = CALLDATALOAD(0) & cap; acc = 0 (stack [acc, n])
    code = bytes(
        [0x60, 0x00, 0x35, 0x60, iterations_cap & 0xFF, 0x16, 0x60, 0x00]
    )
    code += bytes([0x90, 0x90])  # two SWAP1s (net no-op padding)
    body = bytes(
        [
            0x5B,  # loop: JUMPDEST           [acc, n]
            0x81, 0x15,  # DUP2; ISZERO       [n==0, acc, n]
            0x60, 0x00,  # PUSH1 exit (patched below)
            0x57,  # JUMPI                    [acc, n]
            0x81, 0x01,  # DUP2; ADD          [acc+n, n]
            0x90,  # SWAP1                    [n, acc']
            0x60, 0x01, 0x90, 0x03,  # PUSH1 1; SWAP1; SUB -> [n-1, acc']
            0x90,  # SWAP1                    [acc', n-1]
            0x60, loop, 0x56,  # PUSH1 loop; JUMP
        ]
    )
    exit_at = loop + len(body)
    body = body.replace(bytes([0x60, 0x00, 0x57]), bytes([0x60, exit_at, 0x57]))
    # exit: storage[0] = acc; if (calldata[32..63] == 0xaa) INVALID
    tail = bytes([0x5B, 0x60, 0x00, 0x55])  # JUMPDEST; SSTORE
    guard_at = exit_at + len(tail)
    fail_at = guard_at + 10
    tail += bytes(
        [
            0x60, 0x20, 0x35,  # PUSH1 32; CALLDATALOAD
            0x60, 0xAA, 0x14,  # == 0xaa ?
            0x60, fail_at, 0x57,  # JUMPI fail
            0x00,  # STOP
            0x5B, 0xFE,  # fail: JUMPDEST; INVALID (SWC-110)
        ]
    )
    return (code + body + tail).hex()


def degrader_contract(copy_at: int = 0x2000) -> str:
    """A runtime whose first action writes calldata FAR past the lean
    device memory cap (CALLDATACOPY to `copy_at`): device lanes demote
    to ERR_MEM and the host takeover carries the contract — the shape
    that makes the degradation counters a measured number instead of a
    structural claim. A guarded INVALID behind the copy keeps a real
    SWC-110 for the host to find."""
    code = bytes(
        [
            0x60, 0x20,  # PUSH1 32 (length)
            0x60, 0x00,  # PUSH1 0 (calldata offset)
            0x61, (copy_at >> 8) & 0xFF, copy_at & 0xFF,  # PUSH2 dest
            0x39,  # CALLDATACOPY
        ]
    )
    guard_at = len(code)
    fail_at = guard_at + 10
    code += bytes(
        [
            0x60, 0x00, 0x35,  # CALLDATALOAD(0)
            0x60, 0xAA, 0x14,  # == 0xaa ? (whole-word compare)
            0x60, fail_at, 0x57,  # JUMPI fail
            0x00,  # STOP
            0x5B, 0xFE,  # fail: JUMPDEST; INVALID
        ]
    )
    return code.hex()


def wide_contract(n_guards: int = 6, seed: int = 0) -> str:
    """A hand-assembled wide-branching runtime — the shape where the
    device engine's breadth is a STRUCTURAL advantage, not a constant
    factor. `n_guards` independent calldata guards (each its own
    32-byte word vs a distinct magic constant) plus an
    overflow-to-branch segment, an ORIGIN guard, a TIMESTAMP guard,
    and a guarded SELFDESTRUCT:

        if (cd[4+32j] == magic_j)  { mem[j] = 1 }        // j guards
        if (cd[o_w] + C == 0)      { mem[7] = 1 }        // ADD wraps (SWC-101)
        if (tx.origin == A)        { mem[8] = 1 }        // SWC-115
        if (block.timestamp == T)  { mem[9] = 1 }        // SWC-116
        if (cd[o_k] == magic_k)    { selfdestruct(caller) }  // SWC-106

    A sequential symbolic walk forks at every guard: ~2^(n_guards+4)
    path-leaves, two feasibility solves per fork (the reference's
    worklist shape, mythril/laser/ethereum/svm.py:235-271) — the
    per-contract wall grows exponentially. Branch-coverage closure on
    the device needs ONE flip per guard direction: a couple of waves
    regardless of 2^K. Storage is never written, so tx-2 starts from
    unchanged states on both engines (no carry variance)."""
    rng = random.Random(0xBEEF + seed)
    code = bytearray()

    def _guard_cd(offset: int, magic: int, body: bytes) -> None:
        # PUSH2 off CALLDATALOAD PUSH4 magic EQ ISZERO PUSH2 skip JUMPI
        code.extend([0x61, (offset >> 8) & 0xFF, offset & 0xFF, 0x35])
        code.extend([0x63]) ; code.extend(magic.to_bytes(4, "big"))
        code.extend([0x14, 0x15])
        skip = len(code) + 3 + 1 + len(body)
        code.extend([0x61, (skip >> 8) & 0xFF, skip & 0xFF, 0x57])
        code.extend(body)
        code.extend([0x5B])  # skip: JUMPDEST

    def _mark(j: int) -> bytes:
        return bytes([0x60, 0x01, 0x60, j & 0xFF, 0x53])  # mem[j] = 1

    for j in range(n_guards):
        _guard_cd(4 + 32 * j, 0xFEED0000 + rng.getrandbits(16), _mark(j))

    # overflow-to-branch: s = cd[o_w] + C; if (s == 0) { mem[7] = 1 }
    # the s == 0 witness is exactly the wrapping input, and the JUMPI
    # is integer.py's promotion site on both engines
    o_w = 4 + 32 * n_guards
    big = (2**256 - (0x10000 + rng.getrandbits(12))) | 1
    code.extend([0x61, (o_w >> 8) & 0xFF, o_w & 0xFF, 0x35])
    code.extend([0x7F]) ; code.extend(big.to_bytes(32, "big"))
    code.extend([0x01, 0x60, 0x00, 0x14, 0x15])
    skip = len(code) + 3 + 1 + 5
    code.extend([0x61, (skip >> 8) & 0xFF, skip & 0xFF, 0x57])
    code.extend(_mark(7))
    code.extend([0x5B])

    # ORIGIN guard: equality with an address the pinned replay origin
    # does not match — the taken direction is host-only (symbolic
    # origin), the branch itself banks SWC-115 from the DAG either way
    code.extend([0x32, 0x73]) ; code.extend((0xAAAA000000000000000000000000000000000000 + seed).to_bytes(20, "big"))
    code.extend([0x14, 0x15])
    skip = len(code) + 3 + 1 + 5
    code.extend([0x61, (skip >> 8) & 0xFF, skip & 0xFF, 0x57])
    code.extend(_mark(8))
    code.extend([0x5B])

    # TIMESTAMP guard (SWC-116): same shape
    code.extend([0x42, 0x63]) ; code.extend((0x5C000000 + seed).to_bytes(4, "big"))
    code.extend([0x14, 0x15])
    skip = len(code) + 3 + 1 + 5
    code.extend([0x61, (skip >> 8) & 0xFF, skip & 0xFF, 0x57])
    code.extend(_mark(9))
    code.extend([0x5B])

    # guarded SELFDESTRUCT(caller) — last: it ends the transaction
    o_k = o_w + 32
    _guard_cd(o_k, 0xDEAD0000 + rng.getrandbits(16), bytes([0x33, 0xFF]))
    code.extend([0x00])  # STOP
    return bytes(code).hex()


def bec_contract(seed: int = 0) -> str:
    """The BECToken shape (SWC-101 CVE-2018-10299): an unchecked
    `amount = cnt * value` whose product then steers control flow
    through a DIVISION — `if (m / y == x) { sstore }`. The flip of
    that branch (`m / y != x` with the mul in scope) is exactly the
    multiplication+division circuit CDCL grinds on (measured: 33.6s
    for the native CDCL; the on-chip portfolio's concrete evaluation
    finds a witness in seconds — the workload class where the solver
    race pays). An assert guard rides behind it for a detectable
    SWC-110."""
    # offsets are fixed by construction (PUSH2 jump forms throughout):
    #  0: x = cd(4); 3: y = cd(36); 6: if (y == 0) goto end
    # 12: m = x*y; 15: q = m/y; 18..24: if (q != x) goto skip
    # 25: sstore(0,1); 30 skip: guard cd(68) == magic -> fail
    # 41 end: STOP; 43 fail: INVALID
    skip, end, fail = 30, 41, 43
    code = bytearray(
        [
            0x60, 0x04, 0x35,        # x = CALLDATALOAD(4)
            0x60, 0x24, 0x35,        # y = CALLDATALOAD(36)  [x, y]
            0x80, 0x15,              # DUP1 ISZERO           [x, y, y==0]
            0x61, (end >> 8) & 0xFF, end & 0xFF, 0x57,  # JUMPI end
            0x81, 0x81, 0x02,        # DUP2 DUP2 MUL -> m    [x, y, m]
            0x81, 0x90, 0x04,        # DUP2 SWAP1 DIV -> m/y [x, y, q]
            0x82, 0x14,              # DUP3 EQ -> q == x     [x, y, e]
            0x15,                    # ISZERO                [x, y, !e]
            0x61, (skip >> 8) & 0xFF, skip & 0xFF, 0x57,  # JUMPI skip
            0x60, 0x01, 0x60, 0x00, 0x55,  # sstore(0, 1)
            0x5B,                    # skip: JUMPDEST
            0x60, 0x44, 0x35,              # CALLDATALOAD(68)
            0x60, 0xAA + (seed % 16), 0x14,  # == 0xaa+k ?
            0x61, (fail >> 8) & 0xFF, fail & 0xFF, 0x57,
            0x5B, 0x00,                    # end: JUMPDEST; STOP
            0x5B, 0xFE,                    # fail: JUMPDEST; INVALID
        ]
    )
    return bytes(code).hex()


def deadweight_contract(seed: int = 0) -> str:
    """A runtime full of statically-resolvable waste — the shape the
    static layer (analysis/static) exists to keep off the arena:

    - a constant-true guard (`PUSH1 1; PUSH1 t; JUMPI`) whose
      fall-through is a dead island (const-foldable dead direction +
      unreachable code);
    - a dispatcher with a LIVE function (SSTORE + a guarded INVALID,
      so the contract keeps a detectable SWC-110) and a DEAD function
      (`JUMPDEST PUSH1 0 DUP1 REVERT` — the classic inert revert
      body) whose seeds/flips static pruning drops.

    With pruning on and off, the ISSUE set is identical by
    construction — only the wasted lanes differ."""
    dead_fn, live_fn = 35, 40
    fail_at = 56
    live_sel = (0xFEEDC0DE + seed) & 0xFFFFFFFF
    dead_sel = (0xDEADD00D + seed * 7) & 0xFFFFFFFF
    code = bytearray(
        [
            0x60, 0x01, 0x60, 0x07, 0x57,  # PUSH1 1; PUSH1 7; JUMPI
            0x00, 0xFE,                    # dead island
            0x5B,                          # 7: JUMPDEST
            0x60, 0x00, 0x35,              # CALLDATALOAD(0)
            0x60, 0xE0, 0x1C,              # >> 224 -> selector
            0x80, 0x63,                    # DUP1; PUSH4
        ]
    )
    code += live_sel.to_bytes(4, "big")
    code += bytes([0x14, 0x60, live_fn, 0x57])  # EQ; PUSH1 live; JUMPI
    code += bytes([0x80, 0x63]) + dead_sel.to_bytes(4, "big")
    code += bytes([0x14, 0x60, dead_fn, 0x57])  # EQ; PUSH1 dead; JUMPI
    code += bytes([0x00])  # STOP (no match)
    assert len(code) == dead_fn
    code += bytes([0x5B, 0x60, 0x00, 0x80, 0xFD])  # dead: revert(0,0)
    assert len(code) == live_fn
    code += bytes([0x5B, 0x60, 0x01, 0x60, 0x00, 0x55])  # sstore(0,1)
    code += bytes([0x60, 0x04, 0x35])  # CALLDATALOAD(4)
    code += bytes([0x60, 0xAA + (seed % 16), 0x14])  # == magic?
    code += bytes([0x60, fail_at, 0x57, 0x00])  # JUMPI fail; STOP
    assert len(code) == fail_at
    code += bytes([0x5B, 0xFE])  # fail: JUMPDEST; INVALID (SWC-110)
    return bytes(code).hex()


def clean_contract(seed: int = 0) -> str:
    """A provably-clean runtime — the static-answer triage tier's
    positive shape. Two-selector dispatcher whose bodies do only what
    the semantic screen can discharge: constant-slot SSTORE (the
    arbitrary-write sentinel is unsatisfiable), constant non-wrapping
    ADD (no overflow annotation possible), constant MSTORE with no
    LOG1/marker (the UserAssertions evidence test), constant jump
    targets throughout. Every detection module screens off, so the
    triage tier answers it with an empty issue set — which IS its
    true issue set, keeping the prune differential trivially equal."""
    sel1 = (0xC0FFEE00 + seed) & 0xFFFFFFFF
    sel2 = (0x0DDBA110 + seed * 3) & 0xFFFFFFFF
    store_fn, return_fn = 0x1A, 0x24
    code = bytearray(
        [0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63]
    )  # selector = CALLDATALOAD(0) >> 224; DUP1; PUSH4
    code += sel1.to_bytes(4, "big")
    code += bytes([0x14, 0x60, store_fn, 0x57])  # EQ; PUSH1 a; JUMPI
    code += bytes([0x63]) + sel2.to_bytes(4, "big")
    code += bytes([0x14, 0x60, return_fn, 0x57])  # EQ; PUSH1 b; JUMPI
    code += bytes([0x00])  # STOP (no match)
    assert len(code) == store_fn
    # a: sstore(0, 1 + (2 + k))  — constant, non-wrapping
    code += bytes(
        [0x5B, 0x60, 0x01, 0x60, 0x02 + (seed % 16), 0x01,
         0x60, 0x00, 0x55, 0x00]
    )
    assert len(code) == return_fn
    # b: return mem[0:32] = 42 — a constant MSTORE, no marker word
    code += bytes(
        [0x5B, 0x60, 0x2A, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00,
         0xF3]
    )
    return bytes(code).hex()


def fork_contract(seed: int = 0, variant: int = 0) -> str:
    """A two-function dispatcher whose fork axis is ONE selector: the
    verdict store's incremental-reanalysis shape. `seed` fixes the
    selectors (all variants of one seed share them); `variant` mutates
    fn A's body constants only (its SSTORE value and INVALID-guard
    magic), so between two variants exactly fn A's subgraph
    fingerprint changes while fn B — which carries its own guarded
    INVALID (SWC-110) and touches no storage — stays byte-identical.
    fn B reads no storage, so the incremental diff's cross-selector
    state-flow bail stays quiet and its banked issues are mergeable.

        fn A: sstore(0, C_v); if (cd[4..35] == magic_v) INVALID
        fn B: if (cd[4..35] == 0xbb) INVALID
    """
    sel1 = (0xF0CACC1A + seed) & 0xFFFFFFFF
    sel2 = (0xBA5EBA11 + seed * 5) & 0xFFFFFFFF
    fn_a, fn_b = 26, 44
    fail_a, fail_b = 42, 55
    code = bytearray(
        [0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63]
    )  # selector = CALLDATALOAD(0) >> 224; DUP1; PUSH4
    code += sel1.to_bytes(4, "big")
    code += bytes([0x14, 0x60, fn_a, 0x57])  # EQ; PUSH1 a; JUMPI
    code += bytes([0x63]) + sel2.to_bytes(4, "big")
    code += bytes([0x14, 0x60, fn_b, 0x57])  # EQ; PUSH1 b; JUMPI
    code += bytes([0x00])  # STOP (no match)
    assert len(code) == fn_a
    code += bytes([0x5B, 0x60, 0x10 + (variant % 0xE0)])  # PUSH1 C_v
    code += bytes([0x60, 0x00, 0x55])  # sstore(0, C_v)
    code += bytes([0x60, 0x04, 0x35])  # CALLDATALOAD(4)
    code += bytes([0x60, 0xA0 + ((seed + variant) % 0x5F), 0x14])
    code += bytes([0x60, fail_a, 0x57, 0x00])  # JUMPI fail_a; STOP
    assert len(code) == fail_a
    code += bytes([0x5B, 0xFE])  # fail_a: JUMPDEST; INVALID
    assert len(code) == fn_b
    code += bytes([0x5B, 0x60, 0x04, 0x35])  # b: CALLDATALOAD(4)
    code += bytes([0x60, 0xBB, 0x14])  # == 0xbb ?
    code += bytes([0x60, fail_b, 0x57, 0x00])  # JUMPI fail_b; STOP
    assert len(code) == fail_b
    code += bytes([0x5B, 0xFE])  # fail_b: JUMPDEST; INVALID
    return bytes(code).hex()


def proxy_pair(
    seed: int = 0, variant: int = 0, collide: bool = False
) -> List[Tuple[str, str, str]]:
    """An EIP-1967 proxy + implementation row pair, the linker's
    known-positive population. The proxy's FORWARD selector does
    `DELEGATECALL(gas, SLOAD(eip1967-impl-slot), calldata)` (the
    proxy-slot provenance class); its ADMIN selector — the real
    `upgradeTo` selector — stores a PUSH20 implementation address
    into the slot (the runtime slot binding the linker resolves the
    edge through) plus a slot-0 counter write, then ends in a guarded
    INVALID so the store has an admin-attributed issue to bank.

    The implementation's address rides its row NAME
    (``impl#<seed>v<variant>@0x<addr>`` — the LinkSet address-book
    convention); the address depends only on `seed`, so two variants
    model an UPGRADE: same proxy bytes, same address, new callee code
    (`variant` mutates the impl's stored constant and guard magic —
    exactly one selector's linked fingerprint moves). `collide=True`
    makes the implementation write slot 0 — the slot the proxy's
    admin counter uses — lighting up `proxy-storage-collision`."""
    from mythril_tpu_torch.analysis.static.callgraph import EIP1967_IMPL_SLOT

    sel_fwd = (0xCA11AB1E + seed) & 0xFFFFFFFF
    sel_adm = 0x3659CFE6  # upgradeTo(address)
    impl_addr = (0x1A << 152) | ((0xBEEF0000 + seed) & 0xFFFFFFFF)
    fn_fwd, fn_adm, fail_adm = 26, 72, 143

    proxy = bytearray([0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63])
    proxy += sel_fwd.to_bytes(4, "big")
    proxy += bytes([0x14, 0x60, fn_fwd, 0x57])
    proxy += bytes([0x63]) + sel_adm.to_bytes(4, "big")
    proxy += bytes([0x14, 0x60, fn_adm, 0x57])
    proxy += bytes([0x00])  # no match: STOP
    assert len(proxy) == fn_fwd
    # forward: delegatecall(GAS, sload(impl_slot), 0, cds, 0, 0)
    proxy += bytes([0x5B, 0x60, 0x00, 0x60, 0x00, 0x36, 0x60, 0x00])
    proxy += bytes([0x7F]) + EIP1967_IMPL_SLOT.to_bytes(32, "big")
    proxy += bytes([0x54, 0x5A, 0xF4, 0x50, 0x00])
    assert len(proxy) == fn_adm
    # admin: sstore(impl_slot, PUSH20 impl_addr); sstore(0, 1);
    # guarded INVALID (the bankable SWC-110)
    proxy += bytes([0x5B, 0x73]) + impl_addr.to_bytes(20, "big")
    proxy += bytes([0x7F]) + EIP1967_IMPL_SLOT.to_bytes(32, "big")
    proxy += bytes([0x55])
    proxy += bytes([0x60, 0x01, 0x60, 0x00, 0x55])
    proxy += bytes([0x60, 0x04, 0x35, 0x60, 0xAA, 0x14])
    proxy += bytes([0x60, fail_adm, 0x57, 0x00])
    assert len(proxy) == fail_adm
    proxy += bytes([0x5B, 0xFE])

    impl = _linked_leaf(
        selector=sel_fwd,
        value=0x10 + (variant % 0xE0),
        slot=0x00 if collide else 0x01,
        magic=0xA0 + ((seed + 7 * variant) % 0x5F),
    )
    return [
        (bytes(proxy).hex(), "", f"proxy#{seed}"),
        (impl, "", f"impl#{seed}v{variant}@0x{impl_addr:040x}"),
    ]


def minimal_proxy(seed: int = 0) -> List[Tuple[str, str, str]]:
    """An EIP-1167 minimal proxy (the 45-byte literal runtime) plus
    its constant callee — the `minimal-proxy` provenance class, where
    the target address sits IN the bytecode, no taint pass needed."""
    from mythril_tpu_torch.analysis.static.callgraph import (
        MINIMAL_PROXY_PREFIX,
        MINIMAL_PROXY_SUFFIX,
    )

    target_addr = (0x2B << 152) | ((0xC10E0000 + seed) & 0xFFFFFFFF)
    code = (
        MINIMAL_PROXY_PREFIX
        + target_addr.to_bytes(20, "big")
        + MINIMAL_PROXY_SUFFIX
    )
    callee = _linked_leaf(
        selector=(0xD00DFEED + seed) & 0xFFFFFFFF,
        value=0x21 + (seed % 0x40),
        slot=0x02,
        magic=0xB1 + (seed % 0x4E),
    )
    return [
        (code.hex(), "", f"minproxy#{seed}"),
        (callee, "", f"mincallee#{seed}@0x{target_addr:040x}"),
    ]


def cross_call_pair(seed: int = 0) -> List[Tuple[str, str, str]]:
    """A calls B at a constant (PUSH20) address with ATTACKER-tainted
    calldata (CALLDATACOPY of the full input) and then branches on
    the returned word (MLOAD 0 after the CALL) — the known positive
    for BOTH `tainted-cross-contract-call-arg` (attacker bytes flow
    into the callee's calldata through a `constant`-provenance edge)
    and `untrusted-return-data-in-guard` (the post-call guard's
    condition carries the ATTACKER|UNKNOWN memory-join signature)."""
    b_addr = (0x3C << 152) | ((0xB0B00000 + seed) & 0xFFFFFFFF)
    sel = (0xFEEDC0DE + seed) & 0xFFFFFFFF
    fn_at, fail_at = 17, 64
    code = bytearray([0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63])
    code += sel.to_bytes(4, "big")
    code += bytes([0x14, 0x60, fn_at, 0x57, 0x00])
    assert len(code) == fn_at
    # calldatacopy(0, 0, cds)
    code += bytes([0x5B, 0x36, 0x60, 0x00, 0x60, 0x00, 0x37])
    # call(GAS, B, 0, 0, cds, 0, 32)
    code += bytes([0x60, 0x20, 0x60, 0x00, 0x36, 0x60, 0x00, 0x60, 0x00])
    code += bytes([0x73]) + b_addr.to_bytes(20, "big")
    code += bytes([0x5A, 0xF1, 0x50])
    # if (mload(0)) INVALID — guard on the callee's return word
    code += bytes([0x60, 0x00, 0x51, 0x60, fail_at, 0x57, 0x00])
    assert len(code) == fail_at
    code += bytes([0x5B, 0xFE])
    callee = _linked_leaf(
        selector=(0x0B5E55ED + seed) & 0xFFFFFFFF,
        value=0x31 + (seed % 0x40),
        slot=0x03,
        magic=0xC2 + (seed % 0x3D),
    )
    return [
        (bytes(code).hex(), "", f"crosscaller#{seed}"),
        (callee, "", f"crosscallee#{seed}@0x{b_addr:040x}"),
    ]


def _linked_leaf(
    selector: int, value: int, slot: int, magic: int
) -> str:
    """The shared callee shape of the link fixtures: one-selector
    dispatcher, `sstore(slot, value)`, then a guarded INVALID
    (SWC-110) so every leaf has a findable issue and a per-variant
    fingerprint axis (`value`/`magic`)."""
    fn_at, fail_at = 17, 33
    code = bytearray([0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63])
    code += selector.to_bytes(4, "big")
    code += bytes([0x14, 0x60, fn_at, 0x57, 0x00])
    assert len(code) == fn_at
    code += bytes([0x5B, 0x60, value & 0xFF, 0x60, slot & 0xFF, 0x55])
    code += bytes([0x60, 0x04, 0x35, 0x60, magic & 0xFF, 0x14])
    code += bytes([0x60, fail_at, 0x57, 0x00])
    assert len(code) == fail_at
    code += bytes([0x5B, 0xFE])
    return bytes(code).hex()


def poison_contract(seed: int = 0) -> str:
    """The quarantine differential's poison fixture: a syntactically
    ordinary dispatcher (one storage-writing function ending in a
    guarded INVALID, so a normal analysis WOULD report SWC-110) whose
    selectors are distinctive per seed. The contract is behaviorally
    benign — what makes it "poison" in the chaos tests is the harness:
    wave faults are injected while (and only while) this contract is
    resident, modelling a contract whose lowering reliably wedges the
    device. The differential then asserts every OTHER contract's
    issue set is identical with and without the poison in the corpus,
    and the poison itself settles FAILED with
    DegradationReason.QUARANTINED."""
    fn_at = 22
    fail_at = 38
    sel = (0xBADC0FFE + seed * 0x11) & 0xFFFFFFFF
    code = bytearray(
        [0x60, 0x00, 0x35, 0x60, 0xE0, 0x1C, 0x80, 0x63]
    )  # selector = CALLDATALOAD(0) >> 224; DUP1; PUSH4
    code += sel.to_bytes(4, "big")
    code += bytes([0x14, 0x60, fn_at, 0x57])  # EQ; PUSH1 fn; JUMPI
    code += bytes([0x60, 0x00, 0x80, 0xFD])  # no match: revert(0,0)
    while len(code) < fn_at:
        code += bytes([0x00])
    code += bytes([0x5B, 0x60, 0x01 + (seed % 16), 0x60, 0x00, 0x55])
    code += bytes([0x60, 0x04, 0x35])  # CALLDATALOAD(4)
    code += bytes([0x60, 0xC3, 0x14])  # == 0xc3 ?
    code += bytes([0x60, fail_at, 0x57, 0x00])  # JUMPI fail; STOP
    assert len(code) == fail_at
    code += bytes([0x5B, 0xFE])  # fail: JUMPDEST; INVALID (SWC-110)
    return bytes(code).hex()


def synth_bench_corpus(
    n_contracts: int,
    seed: int = 2024,
    loops: int = 4,
    degraders: int = 4,
    wides: int = 6,
    deadweights: int = 2,
    cleans: int = 2,
    dupes: int = 0,
    forks: int = 0,
    proxy_pairs: int = 0,
    minimal_proxies: int = 0,
    cross_call_pairs: int = 0,
    inputs: Optional[Path] = None,
) -> List[Tuple[str, str, str]]:
    """The round-5 benchmark corpus: fixture constant-mutants plus
    hand-assembled deep-loop, cap-degrading, wide-branching, and
    static-deadweight shapes, so the A/B exercises bounded loops,
    device degradation/takeover, the ownership gate, the breadth
    regime (sequential walk exponential vs device branch-coverage
    closure), and the static prune layer in one measured run."""
    rng = random.Random(seed)
    corpus = synth_corpus(
        max(
            0,
            n_contracts
            - loops
            - degraders
            - wides
            - deadweights
            - cleans
            - dupes
            - forks
            - 2 * (proxy_pairs + minimal_proxies + cross_call_pairs),
        ),
        seed=seed,
        inputs=inputs,
    )
    for k in range(loops):
        cap = (0x1F, 0x3F, 0x7F, 0xFF)[k % 4]
        corpus.append((loop_contract(cap), "", f"loop#{k}"))
    for k in range(degraders):
        at = 0x2000 + 0x400 * (k % 4)
        corpus.append((degrader_contract(at), "", f"degrader#{k}"))
    for k in range(wides):
        corpus.append((wide_contract(6 + (k % 3), seed=k), "", f"wide#{k}"))
    for k in range(deadweights):
        corpus.append((deadweight_contract(seed=k), "", f"deadweight#{k}"))
    for k in range(cleans):
        corpus.append((clean_contract(seed=k), "", f"clean#{k}"))
    # the verdict-store population (the JAX package's mythril_tpu/store): `dupes` exact
    # byte-for-byte copies of earlier rows (the exact-hit tier's
    # repeat traffic) and `forks` single-selector-mutated fork pairs
    # (base variant + mutant variant — the incremental tier's
    # fingerprint-diff traffic)
    base_rows = [row for row in corpus if row[0]] or [
        (fork_contract(0, 0), "", "storebase#0")
    ]
    for k in range(dupes):
        src = base_rows[k % len(base_rows)]
        corpus.append((src[0], "", f"{src[2]}#dupe{k}"))
    for k in range(forks):
        corpus.append(
            (fork_contract(seed=k // 2, variant=k % 2), "", f"fork#{k}")
        )
    # the linker's known-positive population: EIP-1967 proxy pairs
    # (every other one with a deliberate storage collision), EIP-1167
    # minimal proxies, and tainted A-calls-B pairs — the bench link
    # leg asserts these resolve
    for k in range(proxy_pairs):
        corpus.extend(proxy_pair(seed=k, variant=0, collide=bool(k % 2)))
    for k in range(minimal_proxies):
        corpus.extend(minimal_proxy(seed=k))
    for k in range(cross_call_pairs):
        corpus.extend(cross_call_pair(seed=k))
    rng.shuffle(corpus)
    return corpus[:n_contracts]


def _check_skeleton(original: bytes, mutant: bytes) -> bool:
    """Same instruction skeleton: identical opcode bytes at identical
    offsets (only PUSH immediates may differ)."""
    if len(original) != len(mutant):
        return False
    starts = _instruction_starts(original)
    return starts == _instruction_starts(mutant) and all(
        original[pc] == mutant[pc] for pc in starts
    )
