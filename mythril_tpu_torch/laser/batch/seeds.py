"""Shared wave-seeding helpers.

One place for the corpus/explorer conventions: which calldata seeds
open a contract's dispatcher (zero input + every recovered selector,
padded), and how code capacities bucket to powers of two (one shape
class per size, as the JAX package's compile cache wants).

The port's own copy of the JAX package's jax-free laser/batch/seeds.py,
kept identical in behaviour: a wave seeded here is the wave the JAX
explorer would seed.
"""

from __future__ import annotations

import logging
import random
from typing import List

log = logging.getLogger(__name__)


def code_cap_bucket(max_len: int, floor: int = 1024) -> int:
    """Smallest power of two >= max_len (and >= floor)."""
    return max(floor, 1 << max(max_len - 1, 1).bit_length())


PUSH1, PUSH4, PUSH32, EQ, GT = 0x60, 0x63, 0x7F, 0x14, 0x11


def scan_selectors(code: bytes) -> List[bytes]:
    """Dispatcher selectors by a linear opcode sweep: the 4-byte
    immediate of every PUSH4 directly followed by EQ (Solidity's
    selector-compare idiom — the same pattern the disassembler's
    function recovery matches, but without building instruction
    dicts: a corpus prepass scans hundreds of contracts on the thread
    that contends with host analyses, so this path is kept at raw
    byte-sweep cost)."""
    out: List[bytes] = []
    pc = 0
    n = len(code)
    while pc < n:
        op = code[pc]
        width = op - PUSH1 + 1 if PUSH1 <= op <= PUSH32 else 0
        nxt = pc + 1 + width
        if op == PUSH4 and nxt < n and code[nxt] in (EQ, GT):
            out.append(bytes(code[pc + 1 : pc + 5]))
        pc = nxt
    return out


def dispatcher_seeds(
    code_hex: str, calldata_len: int, prune=None
) -> List[bytes]:
    """The deterministic seeds that open a contract's dispatcher: the
    zero input plus, per recovered selector, a zero-args seed and a
    max-args seed. The 0xff fill drives every argument to the integer
    boundary, so arithmetic on calldata wraps CONCRETELY in wave 1 —
    the wrap-event bank (symbolic.py) needs an exhibiting lane, and
    `selector + zeros` never wraps anything.

    `prune` (a StaticSummary, analysis/static) masks statically-dead
    selectors out of the seeding: functions whose whole resolved
    subgraph is inert never get a lane. Every drop is logged at DEBUG
    and counted on the feed (`prune.seeds_dropped`), so a wrong prune
    is diagnosable from the wave log rather than silent."""
    if code_hex.startswith("0x"):
        code_hex = code_hex[2:]
    dead = getattr(prune, "dead_selectors", None) or frozenset()
    # the all-ff seed also covers SELECTORLESS contracts (raw runtime
    # bodies), whose only boundary input would otherwise be zero
    seeds = [b"\x00" * calldata_len, b"\xff" * calldata_len]
    for selector in scan_selectors(bytes.fromhex(code_hex)):
        if selector in dead:
            prune.seeds_dropped += 2
            log.debug(
                "static prune dropped dispatcher seeds for selector "
                "0x%s (statically-inert function body)",
                selector.hex(),
            )
            continue
        seeds.append(selector.ljust(calldata_len, b"\x00"))
        seeds.append(selector + b"\xff" * (calldata_len - len(selector)))
    return seeds


def selector_seeds(
    code_hex: str,
    count: int,
    calldata_len: int,
    rng: random.Random,
    prune=None,
) -> List[bytes]:
    """`count` calldata seeds for a contract: the dispatcher seeds,
    then random fill."""
    seeds = dispatcher_seeds(code_hex, calldata_len, prune=prune)
    while len(seeds) < count:
        seeds.append(bytes(rng.randrange(256) for _ in range(calldata_len)))
    return seeds[:count]
