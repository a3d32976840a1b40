"""Stack-shuffling, arithmetic, bitwise and comparison opcodes.

Where the EVM word semantics are a single expression, the whole
handler is that expression (see `pure` in core.py). Divergences from
the reference worth knowing (both found by engine-differential
testing, cf. instructions.py round-1 notes): ADDMOD evaluates at 257
bits and MULMOD at 512 bits because the truncating formulas drift
from the EVM for residues whose sum/product overflows 256 bits.
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.laser.ethereum.evm_exceptions import VmException
from mythril_tpu_torch.laser.ethereum.vm.core import full, pure
from mythril_tpu_torch.laser.ethereum.vm.frame import Frame, as_word
from mythril_tpu_torch.laser.smt import (
    Bool,
    Concat,
    Extract,
    If,
    LShR,
    Not,
    SRem,
    UDiv,
    UGT,
    ULT,
    URem,
    ZeroExt,
    is_true,
    simplify,
    symbol_factory,
)

log = logging.getLogger(__name__)

MAX_WORD = 2**256 - 1
MOD_WORD = 2**256


def _const(v: int, bits: int = 256):
    return symbol_factory.BitVecVal(v, bits)


# ---------------------------------------------------------------------------
# stack shuffling
# ---------------------------------------------------------------------------
@full("JUMPDEST")
def _jumpdest(frame: Frame):
    pass  # a label; the work happened at the jump


@full("POP")
def _pop(frame: Frame):
    frame.stack.pop()


@full("PUSH")
def _push(frame: Frame):
    instr = frame.here
    try:
        n_bytes = int(instr["opcode"][4:])
    except ValueError:
        raise VmException("Invalid Push instruction")
    if n_bytes == 0:
        frame.push(_const(0))
        return
    literal = instr["argument"][2:]
    # PUSH data cut off by end-of-code reads as right-zero-padded
    literal = literal.ljust(2 * n_bytes, "0")
    frame.push(_const(int(literal, 16)))


@full("DUP")
def _dup(frame: Frame):
    depth = int(frame.op[3:])
    frame.push(frame.stack[-depth])


@full("SWAP")
def _swap(frame: Frame):
    depth = int(frame.op[4:]) + 1
    s = frame.stack
    s[-1], s[-depth] = s[-depth], s[-1]


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------
pure("AND", 2)(lambda a, b: a & b)
pure("OR", 2)(lambda a, b: a | b)
pure("XOR", 2)(lambda a, b: a ^ b)
pure("NOT", 1)(lambda a: _const(MAX_WORD) - a)
pure("SHL", 2)(lambda shift, value: value << shift)
pure("SHR", 2)(lambda shift, value: LShR(value, shift))
pure("SAR", 2)(lambda shift, value: value >> shift)


@full("BYTE")
def _byte(frame: Frame):
    pos = frame.stack.pop()
    word = as_word(frame.stack.pop())
    try:
        i = frame.concrete(pos)
    except TypeError:
        log.debug("BYTE with a symbolic position")
        frame.push(
            frame.fresh(f"{simplify(word)}[{simplify(as_word(pos))}]", 256)
        )
        return
    low = (31 - i) * 8
    if low < 0:
        frame.push(0)
    else:
        frame.push(
            simplify(Concat(_const(0, 248), Extract(low + 7, low, word)))
        )


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
pure("ADD", 2)(lambda a, b: a + b)
pure("SUB", 2)(lambda a, b: a - b)
pure("MUL", 2)(lambda a, b: a * b)

# division/modulo by a provably-zero divisor yields 0 (EVM rule)
pure("DIV", 2)(lambda a, b: _const(0) if b.value == 0 else UDiv(a, b))
pure("SDIV", 2)(lambda a, b: _const(0) if b.value == 0 else a / b)
pure("MOD", 2)(lambda a, b: 0 if b.value == 0 else URem(a, b))
pure("SMOD", 2)(lambda a, b: 0 if b.value == 0 else SRem(a, b))

pure("ADDMOD", 3)(
    lambda a, b, m: Extract(
        255, 0, URem(ZeroExt(1, a) + ZeroExt(1, b), ZeroExt(1, m))
    )
)
pure("MULMOD", 3)(
    lambda a, b, m: Extract(
        255, 0, URem(ZeroExt(256, a) * ZeroExt(256, b), ZeroExt(256, m))
    )
)


@full("EXP")
def _exp(frame: Frame):
    base, power = frame.pops(2)
    tags = base.annotations.union(power.annotations)
    if base.symbolic or power.symbolic:
        # stable short name via term hashes (str() of large terms is
        # costly; detectors only need a recognizable symbol)
        name = f"invhash({hash(simplify(base))})**invhash({hash(simplify(power))})"
        frame.push(frame.fresh(name, 256, tags))
    else:
        frame.push(
            symbol_factory.BitVecVal(
                pow(base.value, power.value, MOD_WORD), 256, annotations=tags
            )
        )


@full("SIGNEXTEND")
def _signextend(frame: Frame):
    width, word = frame.pops(2)
    try:
        k = frame.concrete(width)
    except TypeError:
        log.debug("SIGNEXTEND with a symbolic width")
        frame.push(frame.fresh(f"SIGNEXTEND({hash(width)},{hash(word)})", 256))
        return
    if k > 31:
        frame.push(word)
        return
    sign_bit = 1 << (k * 8 + 7)
    if is_true(simplify((word & sign_bit) == 0)):
        frame.push(word & (sign_bit - 1))
    else:
        frame.push(word | (MOD_WORD - sign_bit))


# ---------------------------------------------------------------------------
# comparisons (results stay Bool on the stack; consumers coerce)
# ---------------------------------------------------------------------------
pure("LT", 2)(lambda a, b: ULT(a, b))
pure("GT", 2)(lambda a, b: UGT(a, b))
pure("SLT", 2)(lambda a, b: a < b)
pure("SGT", 2)(lambda a, b: a > b)
pure("EQ", 2)(lambda a, b: a == b)


@full("ISZERO")
def _iszero(frame: Frame):
    item = frame.stack.pop()
    truth = Not(item) if isinstance(item, Bool) else item == 0
    frame.push(simplify(If(truth, _const(1), _const(0))))
