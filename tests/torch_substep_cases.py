"""Hand-built states for one substep, shared by the specialization and
blockjit parity tests: one lane a case, each with its own code row, so
every hazard the JAX substeps decide on has a lane of its own.

`substep_state()` returns (names, fields, ops, length, table, stack_tid):
the batch as numpy arrays in the JAX package's layout and dtypes
(`make_batch_numpy`), the code table's arrays (ops zero-padded by 33,
lengths), the u8 substep table (block-program codes: a fusible op marked
ROW_FUSE or ROW_HEAD, an ALU op ROW_BODY or ROW_HEAD, so a fuse-mode
substep, which takes only ROW_FUSE, skips the others) and the shadow
stack's tids. The table is narrower than the code rows, so a pc past its
width reads its last column, as the JAX gather clips.

`sweep_state(n, seed, subjects)` returns the same tuple for `n` seeded
lanes, each a short program of its own that starts on one subject op (an
ALU op, a SWAPn, a DUPn or a PUSHn; `SWEEP_SUBJECTS`, cycled over the
lanes) and goes on with random ops, most of them lowered, under random
table rows, so every substep of a launch has work: ALU operands drawn from
random words and edge words (0, 1, 2**255, 2**256 - 1, runs of 0xFFFF
limbs, shift amounts 0/15/16/255/256/2**200, BYTE 31/32, SIGNEXTEND
30/31, MUL at 2**128 +- 1), programs that start near the table's and the
code's ends, stacks from empty to the cap, gas at and past the budget and
wrapping mod 2**32, halted lanes, and tids that are mostly concrete.
"""

import numpy as np

from mythril_tpu_torch.laser.batch.state import make_batch_numpy
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support.opcodes import OPCODES

STACK_CAP = 24
CODE_CAP = 64
TABLE_W = 40
M256 = (1 << 256) - 1
NEG = lambda x: (-x) & M256  # noqa: E731

B = {name: entry[0] for name, entry in OPCODES.items()}


def _case(name, code, stack=(), pc=0, row=None, tids=None, **kw):
    return dict(name=name, code=bytes(code), stack=list(stack), pc=pc, row=row,
                tids=list(tids) if tids is not None else [0] * len(stack), **kw)


def _alu(name, *stack, tids=None, row=2):
    return _case(name.lower() + str(len(stack)), [B[name.split()[0]]], stack, row=row,
                 tids=tids)


CASES = [
    _case("push1", [0x60, 0x2A], [5], row=1),
    _case("push32", [0x7F] + list(range(1, 33)), [], row=1),
    _case("push2 past the code length", [0x61, 0xAB], [], pc=4, row=1),
    _case("push at pc 31: coverage bit 31", [0x5B] * 31 + [0x61, 0xAB, 0xCD], [1], pc=31,
          row=1),
    _case("push at pc 45: the table clips to its last column", [0x5B] * 45 + [0x60, 7],
          [], pc=45, row=1),
    _case("push, unmarked", [0x60, 1], [], row=0),
    _case("push at the stack cap", [0x60, 1], [3] * STACK_CAP, row=1),
    _case("push one below the cap", [0x60, 1], [3] * (STACK_CAP - 1), row=3),
    _case("push, gas wraps mod 2**32", [0x60, 1], [], row=1, gas_min=(1 << 32) - 1,
          gas_budget=100),
    _case("push, gas exactly the budget", [0x60, 1], [], row=1, gas_min=97,
          gas_budget=100),
    _case("push, gas one short", [0x60, 1], [], row=1, gas_min=98, gas_budget=100),
    _case("push, halted", [0x60, 1], [], row=1, status=1),
    _case("dup3", [0x82], [7, 8, 9], row=1, tids=[4, 0, 6]),
    _case("dup16 underflow", [0x8F], [1] * 15, row=1),
    _case("dup1 at the cap", [0x80], [2] * STACK_CAP, row=1),
    _case("swap2", [0x91], [1, 2, 3], row=1, tids=[5, 0, 7]),
    _case("swap16", [0x9F], list(range(17)), row=3, tids=list(range(17))),
    _case("swap3 underflow", [0x92], [1, 2], row=1),
    _case("pop", [0x50], [5, 6], row=1, tids=[0, 9]),
    _case("jumpdest, block head", [0x5B], [], row=3),
    _case("sstore marked by mistake", [0x55], [1, 2], row=2),
    _alu("ADD", 5, 7, tids=[0, 0]),
    _alu("ADD wraps", M256, 2),
    _alu("ADD tainted", 5, 7, tids=[0, 4]),
    _alu("SUB", 3, 10),
    _alu("SUB underflows", 10, 3),
    _alu("MUL", 1 << 100, 3),
    _alu("MUL overflows", 1 << 200, 1 << 100),
    _alu("MUL coarse: an operand above 128 bits", 1, 1 << 130),
    _alu("MUL by zero above 128 bits", 0, 1 << 130),
    _alu("AND", 0xF0F0, 0xFF00),
    _alu("OR", 0xF0F0, 0xFF00, tids=[0, 0], row=3),
    _alu("XOR", M256, 0x1234),
    _alu("NOT", 0x1234),
    _alu("NOT opaque operand", 0x1234, tids=[-1]),
    _alu("LT", 9, 3),
    _alu("GT", 9, 3),
    _alu("SLT", 5, NEG(1)),
    _alu("SGT", 5, NEG(1)),
    _alu("SLT both negative", NEG(2), NEG(7)),
    _alu("EQ", 1 << 255, 1 << 255),
    _alu("ISZERO", 0, 0),
    _alu("ISZERO tainted operand", 0, 0, tids=[0, 3]),
    _alu("ISZERO second operand tainted", 1, 0, tids=[3, 0]),
    _alu("BYTE", 0xA1B2C3 << 8, 29),
    _alu("BYTE index 32", 0xFF, 32),
    _alu("SHL", 0x8001, 4),
    _alu("SHL by 255", 3, 255),
    _alu("SHL by 256", 3, 256),
    _alu("SHL by 2**20", 3, 1 << 20),
    _alu("SHR", 0x8001 << 200, 17),
    _alu("SAR negative", NEG(0x100), 4),
    _alu("SAR negative by 256", NEG(5), 256),
    _alu("SAR negative by a huge amount", NEG(5), 1 << 70),
    _alu("SAR positive", 1 << 254, 250),
    _alu("SIGNEXTEND byte 0", 0x80, 0),
    _alu("SIGNEXTEND byte 1 positive", 0x7FFF, 1),
    _alu("SIGNEXTEND byte 30", (1 << 247) | 5, 30),
    _alu("SIGNEXTEND byte 31", 0x80, 31),
    _alu("SIGNEXTEND huge index", 0x80, 1 << 40),
    _alu("ADD underflow", 1),
    _alu("LT gas short", 1, 2),
]
CASES[-1]["gas_min"], CASES[-1]["gas_budget"] = 98, 100


def substep_state():
    n = len(CASES)
    fields = make_batch_numpy(n, code_ids=list(range(n)), calldata=[b""] * n,
                              stack_cap=STACK_CAP)
    ops = np.zeros((n, CODE_CAP + 33), np.uint8)
    length = np.zeros((n,), np.int32)
    table = np.zeros((n, TABLE_W), np.uint8)
    tids = np.zeros((n, STACK_CAP), np.int32)
    stack = fields.stack.copy()
    for i, case in enumerate(CASES):
        code = case["code"]
        ops[i, :len(code)] = np.frombuffer(code, np.uint8)
        length[i] = len(code)
        if case["row"]:
            table[i, min(case["pc"], TABLE_W - 1)] = case["row"]
        for depth, (value, tid) in enumerate(zip(case["stack"], case["tids"])):
            stack[i, depth] = u256.from_int(value)
            tids[i, depth] = tid
    pc = np.asarray([c["pc"] for c in CASES], np.int32)
    sp = np.asarray([len(c["stack"]) for c in CASES], np.int32)
    status = np.asarray([c.get("status", 0) for c in CASES], np.int32)
    gas_min = np.asarray([c.get("gas_min", 0) for c in CASES], np.uint32)
    budget = np.asarray([c.get("gas_budget", 8_000_000) for c in CASES], np.uint32)
    fields = fields._replace(pc=pc, sp=sp, stack=stack, status=status, gas_min=gas_min,
                             gas_max=gas_min.copy(), gas_budget=budget)
    return [c["name"] for c in CASES], fields, ops, length, table, tids


#: the ALU family (the block substeps' arithmetic), by name
ALU_NAMES = ("ADD", "MUL", "SUB", "SIGNEXTEND", "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
             "AND", "OR", "XOR", "NOT", "BYTE", "SHL", "SHR", "SAR")
SWEEP_SUBJECTS = ALU_NAMES + ("SWAP", "DUP", "PUSH")


def _ffff_runs():
    """Words whose limbs are 0xFFFF from one limb to another: a carry or
    borrow runs across all of them."""
    return [(((1 << (16 * k)) - 1) << (16 * lo)) & M256
            for k in (1, 2, 8, 15, 16) for lo in (0, 1, 16 - k)]


EDGE_WORDS = [0, 1, 2, 1 << 255, M256, NEG(1) ^ 1, (1 << 128) - 1, 1 << 128, (1 << 128) + 1,
              (1 << 255) - 1, 0xFFFF, 0x10000, 0x8000, 0x80] + _ffff_runs()
SHIFT_AMOUNTS = [0, 1, 15, 16, 17, 255, 256, 257, 1 << 16, 1 << 200]
#: the first operand's edges, by subject
FIRST_EDGES = {"SHL": SHIFT_AMOUNTS, "SHR": SHIFT_AMOUNTS, "SAR": SHIFT_AMOUNTS,
               "BYTE": [0, 1, 15, 16, 30, 31, 32, 33, 1 << 200],
               "SIGNEXTEND": [0, 1, 15, 16, 29, 30, 31, 32, 1 << 200],
               "MUL": [(1 << 128) - 1, 1 << 128, (1 << 128) + 1, 0, 1, M256]}
#: follow-up ops: lowered ones (PUSHn, DUPn, SWAPn, the ALU family, POP,
#: JUMPDEST) and a few that no table lowers but a wrong row may mark
_FOLLOW = ([B[name] for name in ALU_NAMES] + [B["POP"], B["JUMPDEST"]] * 3
           + [0x60 + k for k in range(32)] + [0x80 + k for k in range(16)] * 2
           + [0x90 + k for k in range(16)] * 2 + [B["SSTORE"], B["MLOAD"], B["ADDRESS"]])


def _word_limbs(words):
    return np.stack([u256.from_int(w) for w in words]).astype(np.uint32)


def _random_words(rng, shape):
    """Random words as [*shape, 16] limbs: their high limbs cut at a
    random length, a fifth of them edge words."""
    limbs = rng.integers(0, 1 << 16, (*shape, 16), dtype=np.uint32)
    keep = rng.integers(0, 17, shape)
    limbs[np.arange(16) >= keep[..., None]] = 0
    edges = _word_limbs(EDGE_WORDS)
    pick = rng.random(shape) < 0.2
    limbs[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    return limbs


def _pick(rng, values):
    return values[int(rng.integers(0, len(values)))]


def sweep_state(n, seed=0, subjects=SWEEP_SUBJECTS):
    """`n` seeded lanes, lane i starting on subjects[i % len(subjects)];
    the tuple `substep_state` returns (see the module docstring)."""
    rng = np.random.default_rng(seed)
    fields = make_batch_numpy(n, code_ids=list(range(n)), calldata=[b""] * n,
                              stack_cap=STACK_CAP, mem_cap=32, storage_cap=4)
    ops = np.zeros((n, CODE_CAP + 33), np.uint8)
    length = np.full((n,), CODE_CAP, np.int32)
    table = rng.choice(np.array([0, 1, 2, 3], np.uint8), (n, TABLE_W),
                       p=[0.05, 0.5, 0.3, 0.15])
    stack = _random_words(rng, (n, STACK_CAP))
    tids = np.where(rng.random((n, STACK_CAP)) < 0.75, 0,
                    rng.integers(-1, 500, (n, STACK_CAP))).astype(np.int32)
    pc = np.zeros((n,), np.int32)
    sp = np.zeros((n,), np.int32)
    gas_min = np.zeros((n,), np.uint32)
    budget = np.full((n,), 8_000_000, np.uint32)
    status = np.where(rng.random(n) < 0.05, 1, 0).astype(np.int32)
    names = []
    ends = list(range(TABLE_W - 3, TABLE_W + 2)) + list(range(CODE_CAP - 34, CODE_CAP))
    for i in range(n):
        subject = subjects[i % len(subjects)]
        if subject == "PUSH":
            k = int(rng.integers(1, 33))
            first, need, name = 0x5F + k, 0, f"PUSH{k}"
        elif subject in ("DUP", "SWAP"):
            k = int(rng.integers(1, 17))
            first = (0x7F if subject == "DUP" else 0x8F) + k
            need, name = k + (subject == "SWAP"), f"{subject}{k}"
        else:
            first, need, name = B[subject], 1 if subject in ("ISZERO", "NOT") else 2, subject
        names.append(name)
        start = _pick(rng, ends) if rng.random() < 0.3 else int(rng.integers(0, CODE_CAP - 8))
        code = [first] + [int(x) for x in rng.integers(0, 256, 32)] * (0x60 <= first <= 0x7F)
        code = code[:1 + max(0, first - 0x5F)] if 0x60 <= first <= 0x7F else code
        while start + len(code) < CODE_CAP:
            op = _pick(rng, _FOLLOW)
            code += [op] + [int(x) for x in rng.integers(0, 256, max(0, op - 0x5F))] * (
                0x60 <= op <= 0x7F)
        code = code[:CODE_CAP - start]
        ops[i, start:start + len(code)] = code
        if rng.random() < 0.1:
            length[i] = int(rng.integers(start, CODE_CAP + 1))
        pc[i] = start
        # the subject's own row: a fusible op mostly ROW_FUSE, so both
        # modes start on it; an ALU op sometimes ROW_FUSE too, which a
        # fused substep runs as an op that writes nothing
        fusible = first >= 0x60
        table[i, min(start, TABLE_W - 1)] = _pick(
            rng, [1, 1, 1, 2, 3] if fusible else [1, 2, 2, 3, 3])
        sp[i] = _pick(rng, [0, STACK_CAP, STACK_CAP - 1, max(need - 1, 0), need, need,
                            int(rng.integers(need, STACK_CAP + 1)),
                            int(rng.integers(need, STACK_CAP + 1))])
        if subject in ALU_NAMES and sp[i] >= need:
            top = sp[i] - 1
            edges = FIRST_EDGES.get(subject, EDGE_WORDS)
            if rng.random() < 0.6:
                stack[i, top] = u256.from_int(_pick(rng, edges))
            if need == 2 and rng.random() < 0.6:
                stack[i, top - 1] = u256.from_int(_pick(rng, EDGE_WORDS + edges))
            if rng.random() < 0.8:
                tids[i, max(top - 1, 0):top + 1] = 0
        roll = rng.random()
        if roll < 0.1:  # the budget runs out within the launch
            gas_min[i] = budget[i] - int(rng.integers(0, 12))
        elif roll < 0.13:  # the gas sum wraps mod 2**32
            gas_min[i] = (1 << 32) - int(rng.integers(1, 8))
    fields = fields._replace(pc=pc, sp=sp, stack=stack, status=status, gas_min=gas_min,
                             gas_max=gas_min.copy(), gas_budget=budget)
    return names, fields, ops, length, table, tids
