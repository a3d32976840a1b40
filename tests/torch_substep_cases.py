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
