"""CFG recovery over raw runtime bytecode.

The port's copy of the JAX package's analysis/static/cfg.py, with the
package renamed.

Basic-block formation from the disassembler's instruction list plus
the peephole (PUSH-const directly before JUMP/JUMPI) jump-target
resolution. Computed jumps the peephole cannot see are resolved by
the dataflow pass (`dataflow.py`) where the target is a stack
constant.

The linear sweep IS the canonical instruction alignment for the EVM:
JUMPDEST validity is defined by the same sweep (a 0x5b byte inside
PUSH data is not a valid destination), so blocks recovered here match
what both the host engine and the batched device interpreter will
execute.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.support.opcodes import OPCODES

#: opcodes after which control never falls through
TERMINATORS = frozenset(
    ["STOP", "RETURN", "REVERT", "ASSERT_FAIL", "SUICIDE", "JUMP", "INVALID"]
)


class BasicBlock:
    """One basic block: a maximal straight-line instruction run."""

    __slots__ = ("start", "instructions", "is_jumpdest")

    def __init__(self, start: int, instructions: List[asm.EvmInstruction]):
        self.start = start
        self.instructions = instructions
        self.is_jumpdest = bool(
            instructions and instructions[0].opcode == "JUMPDEST"
        )

    @property
    def terminator(self) -> str:
        """Opcode ending the block, or "FALL" when the block ends only
        because the next instruction starts a new leader."""
        last = self.instructions[-1].opcode if self.instructions else "FALL"
        if last in TERMINATORS or last == "JUMPI":
            return last
        return "FALL"

    @property
    def end(self) -> int:
        """Address of the last instruction."""
        return self.instructions[-1].address if self.instructions else self.start

    def __len__(self) -> int:
        return len(self.instructions)

    def __repr__(self) -> str:
        return (
            f"<BasicBlock {self.start}..{self.end} "
            f"n={len(self.instructions)} end={self.terminator}>"
        )


class CFG:
    """Recovered control-flow graph: blocks keyed by start pc."""

    def __init__(
        self,
        instructions: List[asm.EvmInstruction],
        blocks: Dict[int, BasicBlock],
        jumpdests: frozenset,
    ) -> None:
        self.instructions = instructions
        self.blocks = blocks
        self.jumpdests = jumpdests
        self.starts = sorted(blocks)
        #: peephole-resolved jump targets, {jump_pc: target_pc}
        self.peephole_targets: Dict[int, int] = {}
        self._resolve_peephole()

    def block_after(self, start: int) -> Optional[BasicBlock]:
        """The fall-through successor block of the block at `start`."""
        import bisect

        i = bisect.bisect_right(self.starts, start)
        if i < len(self.starts):
            return self.blocks[self.starts[i]]
        return None

    def _resolve_peephole(self) -> None:
        for block in self.blocks.values():
            if block.terminator not in ("JUMP", "JUMPI"):
                continue
            if len(block.instructions) < 2:
                continue
            prev = block.instructions[-2]
            if prev.opcode.startswith("PUSH") and prev.argument:
                self.peephole_targets[block.end] = int(prev.argument, 16)

    def static_successors(self, block: BasicBlock) -> List[int]:
        """Successor block starts known WITHOUT dataflow: fall-through
        plus peephole-resolved jump targets that land on a JUMPDEST."""
        out: List[int] = []
        terminator = block.terminator
        if terminator in ("JUMP", "JUMPI"):
            target = self.peephole_targets.get(block.end)
            if target is not None and target in self.jumpdests:
                out.append(target)
        if terminator in ("FALL", "JUMPI"):
            nxt = self.block_after(block.start)
            if nxt is not None:
                out.append(nxt.start)
        return out


def recover_cfg(code: bytes) -> CFG:
    """Bytecode -> CFG: disassemble (trailing solc metadata stripped,
    truncated trailing PUSH zero-padded per EVM semantics — see
    asm.disassemble) and split at leaders."""
    instructions = asm.disassemble(code)
    jumpdests = frozenset(
        ins.address for ins in instructions if ins.opcode == "JUMPDEST"
    )
    leaders = {0}
    for i, ins in enumerate(instructions):
        if ins.opcode == "JUMPDEST":
            leaders.add(ins.address)
        if ins.opcode in TERMINATORS or ins.opcode == "JUMPI":
            if i + 1 < len(instructions):
                leaders.add(instructions[i + 1].address)

    blocks: Dict[int, BasicBlock] = {}
    current: List[asm.EvmInstruction] = []
    start = 0
    for ins in instructions:
        if ins.address in leaders and current:
            blocks[start] = BasicBlock(start, current)
            current = []
        if not current:
            start = ins.address
        current.append(ins)
    if current:
        blocks[start] = BasicBlock(start, current)
    return CFG(instructions, blocks, jumpdests)


def stack_effect(opcode: str) -> Tuple[int, int]:
    """(pops, pushes) for an opcode; unknown opcodes (INVALID aliases)
    touch nothing."""
    row = OPCODES.get(opcode)
    if row is None:
        return 0, 0
    return row[1], row[2]
