"""Contract disassembly model.

The port's copy of the JAX package's disassembler/disassembly.py
(reference: mythril/disassembler/disassembly.py:9, `Disassembly`):
instruction list and function-selector -> entry-address maps recovered
from the dispatcher's PUSH4/EQ jump table (`function_hash_to_name` and
`func_hashes` name a witness's entry function in analysis/prepass.py),
with the dense arrays the batched interpreter consumes (opcodes +
jumpdest mask). Selectors are named from the port's sqlite
`SignatureDB`, never online; the easm view and `assign_bytecode` (the
host's create transaction) are not ported.
"""

from __future__ import annotations

from typing import Dict, List

from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.support.signatures import SignatureDB


class Disassembly:
    """Disassembly of a contract's bytecode."""

    def __init__(self, code: str):
        self.bytecode = code
        if isinstance(code, bytes):
            self.raw = code
        else:
            self.raw = asm.safe_decode(code)
        self.instruction_list: List[asm.EvmInstruction] = asm.disassemble(self.raw)
        self.func_hashes: List[str] = []
        self.function_name_to_address: Dict[str, int] = {}
        self.address_to_function_name: Dict[int, str] = {}
        self.function_hash_to_name: Dict[str, str] = {}

        # dispatcher pattern: PUSH4 <selector> ; EQ ; PUSH<n> <entry> ; JUMPI
        # (reference: disassembly.py:63 get_function_info)
        jump_table_indices = asm.find_op_code_sequence(
            [("PUSH4",), ("EQ",)], self.instruction_list
        )
        for index in jump_table_indices:
            function_hash, entry_address, function_name = get_function_info(
                index, self.instruction_list, SignatureDB()
            )
            self.func_hashes.append(function_hash)
            self.function_hash_to_name[function_hash] = function_name
            if entry_address is not None:
                self.function_name_to_address[function_name] = entry_address
                self.address_to_function_name[entry_address] = function_name

        self.opcodes, self.jumpdest_mask = asm.to_dense(self.raw)


def get_function_info(index, instruction_list, signature_database):
    """Resolve (hash, entry address, name) for one dispatcher entry."""
    function_hash = instruction_list[index].argument
    # normalize to 0x + 8 hex chars
    if isinstance(function_hash, str):
        function_hash = "0x" + function_hash[2:].rjust(8, "0")

    function_names = signature_database.get(function_hash)
    if len(function_names) > 0:
        function_name = function_names[0]
    else:
        function_name = "_function_" + function_hash

    # entry address: the next PUSH before a JUMPI within a short window
    entry_address = None
    for offset in range(2, 5):
        if index + offset >= len(instruction_list):
            break
        instr = instruction_list[index + offset]
        if instr.opcode.startswith("PUSH"):
            next_instr = (
                instruction_list[index + offset + 1]
                if index + offset + 1 < len(instruction_list)
                else None
            )
            if next_instr is not None and next_instr.opcode == "JUMPI":
                entry_address = int(instr.argument, 16)
                break
    return function_hash, entry_address, function_name
