"""Hybrid concolic fuzzing: device-scale execution + solver-driven
input generation.

The division of labor is the north-star split (SURVEY.md §7.1): the
batched engine executes whole generations of concrete inputs in
one device pass and journals every JUMPI decision per lane; the host
then picks branch directions no input has taken yet, replays the
journaled path prefix *symbolically* through the LASER instruction
semantics (collecting the path condition), asserts the flipped branch,
and asks the solver for calldata that takes it. Each generation's
witnesses become the next generation's lanes — a SAGE-style whitebox
loop where the expensive part (execution) runs wide on the card and the
clever part (constraint flipping) runs narrow on the host.

Scope (v1): single contract, intra-contract paths (replay stops at
CALL/CREATE frames).

This is the port's copy of the JAX package's analysis/hybrid_fuzz.py.
Generations run on `device` (None: the card, which must be there; "cpu"
runs the kernels' plain versions): on the card each generation's steps
launch `slot_write` for their stack, storage, journal and coverage
writes and `keccak_sponge` for SHA3. The flip's `get_model` names the
same device, so a query the CDCL sprint leaves open races there. The
command line is tools/fuzz.py's, with `--device`:

    python -m mythril_tpu_torch.analysis.hybrid_fuzz -c HEX [--device cpu]
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional, Set, Tuple

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.batch.run import run as batch_run
from mythril_tpu_torch.laser.batch.state import BRANCH_CAP, Status, make_batch, make_code_table
from mythril_tpu_torch.laser.ethereum.evm_exceptions import VmException
from mythril_tpu_torch.laser.ethereum.instructions import Instruction
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    get_next_transaction_id,
)
from mythril_tpu_torch.laser.smt import symbol_factory
from mythril_tpu_torch.laser.batch.explore import (
    DEFAULT_ADDRESS as ADDRESS,
    DEFAULT_CALLER as CALLER,
    TRIGGER_KINDS,
)
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class _ReplayAbort(Exception):
    """Path replay left the supported scope (calls, script mismatch)."""


def _symbolic_replay(
    disassembly: Disassembly,
    calldata_len: int,
    script: List[Tuple[int, bool]],
    device=None,
) -> Optional[List[int]]:
    """Follow `script` = [(jumpi_pc, taken), ...] symbolically, flip the
    LAST entry, and solve for calldata taking the flipped direction
    (`get_model` on `device`, None: the card). Returns concrete calldata
    bytes or None."""
    world_state = WorldState()
    account = Account(ADDRESS, concrete_storage=True)
    account.code = disassembly
    world_state.put_account(account)
    account.set_balance(10**18)

    tx_id = get_next_transaction_id()
    calldata = SymbolicCalldata(tx_id)
    transaction = MessageCallTransaction(
        world_state=world_state,
        identifier=tx_id,
        gas_price=10,
        gas_limit=8_000_000,
        origin=symbol_factory.BitVecVal(CALLER, 256),
        caller=symbol_factory.BitVecVal(CALLER, 256),
        callee_account=world_state[symbol_factory.BitVecVal(ADDRESS, 256)],
        call_data=calldata,
        call_value=0,
    )
    state = transaction.initial_global_state()
    state.transaction_stack.append((transaction, None))
    state.world_state.constraints.append(
        calldata.calldatasize == calldata_len
    )

    time_handler.start_execution(10)
    script = list(script)
    flip_index = len(script) - 1
    seen_branches = 0
    steps = 0

    while True:
        steps += 1
        if steps > 4096:
            raise _ReplayAbort("step budget")
        try:
            instr = state.get_current_instruction()
        except IndexError:
            raise _ReplayAbort("walked off code before target")
        op = instr["opcode"]
        # peek the condition before evaluate pops it: a concrete value
        # disambiguates single survivors whose jump target is pc + 1
        pre_cond_value = None
        if op == "JUMPI" and len(state.mstate.stack) >= 2:
            pre_cond_value = getattr(state.mstate.stack[-2], "value", None)
        try:
            successors = Instruction(op, None).evaluate(state)
        except TransactionStartSignal:
            raise _ReplayAbort("nested call in path")
        except TransactionEndSignal:
            raise _ReplayAbort("halted before target")
        except VmException as e:
            # e.g. a symbolic jump dest the concrete run resolved fine;
            # skip this flip, keep the fuzzing run alive
            raise _ReplayAbort(f"vm exception in replay: {e}")

        if op == "JUMPI":
            if seen_branches >= len(script):
                raise _ReplayAbort("extra branch past script")
            want_taken = script[seen_branches][1]
            if seen_branches == flip_index:
                want_taken = not want_taken
            # identify successors. jumpi_ appends fall-through first and
            # taken second, so a 2-successor result is unambiguous even
            # when the jump target IS the next instruction (pc + 1); only
            # then fall back to the pc comparison for single survivors.
            if len(successors) == 2:
                fallthrough, taken = successors
            else:
                fallthrough = taken = None
                s = successors[0] if successors else None
                if s is None:
                    pass
                elif s.mstate.pc != state.mstate.pc + 1:
                    taken = s
                elif pre_cond_value is not None:
                    # target == pc + 1 with a concrete condition: jumpi_
                    # kept exactly the branch the condition selects
                    if pre_cond_value != 0:
                        taken = s
                    else:
                        fallthrough = s
                else:
                    # symbolic condition with one survivor at pc + 1 can
                    # only be the fall-through (the taken twin would have
                    # survived too if the target were a JUMPDEST)
                    fallthrough = s
            chosen = taken if want_taken else fallthrough
            if chosen is None:
                # the wanted direction is infeasible (engine pruned it)
                return None
            if seen_branches == flip_index:
                # constraints of `chosen` include the flipped condition
                try:
                    model = get_model(
                        tuple(chosen.world_state.constraints),
                        enforce_execution_time=False,
                        solver_timeout=4000,
                        device=device,
                    )
                except UnsatError:
                    return None
                data = calldata.concrete(model)
                return [int(b) for b in data[:calldata_len]] + [0] * max(
                    0, calldata_len - len(data)
                )
            seen_branches += 1
            state = chosen
        else:
            if not successors:
                raise _ReplayAbort("dead end")
            state = successors[0]


class HybridFuzzer:
    """Generation loop: device executes, host flips branches."""

    def __init__(
        self,
        code_hex: str,
        calldata_len: int = 68,
        lanes_per_generation: int = 32,
        max_generations: int = 6,
        flips_per_generation: int = 8,
        seed: int = 1,
        device=None,
    ):
        self.code_hex = code_hex[2:] if code_hex.startswith("0x") else code_hex
        self.code = bytes.fromhex(self.code_hex)
        self.calldata_len = calldata_len
        self.lanes_per_generation = lanes_per_generation
        self.max_generations = max_generations
        self.flips_per_generation = flips_per_generation
        self.rng = random.Random(seed)
        self.device = device
        # parsed once: replay and seeding share the same objects
        self.disassembly = Disassembly(self.code_hex)
        self.code_table = make_code_table([self.code], device=device)
        self.covered: Set[Tuple[int, bool]] = set()
        self.attempted: Set[Tuple[int, bool]] = set()
        self.corpus: List[bytes] = []
        self.storage_writes: Dict[int, Set[int]] = {}
        # concrete trigger inputs per terminal failure kind: a lane that
        # halts INVALID is a ready-made assert-violation witness
        self.triggers: Dict[str, List[bytes]] = {}

    def _seed_inputs(self) -> List[bytes]:
        inputs = [b"\x00" * self.calldata_len]
        for func_hash in self.disassembly.func_hashes:
            selector = bytes.fromhex(func_hash[2:])
            inputs.append(
                selector
                + bytes(
                    self.rng.randrange(256)
                    for _ in range(self.calldata_len - 4)
                )
            )
        while len(inputs) < self.lanes_per_generation:
            inputs.append(
                bytes(self.rng.randrange(256) for _ in range(self.calldata_len))
            )
        return inputs[: self.lanes_per_generation]

    def _run_generation(self, inputs: List[bytes]) -> List[Dict]:
        table = self.code_table
        batch = make_batch(
            len(inputs), calldata=inputs, caller=CALLER, address=ADDRESS,
            device=self.device,
        )
        out, _ = batch_run(batch, table, max_steps=4096)
        # one read of each field the host needs
        status_arr, br_pc, br_taken, br_cnt, keys, vals, cnts = (
            t.cpu().numpy()
            for t in (out.status, out.br_pc, out.br_taken, out.br_cnt,
                      out.storage_keys, out.storage_vals, out.storage_cnt)
        )

        lanes = []
        from mythril_tpu_torch.ops import u256

        for i, data in enumerate(inputs):
            kind = TRIGGER_KINDS.get(int(status_arr[i]))
            if kind is not None:
                bucket = self.triggers.setdefault(kind, [])
                if data not in bucket and len(bucket) < 16:
                    bucket.append(data)
            journal = [
                (int(br_pc[i, j]), bool(br_taken[i, j]))
                for j in range(min(int(br_cnt[i]), BRANCH_CAP))
            ]
            for entry in journal:
                self.covered.add(entry)
            for k in range(int(cnts[i])):
                slot = u256.to_int(keys[i, k])
                self.storage_writes.setdefault(slot, set()).add(
                    u256.to_int(vals[i, k])
                )
            lanes.append({"calldata": data, "journal": journal})
        return lanes

    def run(self) -> Dict:
        inputs = self._seed_inputs()
        generations = 0
        for gen in range(self.max_generations):
            generations += 1
            lanes = self._run_generation(inputs)
            self.corpus.extend(lane["calldata"] for lane in lanes)

            # frontier: first uncovered flipped direction per lane
            new_inputs: List[bytes] = []
            for lane in lanes:
                if len(new_inputs) >= self.flips_per_generation:
                    break
                journal = lane["journal"]
                for i, (pc, taken) in enumerate(journal):
                    target = (pc, not taken)
                    if target in self.covered or target in self.attempted:
                        continue
                    self.attempted.add(target)
                    try:
                        data = _symbolic_replay(
                            self.disassembly,
                            self.calldata_len,
                            journal[: i + 1],
                            device=self.device,
                        )
                    except _ReplayAbort as e:
                        log.debug("replay abort at %s: %s", target, e)
                        continue
                    if data is not None:
                        new_inputs.append(bytes(data))
                        break
            if not new_inputs:
                break
            # pad the next generation with corpus mutations
            while len(new_inputs) < self.lanes_per_generation:
                parent = self.rng.choice(self.corpus)
                mutated = bytearray(parent)
                mutated[self.rng.randrange(len(mutated))] = self.rng.randrange(256)
                new_inputs.append(bytes(mutated))
            inputs = new_inputs[: self.lanes_per_generation]

        return {
            "generations": generations,
            "covered_branches": sorted(self.covered),
            "corpus_size": len(self.corpus),
            "storage_writes": {
                hex(k): sorted(hex(v) for v in vs)
                for k, vs in self.storage_writes.items()
            },
            "triggers": {
                kind: [data.hex() for data in bucket]
                for kind, bucket in self.triggers.items()
            },
        }


def main(argv=None) -> int:
    """tools/fuzz.py's command line, plus `--device` (default: the card):
    prints one JSON report (covered branch directions, storage write
    observations, concrete trigger inputs)."""
    import argparse
    import json
    from pathlib import Path

    parser = argparse.ArgumentParser(description="hybrid concolic fuzzer")
    parser.add_argument("-c", "--code", help="hex runtime bytecode")
    parser.add_argument("-f", "--codefile", help="file with hex runtime bytecode")
    parser.add_argument("--calldata-len", type=int, default=68)
    parser.add_argument("--lanes", type=int, default=32)
    parser.add_argument("--generations", type=int, default=6)
    parser.add_argument("--flips", type=int, default=8)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default=None,
        help="where the generations run (default: the card)",
    )
    parser.add_argument("-v", action="store_true", help="verbose logging")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.v else logging.CRITICAL)
    if args.code:
        code = args.code
    elif args.codefile:
        code = Path(args.codefile).read_text().strip()
    else:
        parser.error("provide -c CODE or -f FILE")

    fuzzer = HybridFuzzer(
        code,
        calldata_len=args.calldata_len,
        lanes_per_generation=args.lanes,
        max_generations=args.generations,
        flips_per_generation=args.flips,
        seed=args.seed,
        device=args.device,
    )
    print(json.dumps(fuzzer.run(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
