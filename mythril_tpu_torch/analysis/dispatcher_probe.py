"""Dispatcher probe: batched concrete triage of a contract's entry
points (the port's copy of the JAX package's analysis/dispatcher_probe.py,
on the card).

One lane per recovered function selector (plus fuzz lanes), all
executed concretely in a single batched device pass. Per function the
probe reports halt status, storage writes, gas bounds and instruction
coverage (from the engine's executed-pc bitmap) — a fast first look at
a contract's surface before symbolic analysis, and the batch engine's
counterpart of the coverage plugin (SURVEY.md §2.4: pruners/coverage
as batch-lane masks).

The batch runs on `device` (None: the card, which must be there; "cpu"
runs the kernels' plain versions), so on the card every step's stack,
storage, journal and coverage writes launch `slot_write` and a SHA3
launches `keccak_sponge`. The rows are the JAX package's for the same
arguments.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.batch.run import run
from mythril_tpu_torch.laser.batch.state import Status, make_batch, make_code_table
from mythril_tpu_torch.ops import u256

_STATUS_NAMES = {
    Status.RUNNING: "running",
    Status.STOPPED: "stopped",
    Status.RETURNED: "returned",
    Status.REVERTED: "reverted",
    Status.INVALID: "invalid",
    Status.ERR_STACK: "stack-error",
    Status.ERR_JUMP: "jump-error",
    Status.ERR_MEM: "memory-cap",
    Status.UNSUPPORTED: "unsupported",
    Status.ERR_OOG: "out-of-gas",
}


def _coverage_percent(pc_seen_row: np.ndarray, n_instructions: int) -> float:
    if n_instructions == 0:
        return 0.0
    bits = np.unpackbits(
        pc_seen_row.view(np.uint8), bitorder="little"
    )
    return round(100.0 * int(bits.sum()) / n_instructions, 1)


def probe_dispatcher(
    code_hex: str,
    arg_words: int = 4,
    fuzz_lanes: int = 4,
    callvalue: int = 0,
    max_steps: int = 4096,
    seed: int = 1,
    device=None,
) -> List[Dict]:
    """Probe every recovered selector (plus empty-calldata and fuzz
    lanes) of runtime bytecode in one batched run on `device` (None:
    the card)."""
    disassembly = Disassembly(code_hex)
    code = bytes.fromhex(code_hex[2:] if code_hex.startswith("0x") else code_hex)
    rng = np.random.default_rng(seed)

    lanes: List[Dict] = []
    for func_hash in disassembly.func_hashes:
        selector = bytes.fromhex(func_hash[2:])
        try:
            from mythril_tpu_torch.support.signatures import SignatureDB

            sigs = SignatureDB().get(func_hash)
            label = sigs[0] if sigs else func_hash
        except Exception:
            label = func_hash
        calldata = selector + rng.integers(
            0, 256, arg_words * 32, dtype=np.uint8
        ).tobytes()
        lanes.append({"label": label, "calldata": calldata})
    lanes.append({"label": "<empty calldata>", "calldata": b""})
    for k in range(fuzz_lanes):
        calldata = rng.integers(0, 256, 4 + arg_words * 32, dtype=np.uint8).tobytes()
        lanes.append({"label": f"<fuzz {k}>", "calldata": calldata})

    table = make_code_table([code], device=device)
    batch = make_batch(
        len(lanes),
        calldata=[lane["calldata"] for lane in lanes],
        callvalue=callvalue,
        device=device,
    )
    out, steps = run(batch, table, max_steps=max_steps)

    # one read of each field (gas is int64 holding the uint32 bound)
    status, gas_min, gas_max, cnts, keys, vals, pc_seen = (
        t.cpu().numpy()
        for t in (out.status, out.gas_min, out.gas_max, out.storage_cnt,
                  out.storage_keys, out.storage_vals, out.pc_seen)
    )
    n_instr = len(disassembly.instruction_list)

    results = []
    for i, lane in enumerate(lanes):
        writes = {}
        for k in range(int(cnts[i])):
            writes[hex(u256.to_int(keys[i, k]))] = hex(u256.to_int(vals[i, k]))
        results.append(
            {
                "function": lane["label"],
                "status": _STATUS_NAMES.get(int(status[i]), str(int(status[i]))),
                "gas": [int(gas_min[i]) & 0xFFFFFFFF, int(gas_max[i]) & 0xFFFFFFFF],
                "storage_writes": writes,
                "coverage_percent": _coverage_percent(pc_seen[i], n_instr),
            }
        )
    return results
