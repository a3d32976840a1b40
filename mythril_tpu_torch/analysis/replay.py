"""Concrete replay of an issue's transaction sequence.

A device witness claims that its transaction sequence, sent by the
attacker from the initial state it declares, reaches the issue's pc.
`replay_sequence` checks the claim with the port's concrete interpreter
(laser/batch/run.py): one lane, the steps in order, each step's storage
journal carried into the next, under the explorer's block context
(explore.py REPLAY_ENV) and the gas limit the report's replay context
claims (prepass.REPLAY_GAS_LIMIT).

The replay runs at the prepass's roomiest per-lane caps
(corpus.ROOMY_CAPS), whichever geometry produced the witness. That is
sound for a lean-cap witness too: a cap changes an execution only once
it is exceeded, and a lane that exceeds its cap faults there, so a lane
that reached its trigger stayed inside its caps and runs the same under
larger ones.
"""

from __future__ import annotations

import json
from typing import Dict

from mythril_tpu_torch.analysis.corpus import ROOMY_CAPS
from mythril_tpu_torch.analysis.prepass import REPLAY_GAS_LIMIT
from mythril_tpu_torch.laser.batch.explore import REPLAY_ENV
from mythril_tpu_torch.laser.batch.state import (
    CALLDATA_CAP,
    Status,
    make_batch,
    make_code_table,
    storage_dict,
)
from mythril_tpu_torch.laser.batch.run import run
from mythril_tpu_torch.support.accel import resolve_device

_STATUS_NAMES = {v: k for k, v in vars(Status).items() if isinstance(v, int)}


def _seen(batch, pc: int) -> bool:
    word = int(batch.pc_seen[0, pc // 32]) & 0xFFFFFFFF
    return bool((word >> (pc % 32)) & 1)


def replay_sequence(
    tx_sequence: Dict, pc: int, max_steps: int = 4096, device=None
) -> Dict:
    """Replay `tx_sequence` (an issue's `tx_sequence`) on one lane on
    `device` (None: the card) and report, for its last step, whether it
    reached `pc` (`reached`), the lane's final status and pc, and whether
    every earlier step ended in a successful halt (`prefix_ok`: a
    reverted step banks no state)."""
    device = resolve_device(device)
    (target, account), *_ = (
        (k, v)
        for k, v in tx_sequence["initialState"]["accounts"].items()
        if v["code"]
    )
    code = bytes.fromhex(account["code"])
    storage = {
        int(k, 16) if isinstance(k, str) else int(k):
        int(v, 16) if isinstance(v, str) else int(v)
        for k, v in json.loads(account["storage"] or "{}").items()
    }
    env = dict(REPLAY_ENV, balance=int(account["balance"], 16))
    table = make_code_table([code], device=device)
    prefix_ok = True
    steps = tx_sequence["steps"]
    for i, step in enumerate(steps):
        calldata = bytes.fromhex(step["input"][2:])
        batch = make_batch(
            1,
            calldata=[calldata],
            callvalue=int(step["value"], 16),
            caller=int(step["origin"], 16),
            address=int(target, 16),
            gas_budget=REPLAY_GAS_LIMIT,
            mem_cap=ROOMY_CAPS[0],
            storage_cap=ROOMY_CAPS[1],
            calldata_cap=max(CALLDATA_CAP, len(calldata)),
            storage_seed=[storage],
            device=device,
            **env,
        )
        out, _ = run(batch, table, max_steps=max_steps)
        status = int(out.status[0])
        if i < len(steps) - 1:
            prefix_ok &= status in (Status.STOPPED, Status.RETURNED)
            storage = storage_dict(out, 0)
    halt_pc = int(out.pc[0])
    return {
        # a lane that faults at `pc` halts there without marking it
        "reached": _seen(out, pc) or (status != Status.RUNNING and halt_pc == pc),
        "status": _STATUS_NAMES.get(status, str(status)),
        "pc": halt_pc,
        "prefix_ok": prefix_ok,
    }


def replays_to(issue: Dict, device=None) -> bool:
    """True when the issue's (`as_dict`) transaction sequence replays to
    its address: every earlier step halts successfully, the last one
    executes the issue's pc, and an SWC-106 or SWC-110 issue's last step
    halts there with SELFDESTRUCT or the designated invalid opcode."""
    got = replay_sequence(issue["tx_sequence"], issue["address"], device=device)
    halt = {"106": "KILLED", "110": "INVALID"}.get(issue["swc-id"])
    if halt is not None and (got["status"], got["pc"]) != (halt, issue["address"]):
        return False
    return got["reached"] and got["prefix_ok"]
