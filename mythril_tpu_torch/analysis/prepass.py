"""Device-prepass witnesses -> concrete Issues.

The port's copy of the JAX package's analysis/prepass.py, without
`device_already_proved` (the host detection modules read it; they are
not ported). The one change: a fault in evidence synthesis propagates
instead of being logged and dropped, so an issue set is never quietly
smaller than the evidence.

The device symbolic explorer (laser/batch/explore.py) banks the halt
pc + the concrete calldata of every lane that died on an ASSERT_FAIL.
Those witnesses ARE proofs: replaying the banked calldata from a fresh
state reaches the faulting instruction deterministically, so the
analysis layer emits the issue directly — witness as the transaction
sequence — instead of having the host engine re-derive the same assert
through a solver walk.

Reference anchors: the issue flow this short-circuits is
mythril/analysis/solver.py:47-242 (`get_transaction_sequence`) feeding
mythril/analysis/module/modules/exceptions.py (SWC-110). The issue
text matches the host Exceptions module so the Report fingerprint
(contract+address+title) dedups the two paths cleanly.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from mythril_tpu_torch.analysis.module.remediation import (
    EXCEPTIONS_REMEDIATION as REMEDIATION,
)
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import (
    ASSERT_VIOLATION,
    UNPROTECTED_SELFDESTRUCT,
)
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS

log = logging.getLogger(__name__)

ASSERT_FAIL_BYTE = 0xFE

#: (runtime_hex, address, swc_id) triples the device already holds a
#: concrete witness for: the host detection modules (not ported) skip
#: their own witness-concretization solve there. Keyed by bytecode so
#: creation-code pcs and dynloaded foreign contracts never collide with
#: the analyzed runtime's pc space.
_PROVEN: set = set()


def _norm_code(code_hex: str) -> str:
    code_hex = code_hex or ""
    return code_hex[2:] if code_hex.startswith("0x") else code_hex


def reset_proven() -> None:
    _PROVEN.clear()


def register_proven(issues, code_hex: str) -> None:
    code_hex = _norm_code(code_hex)
    for issue in issues:
        _PROVEN.add((code_hex, issue.address, issue.swc_id))


#: the gas limit the jsonv2 replay context claims (report.py
#: REPLAY_BLOCK_CONTEXT gasLimit); witnesses that need more gas than
#: this would not replay, so they are not reported
REPLAY_GAS_LIMIT = 0x7D000


def _function_name(contract, calldata: bytes) -> str:
    """Resolve the witness's entry function from its selector."""
    if len(calldata) < 4:
        return "fallback"
    selector = "0x" + calldata[:4].hex()
    disassembly = getattr(contract, "disassembly", None)
    table = getattr(disassembly, "function_hash_to_name", None) or {}
    if selector in table:
        return table[selector]
    if selector in getattr(disassembly, "func_hashes", []):
        return "_function_" + selector
    return "fallback"


def _witness_sequence(
    contract_address: int,
    transactions: List[bytes],
    runtime_hex: str,
    initial_storage: Dict = None,
    values: List[int] = None,
    initial_balance: int = 0,
) -> Dict:
    """A replayable transaction sequence in the shape
    `get_transaction_sequence` produces (analysis/solver.py): one step
    per attacker transaction, the last one the triggering call.
    `initial_storage` declares a poisoned-carry witness's synthetic
    start state (the concolic form of the reference's symbolic initial
    storage) so the claim is honest about what it assumes."""
    import json

    attacker = "0x" + ("%x" % ACTORS.attacker.value).zfill(40)
    target = hex(contract_address)
    return {
        "initialState": {
            "accounts": {
                target: {
                    "nonce": 0,
                    "code": runtime_hex,
                    "storage": (
                        json.dumps(initial_storage, sort_keys=True)
                        if initial_storage
                        else "{}"
                    ),
                    "balance": hex(initial_balance or 0),
                },
                attacker: {
                    "nonce": 0,
                    "code": "",
                    "storage": "{}",
                    "balance": "0x0",
                },
            }
        },
        "steps": [
            {
                "input": "0x" + step.hex(),
                "value": (
                    hex(values[i]) if values and i < len(values) else "0x0"
                ),
                "origin": attacker,
                "address": target,
                "calldata": "0x" + step.hex(),
            }
            for i, step in enumerate(transactions)
        ],
    }


KILL_REMEDIATION = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to "
    "destroy this contract account. Review the transaction trace generated "
    "for this issue and make sure that appropriate security controls are in "
    "place to prevent unrestricted access."
)


def _issue_from_record(
    contract, record: Dict, address: int, runtime_hex: str, kind: str
) -> Issue:
    calldata = bytes.fromhex(record["input"])
    prefix = [bytes.fromhex(p) for p in record.get("prefix", [])]
    if kind == "selfdestruct":
        swc_id, title, severity = (
            UNPROTECTED_SELFDESTRUCT,
            "Unprotected Selfdestruct",
            "High",
        )
        head = "Any sender can cause the contract to self-destruct."
        tail = KILL_REMEDIATION
    else:
        swc_id, title, severity = ASSERT_VIOLATION, "Exception State", "Medium"
        head = "An assertion violation was triggered."
        tail = REMEDIATION
    issue = Issue(
        contract=contract.name,
        function_name=_function_name(contract, calldata),
        address=record["pc"],
        swc_id=swc_id,
        title=title,
        bytecode=runtime_hex,
        gas_used=(record.get("gas_min"), record.get("gas_max")),
        severity=severity,
        description_head=head,
        description_tail=tail,
        transaction_sequence=_witness_sequence(
            address,
            prefix + [calldata],
            runtime_hex,
            initial_storage=record.get("initial_storage"),
            values=(
                list(record.get("prefix_values") or [])
                + [record.get("call_value", 0)]
            ),
            initial_balance=record.get("initial_balance", 0),
        ),
    )
    issue.provenance = "device-prepass"
    return issue


def witness_issues(contract, outcome: Dict, address: int) -> List[Issue]:
    """Concrete Issues carried by the prepass outcome's trigger bank.

    - assert-violation lanes whose faulting byte is the designated
      INVALID opcode (0xfe) -> SWC-110 "Exception State". Lanes that
      died on merely-undefined opcodes are execution errors, not
      assertions, exactly as in the host engine's ASSERT_FAIL hook.
    - selfdestruct lanes -> SWC-106 "Unprotected Selfdestruct": the
      lane IS an attacker-sent call chain that executed SELFDESTRUCT.
    """
    triggers = (outcome or {}).get("triggers") or {}
    runtime_hex = getattr(contract, "code", "") or ""
    if runtime_hex.startswith("0x"):
        runtime_hex = runtime_hex[2:]
    code = bytes.fromhex(runtime_hex)

    issues: List[Issue] = []
    for kind in ("assert-violation", "selfdestruct"):
        for record in triggers.get(kind) or []:
            pc = record["pc"]
            if kind == "assert-violation" and not (
                0 <= pc < len(code) and code[pc] == ASSERT_FAIL_BYTE
            ):
                continue
            if (record.get("gas_min") or 0) > REPLAY_GAS_LIMIT:
                continue  # the claimed replay gas limit could not reach it
            issue = _issue_from_record(contract, record, address, runtime_hex, kind)
            issues.append(issue)
            log.info(
                "Device prepass witnessed SWC-%s at pc %d (%s)",
                issue.swc_id,
                pc,
                issue.function,
            )
    # the round-5 evidence classes (wraps, calls, env branches) ride
    # the same outcome; synthesis lives in analysis/evidence.py
    from mythril_tpu_torch.analysis.evidence import evidence_issues

    issues.extend(evidence_issues(contract, outcome, address))
    return issues
