"""Device evidence -> concrete Issues, for every detection class the
corpus exercises (round 5: the device owns detection, the host
verifies).

The port's copy of the JAX package's analysis/evidence.py. The issue
strings come from analysis/module/remediation.py, the port's copy of
the detection modules' own, so every issue reads as the JAX package's.

The explorer's evidence bank (laser/batch/explore.py
`_consume_evidence`) records only CONCRETELY exhibited facts — a lane
that actually wrapped and used the result, actually sent a
gas-forwarding call to the attacker, actually decided a branch on
tx.origin — each with the replayable calldata that did it. Synthesis
here is therefore solver-free: the banked input IS the transaction
sequence, exactly like the assert/selfdestruct witnesses in
analysis/prepass.py.

Fingerprint parity: every Issue matches the corresponding host
module's (address, swc, title) so the report dedupe collapses the two
paths and `device_already_proved` can stand in for the module's
expensive solve:

- wrap events        -> SWC-101  analysis/module/modules/integer.py
- unchecked calls    -> SWC-104  unchecked_retval.py
- value to attacker  -> SWC-105  ether_thief.py
- call to attacker   -> SWC-107  external_calls.py
- state after call   -> SWC-107  state_change_external_calls.py
- delegatecall       -> SWC-112  delegatecall.py
- origin branches    -> SWC-115  dependence_on_origin.py
- predictable-var branches -> SWC-116/120 dependence_on_predictable_vars.py

Reference anchor for the flow being short-circuited:
mythril/analysis/solver.py:47-242 (get_transaction_sequence) invoked
per candidate site by each of the modules above.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from mythril_tpu_torch.analysis.module import remediation as _text
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import (
    DELEGATECALL_TO_UNTRUSTED_CONTRACT,
    INTEGER_OVERFLOW_AND_UNDERFLOW,
    REENTRANCY,
    TX_ORIGIN_USAGE,
    UNCHECKED_RET_VAL,
    UNPROTECTED_ETHER_WITHDRAWAL,
)

log = logging.getLogger(__name__)

GAS_STIPEND = 2300


def _mk_issue(
    contract, runtime_hex: str, address: int, rec: Dict, **fields
) -> Issue:
    from mythril_tpu_torch.analysis.prepass import (
        _function_name,
        _witness_sequence,
    )

    calldata = bytes.fromhex(rec["input"])
    prefix = [bytes.fromhex(p) for p in rec.get("prefix", [])]
    issue = Issue(
        contract=contract.name,
        function_name=_function_name(contract, calldata),
        address=rec["pc"],
        bytecode=runtime_hex,
        gas_used=(rec.get("gas_min"), rec.get("gas_max")),
        transaction_sequence=_witness_sequence(
            address,
            prefix + [calldata],
            runtime_hex,
            initial_storage=rec.get("initial_storage"),
            values=(
                list(rec.get("prefix_values") or [])
                + [rec.get("call_value", 0)]
            ),
            initial_balance=rec.get("initial_balance", 0),
        ),
        **fields,
    )
    issue.provenance = "device-evidence"
    return issue


def _call_issues(contract, runtime_hex, address, rec) -> List[Issue]:
    out = []
    if rec.get("unchecked"):
        # per-property witness: the lane that PROVED the property
        # (explore.py banks w_unchecked/w_profit beside the shared
        # record), so the reported transaction_sequence replays the
        # claim even when another lane owns the record's main witness
        out.append(
            _mk_issue(
                contract,
                runtime_hex,
                address,
                {**rec, **rec.get("w_unchecked", {})},
                swc_id=UNCHECKED_RET_VAL,
                title="Unchecked return value from external call.",
                severity="Medium",
                description_head=(
                    "The return value of a message call is not checked."
                ),
                description_tail=_text.UNCHECKED_RETVAL_REMEDIATION,
            )
        )
    if rec.get("value_to_attacker"):
        out.append(
            _mk_issue(
                contract,
                runtime_hex,
                address,
                {**rec, **rec.get("w_profit", {})},
                swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
                title="Unprotected Ether Withdrawal",
                severity="High",
                description_head=(
                    "Any sender can withdraw Ether from the contract account."
                ),
                description_tail=_text.ETHER_THIEF_REMEDIATION,
            )
        )
    if rec.get("to_attacker") and rec.get("attacker_gas", rec.get("gas", 0)) > GAS_STIPEND:
        if rec["kind"] == "CALL":
            out.append(
                _mk_issue(
                    contract,
                    runtime_hex,
                    address,
                    rec,
                    swc_id=REENTRANCY,
                    title="External Call To User-Supplied Address",
                    severity="Low",
                    description_head=(
                        "A call to a user-supplied address is executed."
                    ),
                    description_tail=_text.EXTERNAL_CALLS_REMEDIATION,
                )
            )
        elif rec["kind"] == "DELEGATECALL":
            out.append(
                _mk_issue(
                    contract,
                    runtime_hex,
                    address,
                    rec,
                    swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
                    title="Delegatecall to user-supplied address",
                    severity="High",
                    description_head=(
                        "The contract delegates execution to another "
                        "contract with a user-supplied address."
                    ),
                    description_tail=_text.DELEGATECALL_REMEDIATION,
                )
            )
    return out


def evidence_issues(contract, outcome: Dict, address: int) -> List[Issue]:
    """Concrete Issues from the prepass outcome's evidence records."""
    from mythril_tpu_torch.analysis.prepass import REPLAY_GAS_LIMIT

    records = (outcome or {}).get("evidence") or []
    runtime_hex = getattr(contract, "code", "") or ""
    if runtime_hex.startswith("0x"):
        runtime_hex = runtime_hex[2:]

    # state-access severity mirrors the reference's user-defined-vs-
    # fixed callee split: any attacker-targetable call in this contract
    # upgrades the reentrancy surface to Medium
    user_defined_callee = any(
        rec.get("to_attacker") or rec.get("target_tainted")
        for rec in records
        if rec.get("class") == "call"
    )

    issues: List[Issue] = []
    for rec in records:
        if (rec.get("gas_min") or 0) > REPLAY_GAS_LIMIT:
            continue  # the claimed replay gas limit could not reach it
        cls = rec.get("class")
        if cls == "wrap":
            issues.append(
                _mk_issue(
                    contract,
                    runtime_hex,
                    address,
                    rec,
                    swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                    title="Integer Arithmetic Bugs",
                    severity="High",
                    description_head="The arithmetic operator can {}.".format(
                        "underflow"
                        if rec["op"] == "subtraction"
                        else "overflow"
                    ),
                    description_tail=_text.INTEGER_REMEDIATION,
                )
            )
        elif cls == "call":
            issues.extend(_call_issues(contract, runtime_hex, address, rec))
        elif cls == "state_acc":
            access_kind = "Read of" if rec["access"] == "SLOAD" else "Write to"
            address_kind = "user defined" if user_defined_callee else "fixed"
            issues.append(
                _mk_issue(
                    contract,
                    runtime_hex,
                    address,
                    rec,
                    swc_id=REENTRANCY,
                    title="State access after external call",
                    severity="Medium" if user_defined_callee else "Low",
                    description_head=(
                        f"{access_kind} persistent state following "
                        "external call"
                    ),
                    description_tail=(
                        _text.STATE_CHANGE_DESCRIPTION_TAIL_TEMPLATE.format(
                            address_kind
                        )
                    ),
                )
            )
        elif cls == "env":
            if rec["swc"] == TX_ORIGIN_USAGE:
                issues.append(
                    _mk_issue(
                        contract,
                        runtime_hex,
                        address,
                        rec,
                        swc_id=TX_ORIGIN_USAGE,
                        title="Dependence on tx.origin",
                        severity="Low",
                        description_head=(
                            "Use of tx.origin as a part of authorization "
                            "control."
                        ),
                        description_tail=_text.ORIGIN_REMEDIATION,
                    )
                )
            else:
                operation = rec.get("operation") or ""
                issues.append(
                    _mk_issue(
                        contract,
                        runtime_hex,
                        address,
                        rec,
                        swc_id=rec["swc"],
                        title="Dependence on predictable environment variable",
                        severity="Low",
                        description_head=(
                            "A control flow decision is made based on "
                            "{}.".format(operation)
                        ),
                        description_tail=(
                            operation
                            + " is used to determine a control flow "
                            "decision. " + _text.PREDICTABLE_VARS_REMEDIATION
                        ),
                    )
                )
    if issues:
        log.info(
            "Device evidence synthesized %d issue(s) across %s",
            len(issues),
            sorted({i.swc_id for i in issues}),
        )
    return issues
