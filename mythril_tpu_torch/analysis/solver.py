"""Witness concretization: path constraints -> exploit transactions.

API parity with the reference's mythril/analysis/solver.py:47-242 —
`get_transaction_sequence(global_state, constraints)` is the entry
every detection module calls, and the returned dict shape
(`{"initialState": ..., "steps": [...]}`) is the report contract.

The mechanics are organized differently from the reference: one
`WitnessBuilder` pass owns the whole concretization — it poses a
single bounded minimization query, renders each transaction step from
the model, and patches keccak placeholders through a precomputed
substitution table instead of rescanning the calldata hex position by
position.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
    hash_matcher,
    keccak_function_manager,
)
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.smt import UGE, symbol_factory
from mythril_tpu_torch.laser.smt.model import Model
from mythril_tpu_torch.support.model import get_model
from mythril_tpu_torch.support.phase_profile import PhaseProfile

log = logging.getLogger(__name__)


def pretty_print_model(model: Model) -> str:
    """Human-readable assignment dump."""
    rows = []
    for decl in model.decls():
        value = model[decl]
        try:
            rendered = "0x%x" % int(value)
        except (TypeError, ValueError):
            rendered = str(value)
        rows.append(f"{decl.name()}: {rendered}")
    return "".join(row + "\n" for row in rows)


def get_transaction_sequence(
    global_state: GlobalState, constraints: Constraints
) -> Dict:
    """Generate the concrete transaction sequence witnessing
    `constraints` (raises UnsatError when impossible)."""
    return WitnessBuilder(global_state, constraints).build()


def _word(value: int):
    return symbol_factory.BitVecVal(value, 256)


class WitnessBuilder:
    """One concretization pass: solve once, render every step."""

    #: calldata bytes per transaction the witness may use
    CALLDATA_CAP = 5000
    #: spendable funds cap per transaction sender
    SENDER_FUNDS_CAP = 10**21
    #: starting-balance cap per account: keeps witnesses readable and
    #: avoids balance-overflow artifacts (reference: solver.py:205)
    ACCOUNT_FUNDS_CAP = 10**20

    def __init__(self, global_state: GlobalState, constraints: Constraints):
        self.world = global_state.world_state
        self.transactions = self.world.transaction_sequence
        self.query = constraints.copy()
        # the first transaction's world state is rendered as the
        # initial state; by reference convention it already carries
        # the created account (code technically exists only after tx 1)
        self.genesis = self.transactions[0].world_state

    # -- the solve -----------------------------------------------------
    def _solve(self) -> Model:
        """One bounded query minimizing calldata sizes and call
        values, lexicographically per transaction."""
        goals = []
        for tx in self.transactions:
            size = tx.call_data.calldatasize
            self.query.append(UGE(_word(self.CALLDATA_CAP), size))
            self.query.append(
                UGE(
                    _word(self.SENDER_FUNDS_CAP),
                    self.world.starting_balances[tx.caller],
                )
            )
            goals.append(size)
            goals.append(tx.call_value)
        for account in self.world.accounts.values():
            self.query.append(
                UGE(
                    _word(self.ACCOUNT_FUNDS_CAP),
                    self.world.starting_balances[account.address],
                )
            )
        with PhaseProfile().measure("concretize"):
            return get_model(self.query, minimize=tuple(goals))

    # -- rendering -----------------------------------------------------
    @property
    def _creation_code_hex(self) -> str:
        first = self.transactions[0]
        if isinstance(first, ContractCreationTransaction):
            return first.code.bytecode
        return ""

    def _render_step(self, model: Model, tx) -> Dict[str, str]:
        deploying = isinstance(tx, ContractCreationTransaction)
        body = tx.code.bytecode if deploying else ""
        body += "".join(
            "{:02x}".format(b if isinstance(b, int) else (b.value or 0))
            for b in tx.call_data.concrete(model)
        )
        return {
            "input": "0x" + body,
            "value": "0x%x" % model.eval_int(tx.call_value),
            "origin": "0x" + ("%x" % model.eval_int(tx.caller)).zfill(40),
            "address": (
                "" if deploying else hex(tx.callee_account.address.value)
            ),
        }

    def _initial_state(self, model: Model) -> Dict:
        accounts = {}
        for address, account in self.genesis.accounts.items():
            balance = model.eval_int(
                self.genesis.starting_balances[_word(address)]
            )
            accounts[hex(address)] = {
                "nonce": account.nonce,
                "code": account.code.bytecode,
                "storage": str(account.storage),
                "balance": hex(balance),
            }
        return {"accounts": accounts}

    # -- keccak placeholder patching -----------------------------------
    def _hash_substitutions(self, model: Model) -> Dict[str, str]:
        """placeholder-hex -> real-keccak-hex for every placeholder
        the model bound to a concrete preimage (the reserved
        fffffff... intervals the keccak manager hands out)."""
        table: Dict[str, str] = {}
        by_size = keccak_function_manager.get_concrete_hash_data(model)
        for size, placeholders in by_size.items():
            _, inverse = keccak_function_manager.store_function[size]
            for placeholder in placeholders:
                if placeholder is None:
                    continue
                preimage = symbol_factory.BitVecVal(
                    model.eval_int(inverse(_word(placeholder))), size
                )
                real = keccak_function_manager.find_concrete_keccak(preimage)
                table["{:064x}".format(placeholder)] = "{:064x}".format(
                    real.value
                )
        return table

    def _patch_hashes(self, steps: List[Dict[str, str]], model: Model) -> None:
        if not any(hash_matcher in step["input"] for step in steps):
            return
        table = self._hash_substitutions(model)
        if not table:
            return
        code_hex = self._creation_code_hex
        for step in steps:
            data = step["input"]
            # never rewrite bytes inside the deployment code prefix
            keep = (
                len(code_hex) + 2
                if code_hex and code_hex in data
                else len("0x") + 8
            )
            tail = data[keep:]
            for placeholder, real in table.items():
                if hash_matcher in placeholder and placeholder in tail:
                    tail = tail.replace(placeholder, real)
            step["input"] = data[:keep] + tail

    # -- assembly ------------------------------------------------------
    @staticmethod
    def _mirror_calldata(steps: List[Dict[str, str]], code_hex: str) -> None:
        """`calldata` mirrors `input`; a creation step's calldata is
        the constructor arguments only (deployment bytecode stripped)."""
        for step in steps:
            step["calldata"] = step["input"]
        if code_hex:
            steps[0]["calldata"] = steps[0]["input"][len(code_hex) + 2 :]

    def build(self) -> Dict:
        model = self._solve()
        steps = [self._render_step(model, tx) for tx in self.transactions]
        self._patch_hashes(steps, model)
        self._mirror_calldata(steps, self._creation_code_hex)
        return {"initialState": self._initial_state(model), "steps": steps}
