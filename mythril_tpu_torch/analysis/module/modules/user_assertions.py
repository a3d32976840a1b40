"""SWC-110: user-supplied assertion messages.

Covers mythril/analysis/module/modules/user_assertions.py — watches
for `emit AssertionFailed(string)` LOG1 topics and the MythX mstore
marker pattern. The ABI string decode is done inline (the reference
pulls in eth_abi for this one call).
"""

from __future__ import annotations

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.dsl import (
    ImmediateDetector,
    Issue,
    UnsatError,
    found_at,
    gas_range,
)
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.smt import Extract

log = logging.getLogger(__name__)

ASSERTION_FAILED_TOPIC = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)

MSTORE_MARKER = "0xcafecafecafecafecafecafecafecafecafecafecafecafecafecafecafe"


def _read_abi_string(blob: bytes) -> str:
    """Decode one ABI-encoded string payload (length word + utf-8)."""
    if len(blob) < 32:
        raise ValueError("short ABI string")
    n = int.from_bytes(blob[:32], "big")
    return blob[32 : 32 + n].decode("utf8")


class UserAssertions(ImmediateDetector):
    """Searches for user-supplied exceptions:
    emit AssertionFailed("Error")."""

    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = (
        "Search for reachable user-supplied exceptions. Report a warning if"
        " a log message is emitted: 'emit AssertionFailed(string)'"
    )
    pre_hooks = ["LOG1", "MSTORE"]
    dedupe = False  # the reference analyzes every hit

    def _message_from(self, state: GlobalState):
        """The assertion message carried by this LOG1/MSTORE, or None
        when this instruction is not an assertion marker at all
        (signalled by raising LookupError)."""
        if state.get_current_instruction()["opcode"] == "MSTORE":
            word = state.mstate.stack[-2]
            if word.symbolic or MSTORE_MARKER not in hex(word.value)[:126]:
                raise LookupError
            return f"Failed property id {Extract(15, 0, word).value}"

        topic, size, start = state.mstate.stack[-3:]
        if topic.symbolic or topic.value != ASSERTION_FAILED_TOPIC:
            raise LookupError
        if start.symbolic or size.symbolic:
            return None
        try:
            blob = bytes(
                b if isinstance(b, int) else (b.value or 0)
                for b in state.mstate.memory[
                    start.value + 32 : start.value + size.value
                ]
            )
            return _read_abi_string(blob)
        except Exception:
            return None

    def _analyze_state(self, state: GlobalState) -> list:
        try:
            message = self._message_from(state)
        except LookupError:
            return []

        try:
            witness = solver.get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            log.debug("no model found")
            return []

        if message:
            tail = f"A user-provided assertion failed with the message '{message}'"
        else:
            tail = "A user-provided assertion failed."
        log.debug("User assertion emitted: %s", tail)

        return [
            Issue(
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                description_head="A user-provided assertion failed.",
                description_tail=tail,
                transaction_sequence=witness,
                gas_used=gas_range(state),
                **found_at(state),
            )
        ]


detector = UserAssertions()
