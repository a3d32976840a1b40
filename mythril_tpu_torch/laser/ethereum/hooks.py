"""One event bus for every engine hook.

The reference engine scatters six lifecycle hook lists, two
per-opcode hook dicts and two per-instruction hook dicts across the
VM object (mythril/laser/ethereum/svm.py:560-643). Here they are one
subscription table keyed by channel:

    lifecycle channels   "start_sym_exec", "stop_sym_exec",
                         "start_sym_trans", "stop_sym_trans",
                         "execute_state", "add_world_state"
    opcode channels      ("pre", "SSTORE"), ("post", "CALL"), ...
    instruction channels ("instr:pre", "ADD"), ("instr:post", ...)

Opcode subscribers may be *batch* consumers: they receive the whole
vector of states that hit the opcode in one engine step. The host
engine steps one state at a time, so batches are singletons there —
but the device engine delivers real lane vectors through the same
channel, which is what lets detection modules run unmodified against
both engines.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.plugin.signals import PluginSkipState

log = logging.getLogger(__name__)

LIFECYCLE_CHANNELS = (
    "start_sym_exec",
    "stop_sym_exec",
    "start_sym_trans",
    "stop_sym_trans",
    "execute_state",
    "add_world_state",
)


#: the hook phase ("pre"/"post") currently being dispatched, per
#: thread — detection modules branch on it (module_helpers.is_prehook).
#: An explicit context instead of the reference's stack-name sniffing:
#: this engine's dispatch frames (bus.emit / emit_opcode) don't carry
#: the reference's function names, so the sniff silently mis-phased
#: every phase-dependent module (SWC-116 was undetectable until the
#: wide-corpus shapes flushed it out).
_PHASE = threading.local()


def current_hook_phase() -> Optional[str]:
    return getattr(_PHASE, "value", None)


class HookBus:
    """Subscription table + dispatch for every engine event."""

    def __init__(self) -> None:
        self._subs: Dict[object, List[Callable]] = defaultdict(list)
        self._batch_subs: Dict[object, List[Callable]] = defaultdict(list)

    # -- subscription --------------------------------------------------
    def on(self, channel, fn: Callable, batch: bool = False) -> None:
        (self._batch_subs if batch else self._subs)[channel].append(fn)

    def extend(self, channel, fns) -> None:
        self._subs[channel].extend(fns)

    def subscribers(self, channel) -> List[Callable]:
        return self._subs[channel]

    def has(self, channel) -> bool:
        return bool(self._subs.get(channel)) or bool(
            self._batch_subs.get(channel)
        )

    # -- dispatch ------------------------------------------------------
    def emit(self, channel, *payload) -> None:
        """Fire every per-event subscriber; exceptions propagate (they
        are control flow: PluginSkip*, stop signals). Batch consumers
        only exist on opcode channels — see emit_opcode."""
        phased = isinstance(channel, tuple) and channel[0] in ("pre", "post")
        if phased:
            prev = current_hook_phase()
            _PHASE.value = channel[0]
        try:
            for fn in self._subs.get(channel, ()):
                fn(*payload)
            for fn in self._batch_subs.get(channel, ()):
                fn([payload[0]] if payload else [])
        finally:
            if phased:
                _PHASE.value = prev

    def emit_opcode(self, phase: str, opcode: str, states: List) -> List:
        """Fire an opcode channel over a state vector. Returns the
        surviving states: a PluginSkipState from a per-state
        subscriber removes that state from the batch (the reference's
        post-hook drop semantics, svm.py:572-582)."""
        key = (phase, opcode)
        prev = current_hook_phase()
        _PHASE.value = phase
        try:
            survivors = []
            for state in states:
                dropped = False
                for fn in self._subs.get(key, ()):
                    try:
                        fn(state)
                    except PluginSkipState:
                        dropped = True
                        break
                if not dropped:
                    survivors.append(state)
            for fn in self._batch_subs.get(key, ()):
                fn(survivors)
            return survivors
        finally:
            _PHASE.value = prev
