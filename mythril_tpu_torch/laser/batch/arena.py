"""Host readback of one wave's arena, evidence banks and journals.

The device half of the JAX package's laser/batch/arena.py `ArenaView`:
two counters are read first (`ar_count`, the widest storage journal),
the arena and the storage journals are sliced on the card to their
power-of-two buckets, and everything the explorer's harvest reads comes
back in one bundled transfer (`hostsync.fetch`: non-blocking copies into
pinned host buffers, then one synchronize). The view costs two host
syncs, as the JAX view's two `device_get`s do. Arrays are numpy in the
JAX package's dtypes, so a view compares with the JAX view field by
field.

The term decode (`calldata_byte`, `term`, `row_operand_terms`,
`path_condition`) lifts rows into SMT terms and waits for the port's
copy of the SMT term layer; what is here reads rows, banks and journals
only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.support import hostsync
from mythril_tpu_torch.support.opcodes import OPCODES

_NAME = {entry[0]: name for name, entry in OPCODES.items()}

_U32 = ("va", "vb", "ev_a", "ev_b", "ev_gas", "gas_min", "gas_max",
        "storage_keys", "storage_vals")


def _pow2(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to [1, cap]."""
    return min(cap, 1 << max(int(n) - 1, 0).bit_length()) if n > 1 else 1


class ArenaView:
    """Read-only host copy of one wave's arena, per-lane journals and
    evidence banks, and of what else the explorer's harvest reads (halt
    status and pc, gas bounds, storage journals). `bytes_fetched` /
    `bytes_full` record what the pow2 slicing saved."""

    def __init__(self, symb) -> None:
        base = symb.base
        count, max_cnt = hostsync.read(torch.stack([
            symb.ar_count.to(torch.int64), base.storage_cnt.max().to(torch.int64)]))
        self.count = int(count)
        ar_rows = _pow2(self.count, int(symb.ar_op.shape[0]))
        sj_w = _pow2(int(max_cnt), int(base.storage_keys.shape[1]))
        fields = (
            ("op", symb.ar_op[:ar_rows]),
            ("a", symb.ar_a[:ar_rows]),
            ("b", symb.ar_b[:ar_rows]),
            ("va", symb.ar_va[:ar_rows]),
            ("vb", symb.ar_vb[:ar_rows]),
            ("br_pc", base.br_pc),
            ("br_taken", base.br_taken),
            ("br_tid", symb.br_tid),
            ("br_cnt", base.br_cnt),
            ("calldatasize", base.calldatasize),
            ("ev_pc", symb.ev_pc),
            ("ev_kind", symb.ev_kind),
            ("ev_tid", symb.ev_tid),
            ("ev_vtid", symb.ev_vtid),
            ("ev_a", symb.ev_a),
            ("ev_b", symb.ev_b),
            ("ev_aux", symb.ev_aux),
            ("ev_gas", symb.ev_gas),
            ("ev_cnt", symb.ev_cnt),
            ("ev_overflow", symb.ev_overflow),
            ("ret_off", symb.ret_off),
            ("ret_len", symb.ret_len),
            ("sval_tid", symb.sval_tid),
            # RETURN windows live in low memory in compiler output; the
            # 512-byte head covers them
            ("mem_tid_head", symb.mem_tid[:, :512]),
            ("status", base.status),
            ("halt_pc", base.pc),
            ("gas_min", base.gas_min),
            ("gas_max", base.gas_max),
            ("storage_keys", base.storage_keys[:, :sj_w]),
            ("storage_vals", base.storage_vals[:, :sj_w]),
            ("storage_cnt", base.storage_cnt),
        )
        host = hostsync.fetch([t for _, t in fields])
        self.bytes_fetched = 0
        for (name, _), arr in zip(fields, host):
            if name in _U32:
                # int32 limbs hold values below 2**16: the uint32 bit
                # pattern is the same, so a view converts; int64 gas
                # fields hold values below 2**32
                arr = arr.view(np.uint32) if arr.dtype == np.int32 else arr.astype(np.uint32)
            setattr(self, name, arr)
            self.bytes_fetched += arr.nbytes
        # what the uncompacted harvest transferred: full arena tables
        # plus full-width storage journals
        self.bytes_full = self.bytes_fetched + (
            (symb.ar_op.shape[0] - ar_rows)
            * (self.op.itemsize * 3 + self.va.itemsize * self.va.shape[-1] * 2)
            + 2 * (base.storage_keys.shape[1] - sj_w) * self.storage_keys.shape[0]
            * self.storage_keys.shape[-1] * self.storage_keys.itemsize
        )
        self._closure: Dict[int, frozenset] = {}

    def storage_tables(self):
        """(keys, vals, cnt) in the state.storage_dict_from shape."""
        return self.storage_keys, self.storage_vals, self.storage_cnt

    # -- evidence banks -------------------------------------------------
    def events(self, lane: int) -> List[Dict]:
        """The lane's banked detection events (symbolic.py EV_* kinds):
        concrete operand values as ints, term ids raw."""
        n = min(int(self.ev_cnt[lane]), self.ev_pc.shape[1])
        return [
            {
                "pc": int(self.ev_pc[lane, k]),
                "kind": int(self.ev_kind[lane, k]),
                "tid": int(self.ev_tid[lane, k]),
                "vtid": int(self.ev_vtid[lane, k]),
                "a": u256.to_int(self.ev_a[lane, k]),
                "b": u256.to_int(self.ev_b[lane, k]),
                "aux": int(self.ev_aux[lane, k]),
                "gas": int(self.ev_gas[lane, k]),
            }
            for k in range(n)
        ]

    def subterms(self, tid: int) -> frozenset:
        """All node ids reachable from `tid` (itself included): the
        dataflow closure, memoized per view."""
        if tid <= 0:
            return frozenset()
        cached = self._closure.get(tid)
        if cached is not None:
            return cached
        out = set()
        stack = [tid]
        while stack:
            t = stack.pop()
            if t <= 0 or t in out:
                continue
            out.add(t)
            row = t - 1
            if row < self.count:
                stack.append(int(self.a[row]))
                stack.append(int(self.b[row]))
        result = frozenset(out)
        self._closure[tid] = result
        return result

    def used_roots(self, lane: int) -> List[int]:
        """Term ids the lane used: every journal decision, the end-state
        storage values, banked call targets and values, and the RETURN
        window's memory taints."""
        roots = [tid for _, _, tid in self.journal(lane) if tid > 0]
        roots += [int(t) for t in self.sval_tid[lane] if t > 0]
        for ev in self.events(lane):
            if ev["vtid"] > 0:
                roots.append(ev["vtid"])
            if 4 <= ev["kind"] <= 7 and ev["tid"] > 0:  # call target
                roots.append(ev["tid"])
        off, length = int(self.ret_off[lane]), int(self.ret_len[lane])
        if off >= 0 and length > 0:
            window = self.mem_tid_head[lane, off : off + length]
            roots += [int(t) for t in window if t > 0]
        return roots

    def wrap_used(self, lane: int, wrap_tid: int) -> bool:
        """True when the wrapped result's term flows into a used root."""
        if wrap_tid <= 0:
            return False
        return any(wrap_tid in self.subterms(root) for root in self.used_roots(lane))

    @staticmethod
    def _neg_sources(t: int) -> set:
        bits = min(-t - 1, 3)
        out = set()
        if bits & 1:
            out.add("ORIGIN")
        if bits & 2:
            out.add("BLOCKHASH")
        return out

    def dag_source_ops(self, tid: int) -> set:
        """Opcode names of the rows in `tid`'s closure; negative ids
        (standalone or as row operands) contribute their provenance
        pseudo-sources."""
        if tid < 0:
            return self._neg_sources(tid)
        out = set()
        for t in self.subterms(tid):
            row = t - 1
            if row >= self.count:
                continue
            out.add(_NAME.get(int(self.op[row]), "?"))
            for operand in (int(self.a[row]), int(self.b[row])):
                if operand < 0:
                    out |= self._neg_sources(operand)
        return out

    # -- path journal ---------------------------------------------------
    def journal(self, lane: int) -> List[Tuple[int, bool, int]]:
        """[(jumpi_pc, taken, cond_tid)] for a lane."""
        n = min(int(self.br_cnt[lane]), self.br_pc.shape[1])
        return [
            (int(self.br_pc[lane, k]), bool(self.br_taken[lane, k]),
             int(self.br_tid[lane, k]))
            for k in range(n)
        ]
