"""Checkpoint / resume for the batched engine.

The port's copy of the JAX package's laser/batch/checkpoint.py, with
the same npz format (FORMAT_VERSION 4, arena-shape metadata): every
array is written in the JAX package's dtypes (a batch of torch tensors
is converted field by field, `state.field_to_numpy`), so a checkpoint
written by either package loads in the other. `load_checkpoint` returns
numpy fields; `interop.batch_from_numpy` / `code_table_from_numpy` put
them on a device.

The reference has no checkpointing at all (SURVEY.md §5: its closest
artifacts are the statespace JSON dump and inter-transaction open-state
pruning). Because this engine's entire frontier is a pytree of fixed-
shape arrays, a checkpoint is a plain `.npz`: every field of the
StateBatch (and the code table it runs against), restorable onto any
device topology — the lane axis reshards on load.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from mythril_tpu_torch.laser.batch.state import CodeTable, StateBatch, field_to_numpy

log = logging.getLogger(__name__)

FORMAT_VERSION = 4  # v2: + pc_seen/branch journal; v3: + empty_world;
#                     v4: + arena-shape metadata (the mismatch gate)


def _host(value) -> np.ndarray:
    """A field as a host numpy array (a torch tensor is copied off its
    device)."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _batch_arrays(batch: StateBatch) -> Dict[str, np.ndarray]:
    """{field: numpy array in the JAX package's dtype} of a batch of
    numpy arrays or of torch tensors."""
    return {
        name: field_to_numpy(name, value) if hasattr(value, "detach") else np.asarray(value)
        for name, value in batch._asdict().items()
    }


def arena_shape(
    batch: StateBatch, code: Optional[CodeTable] = None
) -> Dict[str, int]:
    """The capacity signature a checkpoint was written under. Loading
    one into a DIFFERENT arena shape (the persistent service owns one
    fixed-shape warm arena) must refuse with a clear error instead of
    resharding garbage into mismatched lanes — this dict is what the
    refusal compares."""
    shape = {
        "lanes": int(batch.pc.shape[0]),
        "stack_cap": int(batch.stack.shape[1]),
        "mem_cap": int(batch.mem.shape[1]),
        "storage_cap": int(batch.storage_keys.shape[1]),
        "calldata_cap": int(batch.calldata.shape[1]),
    }
    if code is not None:
        shape["code_rows"] = int(code.ops.shape[0])
        shape["code_cap"] = int(code.jumpdest.shape[1])
    return shape


def _check_shape(
    stored: Dict[str, int], expected: Optional[Dict[str, int]], path
) -> None:
    """Refuse a checkpoint whose arena shape contradicts the caller's.
    Only the keys the caller cares about are compared, so a service
    that doesn't pin e.g. `lanes` can leave it out of `expected`."""
    if not expected:
        return
    mismatched = {
        key: (stored.get(key), value)
        for key, value in expected.items()
        if stored.get(key) is not None and stored.get(key) != value
    }
    if mismatched:
        detail = ", ".join(
            f"{key}: checkpoint has {got}, arena wants {want}"
            for key, (got, want) in sorted(mismatched.items())
        )
        raise ValueError(
            f"checkpoint {path} was written under a different arena "
            f"shape ({detail}); refusing to load it into this arena"
        )


def save_checkpoint(
    path: Union[str, Path],
    batch: StateBatch,
    code: Optional[CodeTable] = None,
    step: int = 0,
    extra: Optional[Dict[str, np.ndarray]] = None,
    atomic: bool = False,
) -> None:
    """Write the frontier (and optionally the code table) to `path`.

    `extra` arrays ride along under their own namespace — the wave
    flush (explore.py) stores per-lane context the StateBatch itself
    doesn't carry (e.g. the synthetic-storage mask), so a resumed wave
    replays exactly. Readers that don't know the extras ignore them.

    `atomic` writes to a sibling temp file and renames it into place:
    the background wave-checkpoint writer uses this so a crash mid-
    write leaves the PREVIOUS complete checkpoint on disk, never a
    truncated npz."""
    arrays = {f"batch.{name}": value for name, value in _batch_arrays(batch).items()}
    if code is not None:
        arrays.update(
            {f"code.{name}": _host(value) for name, value in code._asdict().items()}
        )
    for name, value in (extra or {}).items():
        arrays[f"extra.{name}"] = np.asarray(value)
    meta = {
        "version": FORMAT_VERSION,
        "step": int(step),
        "shape": arena_shape(batch, code),
    }
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    if not atomic:
        np.savez_compressed(str(path), **arrays)
        return
    # mirror np.savez's extension rule so `path` names the final file
    target = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    tmp = target + ".tmp"
    with open(tmp, "wb") as fh:  # a file handle defeats suffix munging
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, target)


class WaveCheckpointWriter:
    """Background npz flusher for the pipelined wave engine.

    The explorer used to serialize each wave's seeded frontier inline
    before the dispatch — seconds of npz compression on the critical
    path. This writer takes the flush off that path: `submit` enqueues
    a build-and-write closure onto one daemon worker; writes are FIFO
    (last wave wins at a fixed path) and atomic (temp + rename), so an
    interrupted run holds the last COMPLETE frontier instead of a torn
    one. The durability trade: a process killed between dispatch and
    the worker's rename replays the previous wave, not the in-flight
    one.

    `flush` blocks until everything submitted so far is on disk (the
    explorer calls it before its run() returns, so outcomes never race
    their own checkpoints)."""

    def __init__(self, name: str = "wave-ckpt-writer") -> None:
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self.written = 0
        self.failed = 0

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name=self._name, daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
                self.written += 1
            except Exception:
                self.failed += 1
                log.warning("wave checkpoint flush failed", exc_info=True)
            finally:
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()

    def submit(self, fn: Callable[[], None]) -> None:
        with self._idle:
            self._pending += 1
        self._ensure_thread()
        self._q.put(fn)

    def flush(self, timeout_s: float = 60.0) -> bool:
        """Wait for every submitted write to land; False on timeout
        (the run proceeds — checkpoints are an optimization, never a
        requirement)."""
        import time

        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def close(self) -> None:
        self.flush()
        self._q.put(None)


def checkpoint_shape(path: Union[str, Path]) -> Dict[str, int]:
    """The arena shape a checkpoint was written under, without loading
    the frontier. Pre-v4 checkpoints carry no shape metadata, so it is
    derived from the stored arrays (same truth, slower read)."""
    with np.load(str(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        shape = meta.get("shape")
        if shape is not None:
            return dict(shape)
        out = {
            "lanes": int(data["batch.pc"].shape[0]),
            "stack_cap": int(data["batch.stack"].shape[1]),
            "mem_cap": int(data["batch.mem"].shape[1]),
            "storage_cap": int(data["batch.storage_keys"].shape[1]),
            "calldata_cap": int(data["batch.calldata"].shape[1]),
        }
        if f"code.{CodeTable._fields[0]}" in data:
            out["code_rows"] = int(data["code.ops"].shape[0])
            out["code_cap"] = int(data["code.jumpdest"].shape[1])
        return out


def load_checkpoint_extra(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """The sidecar arrays a checkpoint carries beyond the frontier."""
    out: Dict[str, np.ndarray] = {}
    with np.load(str(path)) as data:
        for key in data.files:
            if key.startswith("extra."):
                out[key[len("extra."):]] = data[key]
    return out


def load_checkpoint(
    path: Union[str, Path],
    expect_shape: Optional[Dict[str, int]] = None,
) -> Tuple[StateBatch, Optional[CodeTable], int]:
    """Restore (batch, code_table_or_None, step) from `path`.

    `expect_shape` (an `arena_shape`-style dict; partial is fine) makes
    the load refuse — clear ValueError, not garbage lanes — when the
    checkpoint was written under a different arena shape than the one
    it is being restored into."""
    with np.load(str(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        version = meta.get("version")
        if not isinstance(version, int) or not 1 <= version <= FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        stored_shape = meta.get("shape")
        if stored_shape is None:  # pre-v4: derive from the arrays
            stored_shape = {
                "lanes": int(data["batch.pc"].shape[0]),
                "stack_cap": int(data["batch.stack"].shape[1]),
                "mem_cap": int(data["batch.mem"].shape[1]),
                "storage_cap": int(data["batch.storage_keys"].shape[1]),
                "calldata_cap": int(data["batch.calldata"].shape[1]),
            }
            if f"code.{CodeTable._fields[0]}" in data:
                stored_shape["code_rows"] = int(data["code.ops"].shape[0])
                stored_shape["code_cap"] = int(
                    data["code.jumpdest"].shape[1]
                )
        _check_shape(stored_shape, expect_shape, path)
        fields = {}
        for name in StateBatch._fields:
            key = f"batch.{name}"
            if key in data:
                fields[name] = data[key]
        missing = [n for n in StateBatch._fields if n not in fields]
        # fields newer than the checkpoint's format start at their
        # defaults; any other absence (any version) is corruption
        MISSING_OK = {
            1: {"pc_seen", "br_pc", "br_taken", "br_cnt", "empty_world"},
            2: {"empty_world"},
        }
        allowed = MISSING_OK.get(version, set())
        if missing and not set(missing) <= allowed:
            raise ValueError(f"checkpoint missing fields: {missing}")
        if missing:
            from mythril_tpu_torch.laser.batch.state import BRANCH_CAP, PC_BITMAP_WORDS

            n = int(np.asarray(fields["pc"]).shape[0])
            empties = {
                "pc_seen": lambda: np.zeros((n, PC_BITMAP_WORDS), np.uint32),
                "br_pc": lambda: np.full((n, BRANCH_CAP), -1, np.int32),
                "br_taken": lambda: np.zeros((n, BRANCH_CAP), np.uint8),
                "br_cnt": lambda: np.zeros((n,), np.int32),
                # pre-v3 checkpoints ran every call through takeover;
                # resuming under the default analyze world is the new
                # engine behavior, not a semantic change to the lanes
                "empty_world": lambda: np.ones((n,), np.uint8),
            }
            for name in missing:
                fields[name] = empties[name]()
        batch = StateBatch(**fields)
        code = None
        if f"code.{CodeTable._fields[0]}" in data:
            code = CodeTable(
                **{name: data[f"code.{name}"] for name in CodeTable._fields}
            )
    return batch, code, int(meta.get("step", 0))
