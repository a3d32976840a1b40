"""The content-addressed cross-run verdict store.

The port's copy of the JAX package's store/store.py, with the package
renamed. An entry one package writes is read as a hit by the other on
the same code and config: the schema version, the key, the filename and
the payload checksum are computed the same way, and
`analysis_config_fingerprint` hashes the same fields.

One entry per (code hash, analysis-config fingerprint): the issue set
a completed full analysis produced, the StaticSummary export that
makes the verdict diffable (per-selector subgraph fingerprints +
block spans, resolved call targets), the evidence banks harvested
from the explorer (covered branch directions, trigger witnesses,
parent inputs), and provenance (who computed it, wall spent,
degradations, version). DTVM keys compiled artifacts on a
determinism fingerprint and Manticore reuses exploration state across
runs (PAPERS.md); here the cached artifact is the *verdict* itself.

Layout: one JSON file per entry under ``DIR/entries/``, named by the
sha256 of the key, written atomically (tmp + ``os.replace``) so
concurrent writers — several `serve` replicas, a corpus run and
a service sharing one directory — can never interleave bytes. Readers
verify three things before an entry counts as a hit: the filename key
matches the entry's own (codehash, fingerprint), the payload checksum
matches, and the schema version is known; anything else is REFUSED
and counted (`corrupt`), never served.

Eviction: a soft entry cap; when a write pushes past it, the
oldest-mtime entries are unlinked (reads refresh mtime, so the policy
is LRU-by-access at filesystem granularity).

Every counter is double-booked: plain ints on the instance for
/stats, and process-wide ``mtpu_store_*`` registry series for
Prometheus.

Where the port differs: a failure the JAX store only logs is also
recorded in the DegradationLog (support/resilience.py). A read that
raises (the lookup is a miss) and a directory that cannot be opened
record `store-unavailable`; a write that fails (the verdict is not
banked) records `store-writeback-failed`. The analysis goes on as in
the JAX package in both cases.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.support.resilience import (
    DegradationLog,
    DegradationReason,
)

log = logging.getLogger(__name__)

#: entry payload schema — bump on any key-set change; readers refuse
#: entries from a NEWER schema (a rolled-back replica must not
#: misparse a newer writer's entries) and ignore older ones
ENTRY_SCHEMA_VERSION = 1

#: soft cap on resident entries (overridable per store)
DEFAULT_CAPACITY = 4096


def _entry_key(code_hash: str, config_fp: str) -> str:
    return hashlib.sha256(f"{code_hash}:{config_fp}".encode()).hexdigest()[
        :40
    ]


def _payload_sha(entry: Dict) -> str:
    """Checksum over the verdict-bearing payload (everything except
    the checksum itself), canonically serialized."""
    body = {k: v for k, v in entry.items() if k != "payload_sha"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()[:32]


def code_hash_hex(code) -> str:
    """The store's canonical code hash: sha256 over raw bytes, no 0x
    prefix (matches CodeCache.code_hash)."""
    if isinstance(code, str):
        code = code[2:] if code.startswith("0x") else code
        try:
            code = bytes.fromhex(code)
        except ValueError:
            code = code.encode()
    return hashlib.sha256(code).hexdigest()


class StoreEntry:
    """A verified, deserialized store entry."""

    __slots__ = ("code_hash", "config_fp", "data", "path")

    def __init__(self, data: Dict, path: str) -> None:
        self.code_hash = data["code_hash"]
        self.config_fp = data["config_fingerprint"]
        self.data = data
        self.path = path

    @property
    def issues(self) -> List[Dict]:
        return list(self.data.get("issues") or [])

    @property
    def fingerprints(self) -> Dict[str, str]:
        return dict(
            (self.data.get("static") or {}).get("function_fingerprints")
            or {}
        )

    @property
    def selector_spans(self) -> Dict[str, List]:
        return dict(
            (self.data.get("static") or {}).get("selector_spans") or {}
        )

    @property
    def linked_fingerprints(self) -> Dict[str, str]:
        """selector -> call-graph fingerprint (base fp + resolved
        callee closure). Empty for entries written before the linker
        or outside corpus-link mode — consumers treat that as "no
        link diffing possible" and fall back to the plain exact-hit
        behavior."""
        return dict(
            (self.data.get("static") or {}).get("linked_fingerprints")
            or {}
        )

    @property
    def code_len(self) -> int:
        return int((self.data.get("static") or {}).get("code_len") or 0)

    @property
    def banks(self) -> Dict:
        return dict(self.data.get("banks") or {})

    @property
    def provenance(self) -> Dict:
        return dict(self.data.get("provenance") or {})


class VerdictStore:
    """Persistent (codehash, config fingerprint) -> verdict map."""

    def __init__(
        self, directory: str, capacity: int = DEFAULT_CAPACITY
    ) -> None:
        self.dir = os.path.abspath(directory)
        self.entries_dir = os.path.join(self.dir, "entries")
        os.makedirs(self.entries_dir, exist_ok=True)
        self.capacity = max(1, int(capacity))
        self._mu = threading.Lock()
        #: (code_hash, config_fp) -> entry filename; rebuilt at open,
        #: kept current by this process's reads/writes (other writers'
        #: entries are found by the key-derived filename regardless)
        self._index: Dict[Tuple[str, str], str] = {}
        #: config_fp -> {code_hash: fingerprint dict} for the
        #: near-duplicate search (only entries WITH fingerprints)
        self._fp_index: Dict[str, Dict[str, Dict[str, str]]] = {}
        # -- /stats counters (registry doubles below) ------------------
        self.hits = 0
        self.near_hits = 0
        self.misses = 0
        self.writes = 0
        self.bytes_written = 0
        self.evictions = 0
        self.corrupt = 0
        from mythril_tpu_torch.observe.registry import registry

        reg = registry()
        self._c = {
            name: reg.counter(
                f"mtpu_store_{name}_total",
                f"verdict store {label}",
            )
            for name, label in (
                ("hits", "exact (codehash, config) hits"),
                ("near_hits", "near-duplicate fingerprint-diff hits"),
                ("misses", "lookups with no usable entry"),
                ("writes", "entries written back"),
                ("bytes", "entry bytes written"),
                ("evictions", "entries evicted at the capacity cap"),
                ("corrupt", "entries refused (checksum/key/schema)"),
            )
        }
        self._scan()

    # -- open-time index -------------------------------------------------
    def _scan(self) -> None:
        """Build the in-memory indexes from the directory. Unreadable
        or invalid entries are skipped (and counted) — one corrupt
        file must not take the store down, and entries another replica
        evicts mid-scan simply don't make the index."""
        try:
            names = sorted(os.listdir(self.entries_dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            entry = self._load(os.path.join(self.entries_dir, name))
            if entry is None:
                continue
            self._remember(entry, name)

    def _remember(self, entry: StoreEntry, name: str) -> None:
        self._index[(entry.code_hash, entry.config_fp)] = name
        fps = entry.fingerprints
        if fps:
            self._fp_index.setdefault(entry.config_fp, {})[
                entry.code_hash
            ] = fps

    def _load(self, path: str) -> Optional[StoreEntry]:
        """Read + verify one entry file; None (counted corrupt) on any
        refusal. A half-written file cannot exist (atomic rename), but
        a truncated disk, a hand-edited file, or a newer writer all
        land here. A file that VANISHED between listing and open —
        another replica's eviction sweep beat us to it, routine once
        the directory is fleet-shared — is not corruption: None, no
        counter, no log noise."""
        try:
            with open(path) as fp:
                data = json.load(fp)
            if not isinstance(data, dict):
                raise ValueError("entry is not an object")
            version = int(data.get("schema_version", -1))
            if version > ENTRY_SCHEMA_VERSION:
                raise ValueError(
                    f"entry schema v{version} is newer than this reader"
                )
            if data.get("payload_sha") != _payload_sha(data):
                raise ValueError("payload checksum mismatch")
            expected = _entry_key(
                data["code_hash"], data["config_fingerprint"]
            )
            if os.path.basename(path) != f"{expected}.json":
                raise ValueError(
                    "entry key does not match its filename (moved or "
                    "tampered entry)"
                )
            return StoreEntry(data, path)
        except FileNotFoundError:
            log.debug("store entry %s vanished mid-read (concurrent "
                      "evictor); treating as a miss", path)
            return None
        except (OSError, ValueError, KeyError, TypeError) as why:
            self.corrupt += 1
            self._c["corrupt"].inc()
            log.warning("verdict store refused entry %s: %s", path, why)
            return None

    # -- the store-tier circuit breaker ----------------------------------
    @staticmethod
    def _breaker():
        """The store-tier breaker (support/breaker.py), or None when
        the layer is off. An OPEN breaker turns every lookup into a
        miss and every write into a no-op — the tier ladder's
        store->miss rung with memory, so a dead disk is not re-probed
        per job."""
        from mythril_tpu_torch.support import breaker as cb

        if not cb.breakers_enabled():
            return None
        return cb.breaker(cb.TIER_STORE)

    # -- lookups ---------------------------------------------------------
    def get(self, code_hash: str, config_fp: str) -> Optional[StoreEntry]:
        """Exact hit or None. A refused (corrupt/mismatched) entry is
        a miss — never a partial answer."""
        br = self._breaker()
        if br is not None and not br.allow():
            with self._mu:
                self.misses += 1
            self._c["misses"].inc()
            return None
        name = f"{_entry_key(code_hash, config_fp)}.json"
        path = os.path.join(self.entries_dir, name)
        try:
            from mythril_tpu_torch.support.resilience import inject

            inject("store.read")
            exists = os.path.exists(path)
        except Exception as why:
            if br is not None:
                br.record_failure(str(why))
            _degraded(DegradationReason.STORE_UNAVAILABLE, f"read of {name}: {why}")
            with self._mu:
                self.misses += 1
            self._c["misses"].inc()
            return None
        if not exists:
            with self._mu:
                self.misses += 1
            self._c["misses"].inc()
            return None
        entry = self._load(path)
        if entry is None or entry.code_hash != code_hash or (
            entry.config_fp != config_fp
        ):
            if entry is not None:
                # filename collided but key differs: refuse loudly
                self.corrupt += 1
                self._c["corrupt"].inc()
                log.warning(
                    "verdict store entry %s holds a different key; "
                    "refused", path,
                )
            with self._mu:
                self.misses += 1
            self._c["misses"].inc()
            return None
        try:
            os.utime(path)  # LRU freshness for the eviction sweep
        except OSError:
            pass
        with self._mu:
            self.hits += 1
            self._remember(entry, name)
        self._c["hits"].inc()
        if br is not None:
            br.record_success()
        return entry

    def nearest(
        self,
        config_fp: str,
        fingerprints: Dict[str, str],
        exclude_code_hash: Optional[str] = None,
    ) -> Optional[StoreEntry]:
        """The stored entry (same config fingerprint) whose
        per-selector fingerprint set best overlaps `fingerprints`:
        most shared selectors with EQUAL fingerprints, requiring at
        least one equal and at least one shared selector overall. None
        when nothing plausible exists — the caller falls back to full
        analysis, never to a bad merge."""
        if not fingerprints:
            return None
        best_key = None
        best_score = (0, 0.0)
        with self._mu:
            candidates = dict(self._fp_index.get(config_fp) or {})
        for code_hash, fps in candidates.items():
            if code_hash == exclude_code_hash:
                continue
            shared = set(fps) & set(fingerprints)
            if not shared:
                continue
            equal = sum(
                1 for sel in shared if fps[sel] == fingerprints[sel]
            )
            if equal == 0:
                continue
            union = len(set(fps) | set(fingerprints))
            score = (equal, equal / union if union else 0.0)
            if score > best_score:
                best_score = score
                best_key = code_hash
        if best_key is None:
            return None
        entry = self.get(best_key, config_fp)
        if entry is not None:
            # reclassify: the get() above booked an exact hit, but the
            # caller asked a near-duplicate question
            with self._mu:
                self.hits -= 1
                self.near_hits += 1
            self._c["near_hits"].inc()
        return entry

    def note_miss(self) -> None:
        """Book a miss discovered outside get() (no candidate entry at
        all for a near-duplicate probe)."""
        with self._mu:
            self.misses += 1
        self._c["misses"].inc()

    # -- write-back ------------------------------------------------------
    def put(
        self,
        code_hash: str,
        config_fp: str,
        issues: List[Dict],
        static: Optional[Dict] = None,
        banks: Optional[Dict] = None,
        provenance: Optional[Dict] = None,
    ) -> Optional[str]:
        """Persist one verdict; returns the entry path (None when the
        write failed — a full disk degrades the store to a no-op, it
        never sinks the analysis). Last writer wins per key, which is
        safe: two writers with the same key computed the same verdict
        from the same code and config."""
        entry = {
            "schema_version": ENTRY_SCHEMA_VERSION,
            "code_hash": code_hash,
            "config_fingerprint": config_fp,
            "issues": list(issues or []),
            "static": dict(static or {}),
            "banks": dict(banks or {}),
            "provenance": dict(
                {
                    "host": socket.gethostname(),
                    "pid": os.getpid(),
                    "created_at": time.time(),
                },
                **(provenance or {}),
            ),
        }
        entry["payload_sha"] = _payload_sha(entry)
        br = self._breaker()
        if br is not None and not br.allow():
            return None  # the write tier is open: degrade to no-op
        name = f"{_entry_key(code_hash, config_fp)}.json"
        path = os.path.join(self.entries_dir, name)
        blob = json.dumps(entry, sort_keys=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            from mythril_tpu_torch.support.resilience import inject

            inject("store.write")
            with open(tmp, "w") as fp:
                fp.write(blob)
                # durability before visibility: the entry's bytes are
                # on the platter BEFORE the rename publishes it — a
                # crash can leave a stale tmp file, never a published
                # entry whose content is still in the page cache
                fp.flush()
                os.fsync(fp.fileno())
            os.replace(tmp, path)  # atomic: readers see old or new
            # ... and the rename itself: fsync the parent directory so
            # the entry survives a power cut after put() returns
            try:
                dir_fd = os.open(self.entries_dir, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
            except OSError:
                pass  # not every filesystem supports directory fsync
        except Exception as why:
            log.warning("verdict store write failed for %s: %s", name, why)
            _degraded(DegradationReason.STORE_WRITEBACK_FAILED, f"write of {name}: {why}")
            if br is not None:
                br.record_failure(str(why))
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        if br is not None:
            br.record_success()
        with self._mu:
            self.writes += 1
            self.bytes_written += len(blob)
            self._remember(StoreEntry(entry, path), name)
        self._c["writes"].inc()
        self._c["bytes"].inc(len(blob))
        self._evict()
        return path

    def _evict(self) -> None:
        """Unlink oldest-mtime entries past the capacity cap.

        Fleet-shared directories make every step racy: another
        replica's sweep can unlink any file between our listdir and
        the stat, or win the unlink itself. Each row is therefore
        statted under its own guard (a vanished file simply isn't a
        candidate) and a lost unlink race books nothing — the entry is
        gone either way, and exactly one sweep counts the eviction."""
        try:
            names = [
                n for n in os.listdir(self.entries_dir)
                if n.endswith(".json")
            ]
        except OSError:
            return
        rows = []
        for name in names:
            try:
                rows.append(
                    (os.path.getmtime(
                        os.path.join(self.entries_dir, name)
                    ), name)
                )
            except OSError:
                continue  # vanished mid-scan: already evicted
        excess = len(rows) - self.capacity
        if excess <= 0:
            return
        for _mtime, name in sorted(rows)[:excess]:
            try:
                os.unlink(os.path.join(self.entries_dir, name))
            except OSError:
                continue
            with self._mu:
                self.evictions += 1
                for key, val in list(self._index.items()):
                    if val == name:
                        del self._index[key]
                        self._fp_index.get(key[1], {}).pop(key[0], None)
            self._c["evictions"].inc()

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        try:
            return sum(
                1
                for n in os.listdir(self.entries_dir)
                if n.endswith(".json")
            )
        except OSError:
            return 0

    def stats(self) -> Dict:
        with self._mu:
            return {
                "dir": self.dir,
                "entries": len(self),
                "capacity": self.capacity,
                "hits": self.hits,
                "near_hits": self.near_hits,
                "misses": self.misses,
                "writes": self.writes,
                "bytes": self.bytes_written,
                "evictions": self.evictions,
                "corrupt": self.corrupt,
            }


# ---------------------------------------------------------------------------
# process-wide open helper (one VerdictStore per directory)
# ---------------------------------------------------------------------------
_OPEN: Dict[str, VerdictStore] = {}
_OPEN_MU = threading.Lock()


def open_store(directory: Optional[str]) -> Optional[VerdictStore]:
    """The (cached) store for `directory`; None when no directory is
    configured or the store cannot be opened. One instance per path so
    the in-process counters and fingerprint index are shared by the
    service engine, the corpus driver, and the analyzer."""
    if not directory:
        return None
    path = os.path.abspath(directory)
    with _OPEN_MU:
        store = _OPEN.get(path)
        if store is None:
            try:
                store = VerdictStore(path)
            except OSError as why:
                log.warning(
                    "verdict store unavailable at %s: %s", path, why
                )
                _degraded(DegradationReason.STORE_UNAVAILABLE, f"open of {path}: {why}")
                return None
            _OPEN[path] = store
        return store


def _degraded(reason: str, detail: str) -> None:
    """Record a store failure the JAX package only logs (the module
    docstring's departure)."""
    DegradationLog().record(reason, site="store", detail=detail)


def close_stores() -> None:
    """Test hook: forget cached instances (files stay on disk)."""
    with _OPEN_MU:
        _OPEN.clear()
