"""Versioned, checksummed router artifacts: ``router-v<N>.json``.

The JAX compile plane's refusal-not-misload discipline (its
compileplane/cache.py) applied to the cost model: one JSON document per trained
model, named by a monotonically increasing version, written
atomically (tmp + fsync + ``os.replace`` + parent-dir fsync) so a
fleet-shared directory never reads interleaved bytes.  Readers verify
the kind tag, the schema version (NEWER versions are refused — a
rolled-back replica must not misparse a newer trainer's artifact),
the routing-feature schema pin, the filename-vs-header version match,
and a sha256 checksum over the canonical document.  Anything off is
REFUSED with a counted reason (``mtpu_router_refused_total{reason}``)
and the caller falls back to the built-in heuristics — a bad artifact
routes like today, it never mis-routes."""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.observe.routing import SCHEMA_VERSION as ROUTING_SCHEMA_VERSION

log = logging.getLogger(__name__)

#: router artifact schema — readers refuse NEWER versions
ROUTER_SCHEMA_VERSION = 1

_KIND = "mtpu-router"
_NAME_RE = re.compile(r"^router-v(\d+)\.json$")


class ArtifactRefused(ValueError):
    """A router/tuning artifact failed verification. ``reason`` is the
    counted refusal class (checksum / schema / kind / feature-schema /
    version / junk)."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


def _refused_counter():
    from mythril_tpu_torch.observe.registry import registry

    return registry().counter(
        "mtpu_router_refused_total",
        "router/tuning artifacts refused (never mis-loaded), by reason",
    )


def count_refusal(reason: str, path: str, detail: str = "") -> None:
    _refused_counter().labels(reason=reason).inc()
    log.warning("router refused artifact %s: %s %s", path, reason, detail)


def checksum_doc(doc: Dict) -> str:
    """sha256 over the canonical (sorted, checksum-less) document."""
    body = {k: v for k, v in doc.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()[:32]


def _atomic_write(path: str, doc: Dict) -> None:
    parent = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=".router-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fp:
            json.dump(doc, fp, sort_keys=True)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
        dfd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def router_versions(directory: str) -> List[Tuple[int, str]]:
    """``(version, path)`` for every router-v<N>.json present, newest
    first. Presence only — verification happens at load."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def save_router(directory: str, model: Dict, version: Optional[int] = None) -> str:
    """Write the next (or explicit) router artifact version; returns
    its path. The document embeds the routing-record schema version it
    was trained against — a reader on a different feature schema
    refuses rather than silently mis-indexing columns."""
    os.makedirs(directory, exist_ok=True)
    if version is None:
        versions = router_versions(directory)
        version = (versions[0][0] + 1) if versions else 1
    doc = {
        "schema_version": ROUTER_SCHEMA_VERSION,
        "kind": _KIND,
        "version": int(version),
        "feature_schema_version": ROUTING_SCHEMA_VERSION,
        "model": model,
    }
    doc["checksum"] = checksum_doc(doc)
    path = os.path.join(directory, f"router-v{version}.json")
    _atomic_write(path, doc)
    return path


def verify_doc(
    doc,
    path: str,
    kind: str = _KIND,
    schema_version: int = ROUTER_SCHEMA_VERSION,
    expect_version: Optional[int] = None,
) -> Dict:
    """The shared header checks (also used by tuning.py's artifacts).
    Raises ArtifactRefused; returns the verified document."""
    if not isinstance(doc, dict):
        raise ArtifactRefused("junk", "not an object")
    if doc.get("kind") != kind:
        raise ArtifactRefused("kind", str(doc.get("kind")))
    try:
        version = int(doc.get("schema_version"))
    except (TypeError, ValueError):
        raise ArtifactRefused("schema", "unreadable schema_version")
    if version > schema_version:
        raise ArtifactRefused(
            "schema", f"v{version} newer than this reader (v{schema_version})"
        )
    if doc.get("checksum") != checksum_doc(doc):
        raise ArtifactRefused("checksum", "document checksum mismatch")
    if expect_version is not None and int(doc.get("version", -1)) != expect_version:
        raise ArtifactRefused(
            "version", f"header v{doc.get('version')} != filename v{expect_version}"
        )
    return doc


def load_router_file(path: str) -> Dict:
    """Verified router document or ArtifactRefused. The caller decides
    whether a refusal counts (latest_router counts + falls back)."""
    try:
        with open(path) as fp:
            doc = json.load(fp)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as exc:
        raise ArtifactRefused("junk", str(exc))
    m = _NAME_RE.match(os.path.basename(path))
    expect = int(m.group(1)) if m else None
    doc = verify_doc(doc, path, expect_version=expect)
    fsv = doc.get("feature_schema_version")
    if fsv != ROUTING_SCHEMA_VERSION:
        raise ArtifactRefused(
            "feature-schema",
            f"trained on routing v{fsv}, reader is v{ROUTING_SCHEMA_VERSION}",
        )
    if not isinstance(doc.get("model"), dict) or not doc["model"].get("routes"):
        raise ArtifactRefused("junk", "no model routes")
    return doc


def latest_router(directory: Optional[str]) -> Optional[Dict]:
    """The newest VERIFYING router artifact in `directory`, or None.
    Refused artifacts are counted and skipped — an older good version
    still loads; a directory of junk falls back to heuristics."""
    if not directory:
        return None
    for version, path in router_versions(directory):
        try:
            return load_router_file(path)
        except FileNotFoundError:
            continue  # concurrent GC: a vanished file is not corruption
        except ArtifactRefused as exc:
            count_refusal(exc.reason, path, str(exc))
            continue
    return None
