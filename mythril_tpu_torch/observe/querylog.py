"""The solver's loss-reason taxonomy, query context and query capture.

The port's copy of the JAX package's observe/querylog.py: the loss constants (a
`DeviceVerdict`'s `loss` and `compile_program_ex`'s reason are one of
them), the thread-local query context (`query_context`, the origin
labels), and capture (`configure_capture(dir)` arms it; each captured
query's lowered constraint set serializes to `<dir>/q-<sha256>.json`
in the JAX package's artifact schema; `load_corpus` and
`deserialize_terms` read a corpus back and rebuild its queries, so
either package's solverlab replays the other's captures), and the loss
waterfall (`record_loss`,
`loss_reasons`), counted as in the JAX package in the metrics registry:
``mtpu_solver_loss_total{reason,verdict}`` and
``mtpu_solver_captured_queries_total{origin}``, the series the analysis
service's ``/stats`` solver block reads.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from mythril_tpu_torch.observe.registry import registry

log = logging.getLogger(__name__)

#: artifact schema (the JAX package's; solverlab refuses a newer one)
ARTIFACT_SCHEMA_VERSION = 1

LOSS_LOWERING_UNSUPPORTED = "LOWERING_UNSUPPORTED"
LOSS_BUCKET_OVERFLOW = "BUCKET_OVERFLOW"
LOSS_SLS_NONCONVERGED = "SLS_NONCONVERGED"
LOSS_RACE_LOST_TIMING = "RACE_LOST_TIMING"
LOSS_SPRINT_PREEMPTED = "SPRINT_PREEMPTED"
LOSS_GATE_DISABLED = "GATE_DISABLED"
LOSS_RACE_NOT_STARTED = "RACE_NOT_STARTED"
LOSS_WITNESS_INVALID = "WITNESS_INVALID"
LOSS_QUERY_TRIVIAL = "QUERY_TRIVIAL"
LOSS_DEADLINE_EXPIRED = "DEADLINE_EXPIRED"
LOSS_UNCLASSIFIED = "UNCLASSIFIED"

LOSS_REASONS = (
    LOSS_LOWERING_UNSUPPORTED,
    LOSS_BUCKET_OVERFLOW,
    LOSS_SLS_NONCONVERGED,
    LOSS_RACE_LOST_TIMING,
    LOSS_SPRINT_PREEMPTED,
    LOSS_GATE_DISABLED,
    LOSS_RACE_NOT_STARTED,
    LOSS_WITNESS_INVALID,
    LOSS_QUERY_TRIVIAL,
    LOSS_DEADLINE_EXPIRED,
    LOSS_UNCLASSIFIED,
)

#: the query-origin labels (where a query came FROM, as opposed to the
#: solverstats origin of who ANSWERED it)
QUERY_ORIGIN_FLIP = "flip-frontier"
QUERY_ORIGIN_MODULE = "module"
QUERY_ORIGIN_MEMO_MISS = "memo-miss"


# ---------------------------------------------------------------------------
# the loss waterfall: why the device did not answer a host verdict
# ---------------------------------------------------------------------------

_LOSS = None
_CAPTURED = None
_METRICS_REG = None


def _metrics():
    # the handles re-resolve when the registry instance changes
    # (reset_registry in tests): a cached child writing to an orphaned
    # registry would count nothing anyone reads
    global _LOSS, _CAPTURED, _METRICS_REG
    if _LOSS is None or _METRICS_REG is not registry():
        reg = _METRICS_REG = registry()
        _LOSS = reg.counter(
            "mtpu_solver_loss_total",
            "host-answered solver verdicts by device-loss reason",
        )
        _CAPTURED = reg.counter(
            "mtpu_solver_captured_queries_total",
            "solver queries captured to the flight-recorder corpus",
        )
    return _LOSS, _CAPTURED


def record_loss(reason: str, verdict: str, site: str = "") -> None:
    """Count one host-answered verdict against the loss taxonomy (not
    gated on the observe switch, as in the JAX package, so the sum of
    the sat losses equals the CDCL's sat count)."""
    loss, _captured = _metrics()
    loss.labels(reason=reason or LOSS_UNCLASSIFIED, verdict=verdict).inc()


def loss_marker() -> Dict:
    """A registry marker, for `loss_reasons(since=...)`."""
    _metrics()
    return registry().marker()


def loss_reasons(
    since: Optional[Dict] = None, verdict: Optional[str] = None
) -> Dict[str, int]:
    """The waterfall: {reason: count}, whole-process or as a delta
    since a `loss_marker()`; `verdict="sat"` restricts to host-won
    queries."""
    _metrics()
    reg = registry()
    snap = reg.since(since) if since is not None else reg.snapshot()
    out: Dict[str, int] = {}
    for key, value in (snap.get("mtpu_solver_loss_total") or {}).items():
        labels = dict(key)
        if verdict is not None and labels.get("verdict") != verdict:
            continue
        reason = labels.get("reason", LOSS_UNCLASSIFIED)
        if int(value):
            out[reason] = out.get(reason, 0) + int(value)
    return out


def captured_total(since: Optional[Dict] = None) -> int:
    """Queries captured to disk (process total, or the delta since a
    `loss_marker()`)."""
    _metrics()
    reg = registry()
    snap = reg.since(since) if since is not None else reg.snapshot()
    return int(
        sum((snap.get("mtpu_solver_captured_queries_total") or {}).values())
    )


# ---------------------------------------------------------------------------
# query context: where did this query come from
# ---------------------------------------------------------------------------

_CTX = threading.local()


def current_origin() -> str:
    """The innermost query-context tag; bare solves (engine
    feasibility checks) default to memo-miss — they reached the solver
    because the get_model memo missed."""
    stack = getattr(_CTX, "stack", None)
    return stack[-1] if stack else QUERY_ORIGIN_MEMO_MISS


@contextmanager
def query_context(origin: str, only_if_root: bool = False):
    """Tag queries issued inside the block with `origin`. With
    `only_if_root` the tag applies only when no enclosing context set
    one (get_model's memo-miss default must not mask the flip tag of
    its callers)."""
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    if only_if_root and stack:
        yield
        return
    stack.append(origin)
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# capture configuration
# ---------------------------------------------------------------------------

_CAPTURE_DIR: Optional[str] = None
_CAPTURE_MU = threading.Lock()
#: per-artifact observation cap: a hot memo-missing query re-posed
#: hundreds of times must not grow its artifact unboundedly
MAX_OBSERVATIONS = 16


def configure_capture(out_dir: Optional[str]) -> None:
    """Arm (or, with None, disarm) query capture into `out_dir`."""
    global _CAPTURE_DIR
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _CAPTURE_DIR = out_dir or None


def capture_dir() -> Optional[str]:
    return _CAPTURE_DIR


def capture_enabled() -> bool:
    return _CAPTURE_DIR is not None


# ---------------------------------------------------------------------------
# term (de)serialization: the replayable program
# ---------------------------------------------------------------------------


def serialize_terms(lowered) -> Dict:
    """Flatten a lowered constraint set into a JSON-able DAG: one node
    per interned term in topological order, term args as ["t", idx],
    ints as ["i", n], names as ["s", name]. Raises NotImplementedError
    on payloads outside (Term | int | str) — post-`lower` sets never
    hold any."""
    from mythril_tpu_torch.laser.smt.terms import Term

    order: List = []
    index: Dict[int, int] = {}
    for root in lowered:
        stack = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if node._id in index:
                continue
            if expanded:
                if node._id not in index:
                    index[node._id] = len(order)
                    order.append(node)
                continue
            stack.append((node, True))
            for a in node.args:
                if isinstance(a, Term) and a._id not in index:
                    stack.append((a, False))

    nodes = []
    for t in order:
        args = []
        for a in t.args:
            if isinstance(a, Term):
                args.append(["t", index[a._id]])
            elif isinstance(a, bool):
                args.append(["i", int(a)])
            elif isinstance(a, int):
                args.append(["i", a])
            elif isinstance(a, str):
                args.append(["s", a])
            else:
                raise NotImplementedError(
                    f"unserializable payload {type(a).__name__} in {t.op}"
                )
        nodes.append({"op": t.op, "w": t.width or 0, "a": args})
    return {
        "nodes": nodes,
        "roots": [index[c._id] for c in lowered],
    }


def content_address(doc: Dict) -> str:
    """sha256 of the program with var NAMES canonicalized to their
    first-occurrence index: the preprocessor's gensym'd fresh names
    (select/UF elimination) differ run to run, but the query they
    encode is the same query — and must dedup to the same artifact."""
    rename: Dict[str, str] = {}
    canon_nodes = []
    for node in doc["nodes"]:
        args = []
        for kind, value in node["a"]:
            if kind == "s":
                if value not in rename:
                    rename[value] = f"v{len(rename)}"
                value = rename[value]
            args.append([kind, value])
        canon_nodes.append([node["op"], node["w"], args])
    blob = json.dumps(
        [canon_nodes, doc["roots"]], separators=(",", ":"), sort_keys=True
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def deserialize_terms(doc: Dict) -> List:
    """Rebuild real (interned) terms from a serialized program; the
    constructors re-apply their canonicalizations, so the rebuilt set
    is semantically the captured set even across processes (and across
    the two packages: the JAX package's captures rebuild here)."""
    from mythril_tpu_torch.laser.smt import terms

    built: List = []

    def arg(spec):
        kind, value = spec
        return built[value] if kind == "t" else value

    for node in doc["nodes"]:
        op, w, raw = node["op"], node["w"], node["a"]
        a = [arg(s) for s in raw]
        if op == "const":
            t = terms.bv_const(a[0], w)
        elif op == "var":
            t = terms.bv_var(a[0], w)
        elif op == "bvar":
            t = terms.bool_var(a[0])
        elif op == "true":
            t = terms.TRUE
        elif op == "false":
            t = terms.FALSE
        elif op == "extract":
            t = terms.extract(a[0], a[1], a[2])
        elif op in ("zext", "sext"):
            t = getattr(terms, op)(a[0], a[1])
        elif op == "ite":
            t = terms.ite(a[0], a[1], a[2])
        elif op in ("band", "bor"):
            t = getattr(terms, op)(*a)
        elif op == "bnot":
            t = terms.bnot(a[0])
        elif op == "not":
            t = terms.bvnot(a[0])
        elif op in _BIN_OPS:
            t = _BIN_OPS[op](a[0], a[1])
        else:
            raise NotImplementedError(f"cannot rebuild op {op!r}")
        built.append(t)
    return [built[i] for i in doc["roots"]]


def _bin_ops():
    from mythril_tpu_torch.laser.smt import terms

    return {
        "add": terms.add, "sub": terms.sub, "mul": terms.mul,
        "udiv": terms.udiv, "urem": terms.urem, "sdiv": terms.sdiv,
        "srem": terms.srem, "and": terms.bvand, "or": terms.bvor,
        "xor": terms.bvxor, "shl": terms.shl, "lshr": terms.lshr,
        "ashr": terms.ashr, "concat": terms.concat, "eq": terms.eq,
        "ult": terms.ult, "ule": terms.ule, "slt": terms.slt,
        "sle": terms.sle, "bxor": terms.bxor,
    }


class _LazyBin(dict):
    def __missing__(self, key):
        self.update(_bin_ops())
        return dict.__getitem__(self, key)

    def __contains__(self, key):
        if not len(self):
            self.update(_bin_ops())
        return dict.__contains__(self, key)


_BIN_OPS = _LazyBin()


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def _bucket_info(lowered):
    """(shape-bucket key, compile-loss reason) of the query as the
    portfolio sees it — the bucket the replay lab groups engines by."""
    from mythril_tpu_torch.laser.smt.solver import portfolio

    prog, reason = portfolio.compile_program_ex(lowered)
    if prog is None:
        return None, reason
    return portfolio.bucket_key(prog), None


def capture_query(
    lowered,
    engine: str,
    verdict: str,
    wall_s: float = 0.0,
    hop: int = 0,
    loss_reason: Optional[str] = None,
    site: str = "",
    origin: Optional[str] = None,
    detail: Optional[Dict] = None,
) -> Optional[str]:
    """Serialize one solved query into the capture corpus (no-op when
    capture is off). `detail` is a small JSON-able dict attached to
    the observation (e.g. the actual sprint cap behind a
    SPRINT_PREEMPTED loss). Returns the artifact path, or None. Never
    raises: capture must never sink a query."""
    out_dir = _CAPTURE_DIR
    if out_dir is None or not lowered:
        # a fully-propagated (empty) query is a trivial sat — there is
        # nothing to replay
        return None
    try:
        doc = serialize_terms(lowered)
        sha = content_address(doc)
        observation = {
            "engine": engine,
            "verdict": verdict,
            "wall_s": round(float(wall_s), 6),
            "hop": int(hop),
            "loss_reason": loss_reason,
            "site": site,
        }
        if detail:
            observation["detail"] = dict(detail)
        path = os.path.join(out_dir, f"q-{sha}.json")
        with _CAPTURE_MU:
            if os.path.exists(path):
                with open(path) as fp:
                    artifact = json.load(fp)
            else:
                bucket, compile_loss = _bucket_info(lowered)
                artifact = {
                    "schema_version": ARTIFACT_SCHEMA_VERSION,
                    "kind": "mtpu-solver-query",
                    "sha": sha,
                    "origin": origin or current_origin(),
                    "n_constraints": len(doc["roots"]),
                    "n_nodes": len(doc["nodes"]),
                    "bucket": bucket,
                    "compile_loss": compile_loss,
                    "program": doc,
                    "observations": [],
                }
            obs = artifact["observations"]
            if len(obs) < MAX_OBSERVATIONS:
                obs.append(observation)
            else:
                obs[-1] = observation
            artifact["verdict"] = verdict
            artifact["loss_reason"] = loss_reason
            tmp = path + ".tmp"
            with open(tmp, "w") as fp:
                json.dump(artifact, fp, sort_keys=True)
            os.replace(tmp, path)
        _loss, captured = _metrics()
        captured.labels(origin=artifact["origin"]).inc()
        return path
    except Exception:
        log.debug("query capture failed", exc_info=True)
        return None


def load_corpus(
    corpus_dir: str,
    reason: Optional[str] = None,
    origin: Optional[str] = None,
) -> List[Dict]:
    """Load a captured corpus (sorted by content address), optionally
    filtered by last loss reason and/or query origin. A corpus either
    package captured loads here."""
    out: List[Dict] = []
    for name in sorted(os.listdir(corpus_dir)):
        if not (name.startswith("q-") and name.endswith(".json")):
            continue
        path = os.path.join(corpus_dir, name)
        try:
            with open(path) as fp:
                artifact = json.load(fp)
        except Exception:
            log.warning("unreadable capture artifact skipped: %s", path)
            continue
        if artifact.get("kind") != "mtpu-solver-query":
            continue
        if int(artifact.get("schema_version", 0)) > ARTIFACT_SCHEMA_VERSION:
            log.warning("artifact %s has a newer schema; skipped", name)
            continue
        if reason is not None and artifact.get("loss_reason") != reason:
            continue
        if origin is not None and artifact.get("origin") != origin:
            continue
        out.append(artifact)
    return out
