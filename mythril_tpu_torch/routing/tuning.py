"""Continuous solver self-tuning: the second flywheel loop.

``solverlab tune --watch DIR`` runs here: watch an accumulating
``--capture-queries`` corpus, re-run the portfolio knob sweep
(solverlab.tune_corpus) whenever enough NEW queries landed, and — only
when the winner beats the committed defaults AND passes a 100%
host-replay agreement gate over the whole corpus — promote it as a
versioned, checksummed ``tuned-v<N>.json`` override artifact.  The
artifact carries plain ``PORTFOLIO_DEFAULTS`` override knobs that
``portfolio.install_tuned_defaults`` applies (in the port the knobs are
arguments of the search kernel, read at each dispatch, so a swap needs
no recompile); a corrupted or newer-schema artifact is refused with a
counted reason and the committed defaults stand.

The port's copy of the JAX package's routing/tuning.py: the same
artifacts, so either package installs the other's. The gate and the
watcher take a `device` (None: the card; "cpu" the plain versions of
the portfolio kernels) for the device replays."""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.routing.artifact import (
    ArtifactRefused,
    checksum_doc,
    count_refusal,
    verify_doc,
    _atomic_write,
)

log = logging.getLogger(__name__)

#: tuned-override artifact schema — readers refuse NEWER versions
TUNED_SCHEMA_VERSION = 1

_KIND = "mtpu-tuned"
_NAME_RE = re.compile(r"^tuned-v(\d+)\.json$")


def tuned_versions(directory: str) -> List[Tuple[int, str]]:
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


def save_tuned(
    directory: str,
    overrides: Dict,
    gate: Dict,
    version: Optional[int] = None,
) -> str:
    """Write the next tuned-override artifact; `gate` is the replay-
    agreement evidence that justified promotion (stored verbatim so a
    later reader can audit why these knobs shipped)."""
    from mythril_tpu_torch.laser.smt.solver.portfolio import PORTFOLIO_DEFAULTS

    unknown = set(overrides) - set(PORTFOLIO_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown portfolio knobs: {sorted(unknown)}")
    os.makedirs(directory, exist_ok=True)
    if version is None:
        versions = tuned_versions(directory)
        version = (versions[0][0] + 1) if versions else 1
    doc = {
        "schema_version": TUNED_SCHEMA_VERSION,
        "kind": _KIND,
        "version": int(version),
        "overrides": dict(overrides),
        "gate": dict(gate),
    }
    doc["checksum"] = checksum_doc(doc)
    path = os.path.join(directory, f"tuned-v{version}.json")
    _atomic_write(path, doc)
    return path


def load_tuned_file(path: str) -> Dict:
    """Verified tuned document or ArtifactRefused."""
    try:
        with open(path) as fp:
            doc = json.load(fp)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as exc:
        raise ArtifactRefused("junk", str(exc))
    m = _NAME_RE.match(os.path.basename(path))
    expect = int(m.group(1)) if m else None
    doc = verify_doc(
        doc, path, kind=_KIND, schema_version=TUNED_SCHEMA_VERSION,
        expect_version=expect,
    )
    overrides = doc.get("overrides")
    if not isinstance(overrides, dict) or not overrides:
        raise ArtifactRefused("junk", "no overrides")
    from mythril_tpu_torch.laser.smt.solver.portfolio import PORTFOLIO_DEFAULTS

    unknown = set(overrides) - set(PORTFOLIO_DEFAULTS)
    if unknown:
        raise ArtifactRefused(
            "unknown-knob", f"{sorted(unknown)} (a newer writer's knobs)"
        )
    return doc


def latest_tuned(directory: Optional[str]) -> Optional[Dict]:
    """Newest verifying tuned artifact, refusals counted + skipped."""
    if not directory:
        return None
    for _version, path in tuned_versions(directory):
        try:
            return load_tuned_file(path)
        except FileNotFoundError:
            continue
        except ArtifactRefused as exc:
            count_refusal(exc.reason, path, str(exc))
            continue
    return None


def maybe_install_tuned(directory: Optional[str]) -> Optional[int]:
    """Load the newest verifying tuned artifact from `directory` and
    install its overrides as the process PORTFOLIO_DEFAULTS. Returns
    the installed version, or None (committed defaults stand)."""
    doc = latest_tuned(directory)
    if doc is None:
        return None
    from mythril_tpu_torch.laser.smt.solver import portfolio

    portfolio.install_tuned_defaults(doc["overrides"], doc["version"])
    log.info(
        "installed tuned portfolio defaults v%s: %s",
        doc["version"], doc["overrides"],
    )
    return int(doc["version"])


# ---------------------------------------------------------------------------
# the replay-agreement promotion gate
# ---------------------------------------------------------------------------
def gate_overrides(
    corpus,
    overrides: Dict,
    timeout_ms: int = 10_000,
    candidates: int = 64,
    steps: int = 512,
    device=None,
) -> Dict:
    """The promotion gate: replay every captured query on the host
    CDCL (the ground truth) and on the device funnel UNDER the
    candidate overrides; any decided-vs-decided disagreement fails the
    gate. Incomplete device answers (unknown/unsupported) are honest —
    they cost wall, not soundness — so they don't block promotion;
    a flipped verdict does, unconditionally."""
    from mythril_tpu_torch.analysis import solverlab
    from mythril_tpu_torch.laser.smt.solver import portfolio
    from mythril_tpu_torch.observe import querylog

    agree = disagree = incomplete = 0
    failures: List[Dict] = []
    prev_capture = querylog.capture_dir()
    querylog.configure_capture(None)
    try:
        for art in corpus:
            try:
                lowered = solverlab._rebuild(art)
            except Exception:
                incomplete += 1
                continue
            host = solverlab._replay_host(lowered, timeout_ms)
            with portfolio.portfolio_overrides(**overrides):
                tuned, _loss = solverlab._replay_device(
                    lowered, candidates, steps, device=device
                )
            outcome = solverlab._classify(host, tuned)
            if outcome == "agree":
                agree += 1
            elif outcome == "disagree":
                disagree += 1
                if len(failures) < 16:
                    failures.append(
                        {"sha": art.get("sha"), "host": host, "tuned": tuned}
                    )
            else:
                incomplete += 1
    finally:
        querylog.configure_capture(prev_capture)
    total = agree + disagree + incomplete
    return {
        "queries": total,
        "agree": agree,
        "disagree": disagree,
        "incomplete": incomplete,
        "pass": total > 0 and disagree == 0,
        "failures": failures,
    }


# ---------------------------------------------------------------------------
# the watch loop: `solverlab tune --watch`
# ---------------------------------------------------------------------------
def tune_watch(
    corpus_dir: str,
    out_dir: str,
    interval_s: float = 30.0,
    min_new: int = 8,
    rounds: int = 0,
    trials: int = 12,
    sweep: str = "random",
    tune_seed: int = 1,
    candidates: int = 64,
    timeout_ms: int = 10_000,
    reason: Optional[str] = None,
    origin: Optional[str] = None,
    sleep=time.sleep,
    device=None,
) -> Dict:
    """Incremental retuning over an accumulating capture corpus.

    Each round: reload the corpus, and when at least `min_new` queries
    landed since the last sweep (the first round always runs), re-run
    the knob sweep; a winner that beats the committed defaults AND
    passes `gate_overrides` is promoted as the next tuned-v<N>
    artifact in `out_dir`. ``rounds=0`` watches forever;  a bounded
    `rounds` makes the loop testable (and the seed advances per sweep
    so a grown corpus explores fresh grid points)."""
    from mythril_tpu_torch.analysis import solverlab
    from mythril_tpu_torch.observe import querylog

    seen: set = set()
    history: List[Dict] = []
    promoted_path: Optional[str] = None
    sweeps = 0
    round_no = 0
    while True:
        round_no += 1
        corpus = querylog.load_corpus(corpus_dir, reason=reason, origin=origin)
        fresh = [a for a in corpus if a.get("sha") not in seen]
        row: Dict = {
            "round": round_no,
            "queries": len(corpus),
            "new": len(fresh),
        }
        ran = bool(corpus) and (not seen or len(fresh) >= max(1, min_new))
        if ran:
            seen.update(a.get("sha") for a in corpus)
            sweeps += 1
            report = solverlab.tune_corpus(
                corpus,
                trials=trials,
                sweep=sweep,
                seed=tune_seed + sweeps - 1,
                candidates=candidates,
                device=device,
            )
            row["beats_baseline"] = bool(report.get("beats_baseline"))
            row["best"] = report.get("best")
            if report.get("beats_baseline"):
                knobs = report["best"]["knobs"]
                gate = gate_overrides(
                    corpus, knobs,
                    timeout_ms=timeout_ms, candidates=candidates,
                    device=device,
                )
                row["gate"] = {
                    k: gate[k]
                    for k in ("queries", "agree", "disagree",
                              "incomplete", "pass")
                }
                if gate["pass"]:
                    promoted_path = save_tuned(out_dir, knobs, gate=row["gate"])
                    row["promoted"] = promoted_path
                    log.info("promoted tuned overrides -> %s", promoted_path)
                else:
                    log.warning(
                        "tuned winner FAILED the replay-agreement gate "
                        "(%d disagreements) — not promoted",
                        gate["disagree"],
                    )
        history.append(row)
        if rounds and round_no >= rounds:
            break
        sleep(interval_s)
    return {
        "mode": "tune-watch",
        "corpus_dir": corpus_dir,
        "out_dir": out_dir,
        "rounds": history,
        "sweeps": sweeps,
        "promoted": promoted_path,
    }
