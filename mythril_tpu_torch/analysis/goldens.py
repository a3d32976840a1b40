"""Canonical report shapes for golden-file comparison (the port's copy of
the JAX package's analysis/goldens.py).

The committed goldens (tests/testdata/goldens/*.issues.json) pin the
host engine's complete per-contract findings over the precompiled
fixture corpus; this module defines their canonical form (the full
issue list with every stable field, volatile values stripped,
transaction sequences reduced to their replay inputs) and the one
pinned configuration they were made with, run here through the port's
`analyze_corpus` host-only leg.

Where the port differs: the fixture directory is the
`MYTHRIL_REFERENCE_DIR` override, else the vendored in-repo copy (the
JAX package falls back to a reference checkout outside the repository
when the vendored copy is missing); `golden_corpus_run` takes `names`,
the fixture stems to run (None: all of them, as in the JAX package).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

#: generous per-contract walk budget for golden runs: every fixture
#: that can converge does; the ones that cannot are still pinned at
#: the exact-issue-set level
GOLDEN_EXECUTION_TIMEOUT = 120


def _fixture_dir() -> Path:
    """Explicit override -> the vendored in-repo copy."""
    override = os.environ.get("MYTHRIL_REFERENCE_DIR")
    if override:
        return Path(override) / "tests" / "testdata" / "inputs"
    return (
        Path(__file__).resolve().parents[2]
        / "tests" / "testdata" / "vendored" / "inputs"
    )


GOLDEN_FIXTURES = _fixture_dir()


def golden_corpus_run(
    names: Optional[Iterable[str]] = None,
) -> List[Tuple[str, Dict]]:
    """THE golden analysis: the JAX package's pinned configuration
    (transaction_count 2, GOLDEN_EXECUTION_TIMEOUT, create_timeout 10,
    host-only, deterministic solving, one process) through the port's
    analyze_corpus. Returns [(fixture stem, result dict)] in fixture
    order, for every fixture or for those stems in `names`."""
    from mythril_tpu_torch.analysis.corpus import analyze_corpus
    from mythril_tpu_torch.laser.smt.solver.solver import reset_blast_session
    from mythril_tpu_torch.support.model import clear_cache

    # hermetic: get_model's memo is process-global and keyed on
    # hash-consed term ids, so analyses run earlier in the same process
    # would otherwise answer this run's queries with verdicts cached
    # under their budgets: the goldens must not depend on test order
    clear_cache()
    reset_blast_session()
    files = sorted(GOLDEN_FIXTURES.glob("*.sol.o"))
    if names is not None:
        wanted = set(names)
        files = [f for f in files if f.stem in wanted]
    contracts = [(f.read_text().strip(), "", f.stem) for f in files]
    # deterministic solving: goldens are byte-compared, so every
    # marathon verdict must be a pure function of the query; scoped to
    # the call by analyze_corpus. The port walks in one process, so
    # `processes` is left at its default.
    results = analyze_corpus(
        contracts,
        transaction_count=2,
        execution_timeout=GOLDEN_EXECUTION_TIMEOUT,
        create_timeout=10,
        use_device=False,
        deterministic_solving=True,
    )
    return [(f.stem, r) for f, r in zip(files, results)]


def canonical_issues(issues: List[Dict]) -> List[Dict]:
    """Issue dicts (Issue.as_dict shape) -> deterministic golden rows.

    Transaction sequences are pinned by their model-independent
    structure (step count, each step's selector and calldata length),
    not the free argument bytes: those are one satisfying assignment
    among many. Everything else (addresses, swc ids, titles, severities,
    functions, full descriptions, gas bounds) is compared byte for
    byte."""
    rows = []
    for issue in issues:
        row = dict(issue)
        steps = ((row.pop("tx_sequence", None) or {}).get("steps")) or []
        row["tx_steps"] = [
            {
                "selector": (step.get("input") or "")[:10],
                "calldata_bytes": max(0, (len(step.get("input") or "0x") - 2) // 2),
            }
            for step in steps
        ]
        rows.append(row)
    rows.sort(key=lambda r: (r["address"], r["title"], str(r.get("function"))))
    return rows
