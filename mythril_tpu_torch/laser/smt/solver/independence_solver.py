"""IndependenceSolver: partition constraints into independent buckets.

The port's copy of the JAX package's
laser/smt/solver/independence_solver.py.

Reference parity: mythril/laser/smt/solver/independence_solver.py:
87-153 with DependenceMap (:40-85). Constraints sharing no free
variables are solved as separate queries; any bucket unsat makes the
conjunction unsat, and on sat the bucket models merge (the buckets
share no symbols, so the union assignment is consistent).

No path of the port runs it: the JAX package keeps it for API parity
and calls it nowhere either (its support/model.py says why `get_model`
does not slice queries into buckets). The tests hold it to the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from mythril_tpu_torch.laser.smt import terms
from mythril_tpu_torch.laser.smt.model import Model
from mythril_tpu_torch.laser.smt.solver.solver import (
    BaseSolver,
    check_terms,
    sat,
    unknown,
    unsat,
)
from mythril_tpu_torch.laser.smt.solver.solver_statistics import stat_smt_query


class _Bucket:
    def __init__(self):
        self.variables: Set[str] = set()
        self.conditions: List[terms.Term] = []


class DependenceMap:
    """Union of constraint buckets keyed by shared free variables."""

    def __init__(self):
        self.buckets: List[_Bucket] = []
        self.variable_map: Dict[str, _Bucket] = {}

    def add_condition(self, condition: terms.Term) -> None:
        # dependence_symbols includes UF names: constraints sharing an
        # uninterpreted function (e.g. keccak) must land in one bucket
        # or functional consistency is lost across sub-queries.
        # Sorted: set iteration order follows string hash seeds, and
        # bucket-merge order must not vary across runs (bucket CONTENTS
        # are order-independent, but the bucket list order — and with
        # it solve order and session state — is not).
        names = sorted(terms.dependence_symbols(condition))
        touched: List[_Bucket] = []
        for name in names:
            b = self.variable_map.get(name)
            if b is not None and b not in touched:
                touched.append(b)
        if not touched:
            bucket = _Bucket()
        elif len(touched) == 1:
            bucket = touched[0]
        else:
            bucket = self._merge_buckets(touched)
        bucket.conditions.append(condition)
        bucket.variables.update(names)
        if bucket not in self.buckets:
            self.buckets.append(bucket)
        for name in names:
            self.variable_map[name] = bucket

    def _merge_buckets(self, to_merge: List[_Bucket]) -> _Bucket:
        out = _Bucket()
        for b in to_merge:
            out.variables |= b.variables
            out.conditions.extend(b.conditions)
            if b in self.buckets:
                self.buckets.remove(b)
        for name in out.variables:
            self.variable_map[name] = out
        return out


class IndependenceSolver(BaseSolver):
    """Solves a conjunction bucket-by-bucket."""

    @stat_smt_query
    def check(self, *extra) -> str:
        from mythril_tpu_torch.support import resilience

        self._model = None
        dep_map = DependenceMap()
        for c in self.constraints + self._norm(extra):
            dep_map.add_condition(c)
        merged: Dict = {}
        per_bucket_ms = max(
            500, self.timeout // max(1, len(dep_map.buckets))
        )
        deadline = resilience.run_deadline()
        worst = sat
        for i, bucket in enumerate(dep_map.buckets):
            if deadline is not None and deadline.expired:
                # remaining buckets degrade to unknown-with-reason: an
                # unsat verdict needs EVERY bucket's answer, and the
                # run has no wall left to earn them
                resilience.DegradationLog().record(
                    resilience.DegradationReason.SOLVER_TIMEOUT,
                    site="independence-solver",
                    detail=f"{len(dep_map.buckets) - i} bucket(s) unsolved "
                    "at run deadline",
                )
                return unknown
            status, model = check_terms(
                bucket.conditions, timeout_ms=per_bucket_ms, device=self.device
            )
            if status == unsat:
                return unsat
            if status != sat:
                worst = status
                continue
            merged.update(model.assignment)
        if worst == sat:
            self._model = Model(merged)
        return worst
