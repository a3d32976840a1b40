"""Solver layer of the port (reference: mythril/laser/smt/solver/__init__.py).

The host solver stack of the JAX package's laser/smt/solver: `lower`
(preprocess.py), the bit-blaster (bitblast.py) and the native CDCL
(native_sat.py, over the port's own native/host sources built by g++),
`Solver`/`Optimize`/`check_terms` (solver.py) with its race against the
card's portfolio (device_race.py, portfolio.py), `IndependenceSolver`,
the statistics, and query capture (capture.py).
"""

from mythril_tpu_torch.laser.smt.solver.independence_solver import IndependenceSolver
from mythril_tpu_torch.laser.smt.solver.solver import (
    BaseSolver,
    Optimize,
    Solver,
    check_terms,
    sat,
    unknown,
    unsat,
)
from mythril_tpu_torch.laser.smt.solver.solver_statistics import SolverStatistics

__all__ = [
    "BaseSolver",
    "Solver",
    "Optimize",
    "IndependenceSolver",
    "SolverStatistics",
    "check_terms",
    "sat",
    "unsat",
    "unknown",
]
