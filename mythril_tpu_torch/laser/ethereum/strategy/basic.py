"""The four basic scheduling policies.

Reference parity: mythril/laser/ethereum/strategy/basic.py:37-92 —
DFS (pop the newest), BFS (pop the oldest), uniform random, and
depth-weighted random (weight 1/(depth+1)).
"""

from __future__ import annotations

from random import choices, randrange

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy


class DepthFirstSearchStrategy(BasicSearchStrategy):
    """Follow one path to a leaf before backtracking."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    """Execute all states of one depth level before the next."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    """Uniform random draw from the worklist."""

    def get_strategic_global_state(self) -> GlobalState:
        if len(self.work_list) > 0:
            return self.work_list.pop(randrange(len(self.work_list)))
        raise IndexError


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Random draw weighted toward shallow states (1/(depth+1))."""

    def get_strategic_global_state(self) -> GlobalState:
        probability_distribution = [
            1 / (global_state.mstate.depth + 1) for global_state in self.work_list
        ]
        return self.work_list.pop(
            choices(range(len(self.work_list)), probability_distribution)[0]
        )
