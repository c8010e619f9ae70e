"""The paper's own experiment configurations (§4.1.1).

"Each simulation is fully described by three parameters (W, p, λ). For our
tests, we vary the number of unit tasks W between 1e5 and 1e8, the number of
processors p between 32 and 256 and the latency λ between 2 and 500. Each
experimental setting has been reproduced 1000 times."

``grid(full=True)`` is the paper-scale grid; the default is the CI-scale
sub-grid used by benchmarks (same code path, fewer reps).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PaperGrid:
    W_list: Tuple[int, ...]
    p_list: Tuple[int, ...]
    lam_list: Tuple[int, ...]
    reps: int

    def cells(self):
        for p in self.p_list:
            for W in self.W_list:
                for lam in self.lam_list:
                    yield (W, p, lam)


def grid(full: bool = False) -> PaperGrid:
    if full:
        return PaperGrid(
            W_list=(10**5, 10**6, 10**7, 10**8),
            p_list=(32, 64, 128, 256),
            lam_list=(2, 62, 122, 262, 382, 482),
            reps=1000,
        )
    return PaperGrid(
        W_list=(10**5, 10**6, 10**7),
        p_list=(32, 64, 128),
        lam_list=(2, 62, 262, 482),
        reps=16,
    )


# Multi-cluster scenarios (paper §1.1/§2.2: the environment the simulator was
# built to analyze — clusters of shared-memory processors over a slow
# interconnect). Used by benchmarks/paper_torch.py::multicluster.
MULTICLUSTER_SCENARIOS = (
    # (n_clusters, procs_per_cluster, lam_remote, inter-topology)
    (2, 16, 50, "complete"),
    (2, 16, 200, "complete"),
    (4, 8, 50, "complete"),
    (4, 8, 50, "ring"),
    (4, 8, 50, "star"),
    (8, 4, 100, "ring"),
)
