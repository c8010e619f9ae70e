"""Simulator-driven scheduling planner.

The paper's stated purpose — "compare different strategies that take
communication time and cluster's topology into account" — used as a runtime
component: map the physical fleet (pods, ICI/DCN delays) onto the paper's
multi-cluster model, sweep victim-selection strategies × steal thresholds ×
SWT/MWT in the simulator, and hand the best policy to the host scheduler.

Policy picks are *service queries*: every (strategy, MWT,
remote_prob) combination is one ``SimQuery`` whose grid carries all the θ
thresholds, so the broker coalesces the θ variants of a combination into
one batched dispatch (remote_prob is part of the broker's bucket key, so
rp variants dispatch separately), and a replanned fleet (same topology,
same workload) is answered entirely from the content-addressed store —
zero simulator dispatches, zero kernel launches.

The *pick itself* is a paired common-random-numbers query: after the sweep
ranks candidates by median makespan, the winner meets the baseline policy
(uniform stealing, no thresholds, SWT) in a head-to-head rematch on shared
seed streams, replicated until the CI on the per-seed makespan difference
excludes zero (or the rep budget runs out). The decision therefore carries
a *statistically defensible* verdict — gap, CI and significance — instead
of a point ranking that low-rep noise can flip.

The planner follows the device rule: its default service runs on the card
and raises without one; pass ``service=SimulationService(device="cpu")`` on
a host without CUDA.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import topology as topo_mod
from repro_torch.core.topology import Topology, tpu_fleet
from repro_torch.service.api import SimulationService
from repro_torch.service.estimator import PairedPolicy

#: Module-default service so repeated plans share one store/LRU.
_DEFAULT_SERVICE: Optional[SimulationService] = None


def default_service() -> SimulationService:
    """The module's shared service, on the card (``RuntimeError`` without
    one)."""
    global _DEFAULT_SERVICE
    if _DEFAULT_SERVICE is None:
        _DEFAULT_SERVICE = SimulationService()
    return _DEFAULT_SERVICE


@dataclasses.dataclass(frozen=True)
class PlannerDecision:
    strategy: int
    remote_prob: float
    theta_static: int
    theta_comm: int
    mwt: bool
    expected_makespan: float
    baseline_makespan: float        # uniform/no-threshold reference
    table: Tuple = ()               # full sweep results (for logging)
    n_dispatches: int = 0           # simulator programs this plan cost
    # Paired CRN verdict of the winner vs the baseline policy:
    delta_mean: float = 0.0         # E[Cmax_winner - Cmax_baseline]
    delta_half_width: float = float("inf")
    significant: bool = False       # CI on the difference excludes zero
    n_paired_reps: int = 0          # CRN seed pairs the verdict cost

    @property
    def strategy_name(self) -> str:
        return topo_mod.strategy_name(self.strategy)


def plan(
    topo: Topology,
    work_per_group: int,
    reps: int = 16,
    strategies: Tuple[int, ...] = (topo_mod.UNIFORM, topo_mod.LOCAL_FIRST,
                                   topo_mod.ROUND_ROBIN),
    remote_probs: Tuple[float, ...] = (0.1, 0.25, 0.5),
    thetas: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 2), (16, 0)),
    mwt_opts: Tuple[bool, ...] = (False, True),
    seed0: int = 7,
    service: Optional[SimulationService] = None,
    backend: Optional[str] = None,
) -> PlannerDecision:
    """Pick the policy minimizing median simulated makespan for a workload of
    ``work_per_group × p`` units starting concentrated (the paper's W).

    ``backend`` routes every sweep through a specific execution backend
    (None auto-selects by the service's device: ``cuda`` on the card,
    ``torch`` on the CPU); picks are backend-independent because backends
    are bit-identical."""
    svc = service if service is not None else default_service()
    W = work_per_group * topo.p
    lam_cell = (topo.lam_local, topo.lam_remote)

    queries = []
    combos: List[Tuple[int, bool, float]] = []
    for strat, mwt in itertools.product(strategies, mwt_opts):
        t = topo.with_strategy(strat)
        rps = remote_probs if strat == topo_mod.LOCAL_FIRST else (0.25,)
        for rp in rps:
            queries.append(svc.make_query(
                t, W_list=[W], lam_list=[lam_cell], theta=tuple(thetas),
                reps=reps, seed0=seed0, remote_prob=rp, mwt=mwt,
                backend=backend))
            combos.append((strat, mwt, rp))

    before = svc.n_dispatches
    results = svc.query_many(queries)

    rows: List[Tuple] = []
    best = None
    for (strat, mwt, rp), res in zip(combos, results):
        cells = res.cells
        for c in range(len(cells)):
            med = float(cells.median[c])
            if not np.isfinite(med):
                med = np.inf          # every rep overflowed
            ts, tc = int(cells.theta_static[c]), int(cells.theta_comm[c])
            rows.append((topo_mod.strategy_name(strat), mwt, ts, tc, rp, med))
            if best is None or med < best[0]:
                best = (med, strat, rp, ts, tc, mwt)
    baseline = next(r[5] for r in rows
                    if r[0] == "uniform" and not r[1] and r[2] == 0 and r[3] == 0)
    med, strat, rp, ts, tc, mwt = best

    # Head-to-head rematch under common random numbers: winner vs baseline,
    # one cell (the winning θ), replicated until the difference CI resolves.
    winner_q = svc.make_query(
        topo.with_strategy(strat), W_list=[W], lam_list=[lam_cell],
        theta=((ts, tc),), seed0=seed0 + 1, remote_prob=rp, mwt=mwt,
        backend=backend)
    base_q = svc.make_query(
        topo.with_strategy(topo_mod.UNIFORM), W_list=[W],
        lam_list=[lam_cell], theta=((0, 0),), seed0=seed0 + 1,
        remote_prob=0.25, mwt=False, backend=backend)
    pres = svc.query_pair(winner_q, base_q, policy=PairedPolicy(
        batch_reps=max(reps // 2, 4), min_reps=max(reps // 2, 4),
        max_reps=max(16 * reps, 64)))
    pc = pres.paired
    return PlannerDecision(
        strategy=strat, remote_prob=rp, theta_static=ts, theta_comm=tc,
        mwt=mwt, expected_makespan=med, baseline_makespan=baseline,
        table=tuple(rows), n_dispatches=svc.n_dispatches - before,
        delta_mean=float(pc.delta_mean[0]),
        delta_half_width=float(pc.delta_half_width[0]),
        significant=bool(pc.significant[0]),
        n_paired_reps=int(pc.n[0]))


def plan_for_mesh(n_pods: int, chips_per_pod: int, *, ici_delay: int = 1,
                  dcn_delay: int = 40, work_per_group: int = 4096,
                  groups_per_pod: Optional[int] = None,
                  reps: int = 16,
                  service: Optional[SimulationService] = None,
                  backend: Optional[str] = None) -> PlannerDecision:
    """Convenience: physical fleet -> topology -> policy.

    ``groups_per_pod`` defaults to chips_per_pod//8 (one group per 8-chip
    slice), keeping the simulated p realistic for serving replicas.
    """
    g = groups_per_pod or max(chips_per_pod // 8, 1)
    topo = tpu_fleet(n_pods, g, ici_delay=ici_delay, dcn_delay=dcn_delay)
    return plan(topo, work_per_group, reps=reps, service=service,
                backend=backend)
