"""Host-level work-stealing scheduler — the paper's algorithm applied to the
serving/data plane of the framework (DESIGN.md §3).

Worker groups (e.g. model replicas on pod slices) each own a deque of work
items (requests / microbatches). An idle group steals following exactly the
paper's processor-engine semantics: victim selection per the topology
strategy, single-vs-multiple work transfer (SWT/MWT), steal threshold, and
communication delays taken from the fleet topology (``tpu_fleet`` maps pods
to clusters: intra-pod steals are cheap ICI moves, cross-pod steals pay DCN
latency). Deterministic (xorshift32) and simulation-backed: the planner
picks the policy by running the paper's simulator on the same topology.

This is an *event-driven host component* (plain Python): it models/drives
dispatch decisions; the actual tensor work happens in the steps it feeds.
The port's copy of the JAX package's scheduler, statement for statement, so
that its stats equal the reference's on the same topology and items.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import topology as topo_mod
from repro_torch.core.oracle import _select_victim as oracle_select_victim
from repro_torch.core.topology import Topology


@dataclasses.dataclass
class WorkItem:
    uid: int
    cost: float                 # estimated service time (e.g. prefill tokens)
    payload: object = None


@dataclasses.dataclass
class SchedulerStats:
    n_requests: int = 0
    n_success: int = 0
    n_fail: int = 0
    n_cross_cluster_steals: int = 0
    completed: int = 0
    makespan: float = 0.0
    idle_time: float = 0.0
    per_group_busy: Optional[np.ndarray] = None


class WorkStealingScheduler:
    """Discrete-time scheduler over ``p`` worker groups.

    ``run(until_empty=True)`` executes the queue to completion using the
    item cost model (for planning/tests); ``pop_local``/``steal`` can instead
    be driven live by a serving loop.
    """

    def __init__(self, topo: Topology, *, mwt: bool = False,
                 theta_static: int = 0, theta_comm: int = 0, seed: int = 1):
        self.topo = topo
        self.p = topo.p
        self.mwt = mwt
        self.theta_static = theta_static
        self.theta_comm = theta_comm
        self.queues: List[deque] = [deque() for _ in range(self.p)]
        self.rng = np.array([topo_mod.np_seed_state(seed, i)
                             for i in range(self.p)], np.uint32)
        self.rr = np.arange(self.p, dtype=np.int64)
        self.stats = SchedulerStats(per_group_busy=np.zeros(self.p))

    # ------------------------------------------------------------------
    def submit(self, group: int, item: WorkItem):
        self.queues[group].append(item)

    def queue_lengths(self) -> List[int]:
        return [len(q) for q in self.queues]

    def pop_local(self, i: int) -> Optional[WorkItem]:
        if self.queues[i]:
            return self.queues[i].pop()        # owner end (LIFO)
        return None

    def _select_victim(self, i: int) -> int:
        # the oracle's strategy implementation IS the paper's select_victim()
        v, rng, rr = oracle_select_victim(
            self.topo, self.topo.lam_local, self.topo.lam_remote,
            topo_mod.remote_prob_u32(self.topo.remote_prob),
            i, self.rng[i], self.rr[i])
        self.rng[i] = rng
        self.rr[i] = rr
        return int(v)

    def steal(self, thief: int) -> Tuple[Optional[WorkItem], int, int]:
        """One steal attempt. Returns (item | None, victim, delay)."""
        v = self._select_victim(thief)
        d = self.topo.distance(thief, v)
        self.stats.n_requests += 1
        qlen = len(self.queues[v])
        if qlen > self.theta_static + self.theta_comm * d:
            item = self.queues[v].popleft()    # steal end (oldest/largest)
            self.stats.n_success += 1
            if self.topo.cluster_id[thief] != self.topo.cluster_id[v]:
                self.stats.n_cross_cluster_steals += 1
            return item, v, d
        self.stats.n_fail += 1
        return None, v, d

    # ------------------------------------------------------------------
    def run(self, max_events: int = 1_000_000) -> SchedulerStats:
        """Event-driven execution to completion with the cost model
        (mirrors the paper's event engine; used by the planner and tests)."""
        t = 0.0
        # (ready_time, seq, group, kind) kinds: 0=try-work, 1=answer(item)
        heap: List[Tuple[float, int, int, int, Optional[WorkItem]]] = []
        seq = 0
        busy_until = np.zeros(self.p)
        for i in range(self.p):
            heapq.heappush(heap, (0.0, seq, i, 0, None))
            seq += 1
        remaining = sum(len(q) for q in self.queues)
        inflight = 0
        events = 0
        makespan = 0.0
        while heap and events < max_events:
            t, _, i, kind, carried = heapq.heappop(heap)
            events += 1
            if kind == 1 and carried is not None:
                # stolen item arrives: execute it
                self.stats.per_group_busy[i] += carried.cost
                self.stats.completed += 1
                inflight -= 1
                remaining -= 1
                makespan = max(makespan, t + carried.cost)
                heapq.heappush(heap, (t + carried.cost, seq, i, 0, None))
                seq += 1
                continue
            item = self.pop_local(i)
            if item is not None:
                self.stats.per_group_busy[i] += item.cost
                self.stats.completed += 1
                remaining -= 1
                makespan = max(makespan, t + item.cost)
                heapq.heappush(heap, (t + item.cost, seq, i, 0, None))
                seq += 1
                continue
            if remaining <= 0 and inflight <= 0:
                continue          # platform drained: worker retires
            stolen, v, d = self.steal(i)
            if stolen is not None:
                inflight += 1
                heapq.heappush(heap, (t + 2 * d, seq, i, 1, stolen))
            else:
                self.stats.idle_time += 2 * d
                heapq.heappush(heap, (t + 2 * d, seq, i, 0, None))
            seq += 1
        self.stats.makespan = makespan
        return self.stats


def straggler_rebalance(queue_lengths: List[float], topo: Topology,
                        threshold_ratio: float = 1.5) -> List[Tuple[int, int, int]]:
    """Data-plane straggler mitigation: propose (victim, thief, n_items)
    moves so no group exceeds ``threshold_ratio``× the mean load, preferring
    intra-cluster thieves (cheap ICI) before cross-cluster ones."""
    q = np.asarray(queue_lengths, float)
    mean = q.mean() if q.size else 0.0
    moves: List[Tuple[int, int, int]] = []
    if mean == 0:
        return moves
    order_over = np.argsort(-q)
    for v in order_over:
        if q[v] <= threshold_ratio * mean:
            break
        # nearest-first thieves: same cluster, then by distance
        cands = sorted(range(len(q)),
                       key=lambda j: (topo.distance(int(v), j), q[j]))
        for thief in cands:
            if thief == v or q[thief] >= mean:
                continue
            n = int(min(q[v] - mean, mean - q[thief]))
            if n >= 1:
                moves.append((int(v), int(thief), n))
                q[v] -= n
                q[thief] += n
            if q[v] <= threshold_ratio * mean:
                break
    return moves
