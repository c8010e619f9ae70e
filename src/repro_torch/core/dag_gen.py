"""Task-engine application generators (paper §3.2).

The paper's task engine "offers different functions that automatically
generate different applications based on DAG tasks" and accepts predefined
applications in JSON. A DAG here is a static single-source structure:

* ``dur``      -- int32[n] task processing times,
* ``parents``  -- CSR of predecessor counts (only the count is needed),
* ``children`` -- CSR (ptr, idx) of activation edges.

Generators: binary fork trees, fork-join diamonds, merge sort (Fig 9),
random layered DAGs and chains. All return a :class:`TaskDag`.

Plain numpy, identical to the JAX package's generators array for array and
name for name: a DAG's arrays and its ``name`` enter the content address of
the result store, so both packages must build the same bytes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class TaskDag:
    dur: np.ndarray         # int32[n]
    child_ptr: np.ndarray   # int32[n+1]
    child_idx: np.ndarray   # int32[E]
    pred_count: np.ndarray  # int32[n]
    name: str = "dag"

    @property
    def n(self) -> int:
        return int(self.dur.shape[0])

    @property
    def total_work(self) -> int:
        return int(self.dur.sum())

    def _key(self):
        return (self.dur.tobytes(), self.child_ptr.tobytes(),
                self.child_idx.tobytes(), self.name)

    def __eq__(self, other):
        return isinstance(other, TaskDag) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    @property
    def sources(self) -> np.ndarray:
        return np.nonzero(self.pred_count == 0)[0]

    def critical_path(self) -> int:
        """Longest path length (sum of durations) — the D of the WS bound."""
        n = self.n
        finish = np.zeros(n, np.int64)
        indeg = self.pred_count.astype(np.int64).copy()
        order: List[int] = list(np.nonzero(indeg == 0)[0])
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            fu = finish[u] + int(self.dur[u])
            finish[u] = fu
            for k in range(self.child_ptr[u], self.child_ptr[u + 1]):
                v = int(self.child_idx[k])
                finish[v] = max(finish[v], fu)
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        assert head == n, "DAG has a cycle or unreachable tasks"
        return int(finish.max() + 0)

    def heights(self) -> np.ndarray:
        """Height = length (in tasks) of the longest path to a sink (paper §2.1.2)."""
        n = self.n
        h = np.zeros(n, np.int64)
        outdeg = np.diff(self.child_ptr).astype(np.int64)
        # reverse topological pass
        parents: List[List[int]] = [[] for _ in range(n)]
        for u in range(n):
            for k in range(self.child_ptr[u], self.child_ptr[u + 1]):
                parents[int(self.child_idx[k])].append(u)
        order: List[int] = list(np.nonzero(outdeg == 0)[0])
        head = 0
        remaining = outdeg.copy()
        while head < len(order):
            v = order[head]
            head += 1
            for u in parents[v]:
                h[u] = max(h[u], h[v] + 1)
                remaining[u] -= 1
                if remaining[u] == 0:
                    order.append(u)
        return h


def _build(dur: Sequence[int], edges: Sequence[Tuple[int, int]], name: str) -> TaskDag:
    n = len(dur)
    dur = np.asarray(dur, np.int32)
    pred = np.zeros(n, np.int32)
    buckets: List[List[int]] = [[] for _ in range(n)]
    for u, v in edges:
        buckets[u].append(v)
        pred[v] += 1
    ptr = np.zeros(n + 1, np.int32)
    for u in range(n):
        ptr[u + 1] = ptr[u] + len(buckets[u])
    idx = np.zeros(int(ptr[-1]), np.int32)
    for u in range(n):
        idx[ptr[u]:ptr[u + 1]] = buckets[u]
    return TaskDag(dur, ptr, idx, pred, name=name)


def chain(n: int, dur: int = 1) -> TaskDag:
    edges = [(i, i + 1) for i in range(n - 1)]
    return _build([dur] * n, edges, f"chain({n})")


def binary_tree(depth: int, dur: int = 1) -> TaskDag:
    """Out-tree of 2^depth−1 unit tasks; task i activates 2i+1, 2i+2."""
    n = 2**depth - 1
    edges = []
    for i in range(n):
        for c in (2 * i + 1, 2 * i + 2):
            if c < n:
                edges.append((i, c))
    return _build([dur] * n, edges, f"binary_tree(d={depth})")


def fork_join(depth: int, dur: int = 1) -> TaskDag:
    """Binary fork tree + mirrored join tree (diamond), 2^(d+1)-2+1 tasks."""
    nf = 2**depth - 1  # fork nodes
    leaves = 2**(depth - 1)
    # join tree mirrors fork tree minus the leaf level (joins for inner nodes)
    nj = 2**(depth - 1) - 1
    n = nf + nj
    edges = []
    for i in range(nf):
        for c in (2 * i + 1, 2 * i + 2):
            if c < nf:
                edges.append((i, c))
    # leaf fork node L(i) feeds the join of its parent; join j mirrors fork j
    def join_id(fork_i: int) -> int:
        return nf + fork_i
    first_leaf = nf - leaves
    for i in range(first_leaf, nf):
        parent = (i - 1) // 2
        edges.append((i, join_id(parent)))
    for j in range(nj - 1, 0, -1):  # join of node j feeds join of parent(j)
        edges.append((join_id(j), join_id((j - 1) // 2)))
    return _build([dur] * n, edges, f"fork_join(d={depth})")


def merge_sort(n_elems: int, cutoff: int = 16, split_dur: int = 1) -> TaskDag:
    """Merge-sort DAG (paper Fig 9): split tasks fan out, sorted-leaf tasks,
    merge tasks fan in with dur proportional to merged size."""
    dur: List[int] = []
    edges: List[Tuple[int, int]] = []

    def leaf_cost(m: int) -> int:
        return max(int(m * max(np.log2(max(m, 2)), 1.0) / 4), 1)

    def rec(m: int, parent: Optional[int]) -> int:
        """Returns the task id producing the sorted run of size m."""
        if m <= cutoff:
            tid = len(dur)
            dur.append(leaf_cost(m))
            if parent is not None:
                edges.append((parent, tid))
            return tid
        split = len(dur)
        dur.append(split_dur)
        if parent is not None:
            edges.append((parent, split))
        left = rec(m // 2, split)
        right = rec(m - m // 2, split)
        merge = len(dur)
        dur.append(max(m // 2, 1))
        edges.append((left, merge))
        edges.append((right, merge))
        return merge

    rec(n_elems, None)
    return _build(dur, edges, f"merge_sort(n={n_elems},cutoff={cutoff})")


def random_layered(n_layers: int, width: int, p_edge: float = 0.3,
                   dur_range: Tuple[int, int] = (1, 10), seed: int = 0) -> TaskDag:
    """Random layered DAG with a single source; every task reachable."""
    rng = np.random.default_rng(seed)
    n = 1 + n_layers * width
    dur = rng.integers(dur_range[0], dur_range[1] + 1, size=n).astype(np.int32)
    edges: List[Tuple[int, int]] = []
    prev = [0]
    tid = 1
    for _ in range(n_layers):
        layer = list(range(tid, tid + width))
        tid += width
        for v in layer:
            # at least one parent from the previous layer
            parents = [int(u) for u in prev if rng.random() < p_edge]
            if not parents:
                parents = [int(prev[int(rng.integers(len(prev)))])]
            for u in parents:
                edges.append((u, v))
        prev = layer
    return _build(dur.tolist(), edges, f"random_layered({n_layers}x{width},s={seed})")


# ---------------------------------------------------------------------------
# JSON I/O (paper §3.2: "predefined application ... described in JSON").
# ---------------------------------------------------------------------------

def to_json(dag: TaskDag, schedule: Optional[dict] = None) -> str:
    tasks = []
    for u in range(dag.n):
        t = {"id": u, "work": int(dag.dur[u]),
             "children": [int(c) for c in
                          dag.child_idx[dag.child_ptr[u]:dag.child_ptr[u + 1]]]}
        if schedule is not None:
            t.update(schedule.get(u, {}))
        tasks.append(t)
    return json.dumps({"name": dag.name, "tasks": tasks}, indent=1)


def from_json(text: str) -> TaskDag:
    doc = json.loads(text)
    tasks = doc["tasks"]
    n = len(tasks)
    dur = [0] * n
    edges: List[Tuple[int, int]] = []
    for t in tasks:
        dur[int(t["id"])] = int(t["work"])
        for c in t.get("children", []):
            edges.append((int(t["id"]), int(c)))
    return _build(dur, edges, doc.get("name", "json"))
