"""Topology engine.

Mirrors the paper's topology engine (§3.3): a topology defines where the
processors live, the communication time ``distance(i, j)`` between any two of
them, and the victim-selection strategy ``select_victim()``.

Representation is *structure / scalars separated* so that parameter sweeps can
batch over latency values without materializing a distance matrix per
scenario:

* ``cluster_id`` -- int32[p]    cluster membership (structure, static),
* ``hops``       -- int32[p, p] inter-cluster hop counts (structure, static),
* ``lam_local``  -- intra-cluster delay (scalar, sweepable),
* ``lam_remote`` -- per-hop inter-cluster delay (scalar, sweepable).

distance(i, j) = 0 if i == j
               = lam_local                    if same cluster
               = lam_remote * hops[i, j]      otherwise

Constructors cover the paper's families (Fig 1): one cluster, two clusters and
multi-cluster platforms linked in ``complete`` / ``ring`` / ``line`` / ``star``
inter-cluster networks, plus ``tpu_fleet`` which maps an accelerator fleet's
pods and data-centre network onto the two-level model.

Victim-selection strategies (paper §2.3):

* ``UNIFORM``      -- classical WS: uniform among the other p-1 processors.
* ``LOCAL_FIRST``  -- w.p. ``remote_prob`` steal uniformly outside the local
                      cluster, otherwise uniformly inside it.
* ``INV_DISTANCE`` -- categorical draw with P(j) proportional to 1/d(i, j).
* ``ROUND_ROBIN``  -- deterministic cyclic scan from the previous victim.

All randomness is an explicit xorshift32 PRNG so the batched PyTorch engine,
the CUDA kernel and the numpy oracle produce bit-identical traces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Victim-selection strategy ids (static python ints of the model config).
UNIFORM = 0
LOCAL_FIRST = 1
INV_DISTANCE = 2
ROUND_ROBIN = 3

_STRATEGY_NAMES = {
    UNIFORM: "uniform",
    LOCAL_FIRST: "local_first",
    INV_DISTANCE: "inv_distance",
    ROUND_ROBIN: "round_robin",
}


def strategy_name(sid: int) -> str:
    return _STRATEGY_NAMES[int(sid)]


# ---------------------------------------------------------------------------
# xorshift32: the shared PRNG (torch + np twins, bit-identical).
# ---------------------------------------------------------------------------

#: torch has no shifts on uint32, so uint32 values travel as int64 tensors
#: holding 0 .. 2**32-1, masked after every shift and multiply. A product
#: that exceeds 2**63 wraps in int64; its low 32 bits are still exact.
U32_MASK = 0xFFFFFFFF


def xorshift32(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step on int64 tensors holding uint32 values."""
    s = s ^ ((s << 13) & U32_MASK)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & U32_MASK)
    return s


def seed_state(seed: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-processor uint32 PRNG state from (scenario seed, proc id); int64
    tensors holding uint32 values in, the same out (broadcasting)."""
    x = (seed * 0x9E3779B9 + i * 0x85EBCA6B + 1) & U32_MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & U32_MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & U32_MASK
    x = x ^ (x >> 16)
    return x | 1  # xorshift32 state must be nonzero


def np_xorshift32(s) -> np.uint32:
    s = int(s) & 0xFFFFFFFF
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    return np.uint32(s)


def np_seed_state(seed: int, i: int) -> np.uint32:
    x = (int(seed) * 0x9E3779B9 + int(i) * 0x85EBCA6B + 1) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return np.uint32(x | 1)


# ---------------------------------------------------------------------------
# Topology container + constructors (paper §2.2, Fig 1).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Structure (cluster_id, hops) + default latency scalars + strategy.

    Hash/eq are content-based (array bytes included) so a Topology can key
    lru caches.
    """

    cluster_id: np.ndarray       # int32[p]
    hops: np.ndarray             # int32[p, p]; 0 on diag, >=1 across clusters
    lam_local: int = 1
    lam_remote: int = 1
    strategy: int = UNIFORM
    remote_prob: float = 0.25    # LOCAL_FIRST: P(steal outside own cluster)
    name: str = "one_cluster"

    def _key(self):
        return (np.asarray(self.cluster_id).tobytes(),
                np.asarray(self.hops).tobytes(),
                int(self.lam_local), int(self.lam_remote),
                int(self.strategy), round(float(self.remote_prob), 12),
                self.name)

    def __eq__(self, other):
        return isinstance(other, Topology) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    @property
    def p(self) -> int:
        return int(self.cluster_id.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_id.max()) + 1

    def with_strategy(self, strategy: int, remote_prob: Optional[float] = None) -> "Topology":
        return dataclasses.replace(
            self, strategy=strategy,
            remote_prob=self.remote_prob if remote_prob is None else remote_prob)

    def with_latency(self, lam_local: Optional[int] = None,
                     lam_remote: Optional[int] = None) -> "Topology":
        return dataclasses.replace(
            self,
            lam_local=self.lam_local if lam_local is None else int(lam_local),
            lam_remote=self.lam_remote if lam_remote is None else int(lam_remote))

    # -- paper API ---------------------------------------------------------
    def materialize(self, lam_local=None, lam_remote=None) -> np.ndarray:
        """Dense int32[p, p] distance matrix for given latency scalars."""
        ll = self.lam_local if lam_local is None else lam_local
        lr = self.lam_remote if lam_remote is None else lam_remote
        cid = np.asarray(self.cluster_id)
        same = cid[:, None] == cid[None, :]
        d = np.where(same, int(ll), int(lr) * np.asarray(self.hops)).astype(np.int32)
        np.fill_diagonal(d, 0)
        return d

    @property
    def dist(self) -> np.ndarray:
        return self.materialize()

    def distance(self, i: int, j: int) -> int:
        """Communication delay between processors i and j (paper §3.3)."""
        if i == j:
            return 0
        if self.cluster_id[i] == self.cluster_id[j]:
            return int(self.lam_local)
        return int(self.lam_remote) * int(self.hops[i, j])


def one_cluster(p: int, lam: int) -> Topology:
    """Fully-connected homogeneous cluster with constant latency ``lam``.

    Paper §2.2: communication modeled by a constant delay λ; shared-memory
    corresponds to λ = 1.
    """
    hops = np.ones((p, p), dtype=np.int32)
    np.fill_diagonal(hops, 0)
    return Topology(np.zeros((p,), np.int32), hops, lam_local=int(lam),
                    lam_remote=int(lam), name=f"one_cluster(lam={lam})")


def two_clusters(p: int, lam_remote: int, lam_local: int = 1,
                 split: Optional[int] = None) -> Topology:
    """Two shared-memory clusters joined by a slow interconnect (paper §2.2)."""
    split = p // 2 if split is None else split
    cid = np.zeros((p,), dtype=np.int32)
    cid[split:] = 1
    hops = np.where(cid[:, None] == cid[None, :], 0, 1).astype(np.int32)
    return Topology(cid, hops, lam_local=int(lam_local), lam_remote=int(lam_remote),
                    name=f"two_clusters(lam={lam_remote},local={lam_local})")


def multi_cluster(n_clusters: int, procs_per_cluster: int, lam_remote: int,
                  lam_local: int = 1, inter: str = "complete") -> Topology:
    """``n_clusters`` × ``procs_per_cluster`` platform; inter-cluster network is
    ``complete`` | ``ring`` | ``line`` | ``star`` (paper Fig 1).

    Inter-cluster delay = lam_remote × (#hops between the clusters).
    """
    cid = np.repeat(np.arange(n_clusters, dtype=np.int32), procs_per_cluster)
    chops = np.zeros((n_clusters, n_clusters), dtype=np.int32)
    for a in range(n_clusters):
        for b in range(n_clusters):
            if a == b:
                continue
            if inter == "complete":
                chops[a, b] = 1
            elif inter == "ring":
                fwd = (b - a) % n_clusters
                chops[a, b] = min(fwd, n_clusters - fwd)
            elif inter == "line":
                chops[a, b] = abs(a - b)
            elif inter == "star":
                chops[a, b] = 1 if (a == 0 or b == 0) else 2  # cluster 0 = hub
            else:
                raise ValueError(f"unknown inter-cluster topology {inter!r}")
    hops = chops[cid[:, None], cid[None, :]].astype(np.int32)
    return Topology(cid, hops, lam_local=int(lam_local), lam_remote=int(lam_remote),
                    name=f"multi_{inter}(k={n_clusters},m={procs_per_cluster},lam={lam_remote})")


def tpu_fleet(n_pods: int, chips_per_pod: int, ici_delay: int = 1,
              dcn_delay: int = 40, inter: str = "complete") -> Topology:
    """Map an accelerator fleet onto the paper's multi-cluster model: pods
    are shared-memory clusters (fast links), the data-centre network is the
    slow inter-cluster network."""
    return multi_cluster(n_pods, chips_per_pod, dcn_delay, ici_delay, inter)


# ---------------------------------------------------------------------------
# numpy victim-selection twin (used by the oracle in ref kernels / tests).
# ---------------------------------------------------------------------------

def np_uniform_other(rng, i: int, p: int):
    rng = np_xorshift32(rng)
    v = int(rng) % (p - 1)
    if v >= i:
        v += 1
    return v, rng


def remote_prob_u32(prob: float) -> int:
    """Fixed-point u32 threshold for P(remote) compares on raw draws."""
    return min(int(prob * float(2**32)), 2**32 - 1)
