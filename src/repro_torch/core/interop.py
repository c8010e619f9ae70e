"""State carried across: build the port's objects from plain numpy arrays and
Python scalars.

Anything that holds the same data — another implementation of this simulator,
a file, a test — can hand its leaves over as ``np.asarray(...)`` and get the
port's ``Topology`` / ``Scenario`` / ``EngineConfig`` / ``TaskDag`` /
``DagEngineConfig`` / ``AdaptiveEngineConfig`` / ``GridRows`` back, so
that both sides compute on exactly the same inputs. Nothing here imports more
than numpy, torch and the port itself.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core import adaptive as ad
from repro_torch.core import dag as dg
from repro_torch.core import engine as eng
from repro_torch.core.dag_gen import TaskDag
from repro_torch.core.topology import Topology


def topology_from_arrays(cluster_id, hops, lam_local=1, lam_remote=1,
                         strategy=0, remote_prob=0.25,
                         name="one_cluster") -> Topology:
    return Topology(
        cluster_id=np.ascontiguousarray(cluster_id, dtype=np.int32),
        hops=np.ascontiguousarray(hops, dtype=np.int32),
        lam_local=int(lam_local), lam_remote=int(lam_remote),
        strategy=int(strategy), remote_prob=float(remote_prob),
        name=str(name))


def scenario_from_arrays(leaves: Mapping[str, np.ndarray],
                         device: eng.DeviceLike = None) -> eng.Scenario:
    """``leaves`` maps every field of :class:`Scenario` to a numpy array (or
    scalar). ``seed`` and ``remote_prob`` are read as uint32 bit patterns
    whatever integer type they arrive in."""
    dev = eng.resolve_device(device)
    missing = set(eng.Scenario._fields) - set(leaves)
    if missing:
        raise ValueError(f"scenario leaves missing: {sorted(missing)}")
    out = {}
    for name in eng.Scenario._fields:
        a = np.asarray(leaves[name])
        if name in ("seed", "remote_prob"):
            if a.dtype.kind not in "iu":
                raise TypeError(f"{name} must be an integer array, "
                                f"got {a.dtype}")
            out[name] = eng._u32(a, dev)
        else:
            out[name] = eng._i32(a, dev)
    return eng.Scenario(**out)


def engine_config_from_fields(topology: Topology, mwt=False,
                              max_events=1 << 20, log_trace=False,
                              max_trace=0) -> eng.EngineConfig:
    return eng.EngineConfig(topology=topology, mwt=bool(mwt),
                            max_events=int(max_events),
                            log_trace=bool(log_trace),
                            max_trace=int(max_trace))


def task_dag_from_arrays(dur, child_ptr, child_idx, pred_count,
                         name="dag") -> TaskDag:
    """A :class:`TaskDag` from its four CSR arrays (int32) and its name; the
    name enters the store key, so carry it across unchanged."""
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    dag = TaskDag(i32(dur), i32(child_ptr), i32(child_idx), i32(pred_count),
                  name=str(name))
    n = dag.n
    if dag.child_ptr.shape != (n + 1,) or dag.pred_count.shape != (n,) \
            or dag.child_idx.shape != (int(dag.child_ptr[-1]),):
        raise ValueError("task_dag_from_arrays: inconsistent CSR arrays")
    return dag


def dag_engine_config_from_fields(topology: Topology, dag: TaskDag,
                                  mwt=False, owner_lifo=True, deque_cap=None,
                                  max_events=1 << 20, log_trace=False,
                                  max_trace=0) -> dg.DagEngineConfig:
    return dg.DagEngineConfig(
        topology=topology, dag=dag, mwt=bool(mwt),
        owner_lifo=bool(owner_lifo),
        deque_cap=None if deque_cap is None else int(deque_cap),
        max_events=int(max_events), log_trace=bool(log_trace),
        max_trace=int(max_trace))


def adaptive_engine_config_from_fields(
        topology: Topology, mwt=False, merge_alpha=1, merge_beta_num=0,
        merge_beta_den=16, pool_cap=4096, deque_cap=256, max_events=1 << 20,
        log_trace=False, max_trace=0) -> ad.AdaptiveEngineConfig:
    return ad.AdaptiveEngineConfig(
        topology=topology, mwt=bool(mwt), merge_alpha=int(merge_alpha),
        merge_beta_num=int(merge_beta_num),
        merge_beta_den=int(merge_beta_den), pool_cap=int(pool_cap),
        deque_cap=int(deque_cap), max_events=int(max_events),
        log_trace=bool(log_trace), max_trace=int(max_trace))


def rows_from_arrays(W, lam_local, lam_remote, theta_static, theta_comm,
                     seed):
    """Canonical :class:`~repro_torch.core.sweep.GridRows` from six equally
    long arrays."""
    from repro_torch.core.sweep import GridRows
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    rows = GridRows(W=i32(W), lam_local=i32(lam_local),
                    lam_remote=i32(lam_remote),
                    theta_static=i32(theta_static),
                    theta_comm=i32(theta_comm),
                    seed=np.ascontiguousarray(seed).astype(np.uint32))
    if len({a.shape for a in rows}) != 1 or rows.W.ndim != 1:
        raise ValueError("rows_from_arrays needs six 1-d arrays of one length")
    return rows
