"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Every parity test makes its inputs from a seed with numpy, hands the same
numpy leaves to the JAX package and — through ``repro_torch.core.interop`` —
to the port, and compares every field of the two results with
``assert_array_equal``: the tolerance is none.
"""
import contextlib
import dataclasses
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import dag as jdg
from repro.core import divisible as jdv
from repro.core import engine as jeng
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro.kernels.ws_sim import ws_sim_pallas
from repro_torch.core import engine as peng
from repro_torch.core import interop
from repro_torch.core import sweep as psw
from repro_torch.kernels.ws_sim import ws_sim_cuda


# The tensors here are tiny ([<=16, <=16]); one thread is fastest and keeps the
# test workers from fighting over cores.
torch.set_num_threads(1)


def port_topology(t):
    """The port's Topology from the arrays of the JAX package's."""
    return interop.topology_from_arrays(
        np.asarray(t.cluster_id), np.asarray(t.hops), t.lam_local,
        t.lam_remote, t.strategy, t.remote_prob, t.name)


def port_config(cfg):
    return interop.engine_config_from_fields(
        port_topology(cfg.topology), cfg.mwt, cfg.max_events, cfg.log_trace,
        cfg.max_trace)


def port_dag(d):
    """The port's TaskDag from the arrays and name of the JAX package's."""
    return interop.task_dag_from_arrays(
        np.asarray(d.dur), np.asarray(d.child_ptr), np.asarray(d.child_idx),
        np.asarray(d.pred_count), d.name)


def port_dag_config(cfg):
    return interop.dag_engine_config_from_fields(
        port_topology(cfg.topology), port_dag(cfg.dag), cfg.mwt,
        cfg.owner_lifo, cfg.deque_cap, cfg.max_events, cfg.log_trace,
        cfg.max_trace)


def port_adaptive_config(cfg):
    return interop.adaptive_engine_config_from_fields(
        port_topology(cfg.topology), cfg.mwt, cfg.merge_alpha,
        cfg.merge_beta_num, cfg.merge_beta_den, cfg.pool_cap, cfg.deque_cap,
        cfg.max_events, cfg.log_trace, cfg.max_trace)


def port_config_of(cfg):
    """The port's engine config for any of the JAX package's three."""
    if isinstance(cfg, jdg.DagEngineConfig):
        return port_dag_config(cfg)
    if isinstance(cfg, jad.AdaptiveEngineConfig):
        return port_adaptive_config(cfg)
    return port_config(cfg)


def port_scenario(scn):
    """The port's Scenario (CPU tensors) from a JAX Scenario's leaves."""
    return interop.scenario_from_arrays(
        {k: np.asarray(v) for k, v in scn._asdict().items()}, device="cpu")


def to_numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def assert_results_equal(expect, got, msg=""):
    """Every leaf of two result tuples, exactly, dtypes included."""
    assert type(expect)._fields == type(got)._fields, msg
    for f in expect._fields:
        a, b = to_numpy(getattr(expect, f)), to_numpy(getattr(got, f))
        assert a.dtype == b.dtype, f"{msg} {f}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")


def assert_grids_equal(a, b, msg=""):
    """Every column of two GridResults (either package's), exactly, dtypes
    and the order of ``extras`` included."""
    assert a.p == b.p, msg
    assert list(a.extras) == list(b.extras), msg
    for f in dataclasses.fields(a):
        if f.name in ("p", "extras"):
            continue
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f"{msg} {f.name}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f.name}")
    for k in a.extras:
        x, y = np.asarray(a.extras[k]), np.asarray(b.extras[k])
        assert x.dtype == y.dtype, f"{msg} extras[{k}]"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} extras[{k}]")


def hold_port_against_jax(cfg, scn, pallas=True):
    """The JAX engine (and, if ``pallas``, its Pallas kernel in interpret
    mode) against the port's plain loop and the port's kernel wrapper on CPU
    tensors, which must take the plain loop and launch nothing. Returns the
    port's result."""
    expect = jeng.simulate_batch(jsw.as_model(cfg), scn)
    pcfg, pscn = port_config_of(cfg), port_scenario(scn)
    got = peng.simulate_batch(psw.as_model(pcfg), pscn)
    assert_results_equal(expect, got, "engine")
    if pallas:
        assert_results_equal(ws_sim_pallas(cfg, scn, interpret=True), got,
                             "pallas")
    before = ws_sim_cuda.launches
    assert_results_equal(got, ws_sim_cuda(pcfg, pscn), "wrapper on CPU")
    assert ws_sim_cuda.launches == before
    return got


@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """An npz is a zip, and a zip member carries its time of writing (2 s
    resolution). Pin the clock zipfile reads so that two writes of the same
    arrays are the same bytes whenever they happen."""
    fixed = time.mktime((2020, 1, 1, 0, 0, 0, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: fixed, localtime=time.localtime))


def seeded_scenario(seed, n, W, topo, theta=(0, 0), remote_prob=0.25,
                    budgets=None):
    """A batched JAX Scenario whose row seeds come from ``seed`` via numpy."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return jdv.batch_scenarios(
        W, seeds, lam_local=topo.lam_local, lam_remote=topo.lam_remote,
        theta_static=theta[0], theta_comm=theta[1], remote_prob=remote_prob,
        max_events=budgets)


#: the two multi-cluster platforms of the strategy matrix
TOPOLOGIES = {
    "two_clusters": lambda: JT.two_clusters(6, 9),
    "ring": lambda: JT.multi_cluster(4, 3, 7, 2, "ring"),
}
STRATEGIES = (JT.UNIFORM, JT.LOCAL_FIRST, JT.INV_DISTANCE, JT.ROUND_ROBIN)


@contextlib.contextmanager
def cpu_mesh(shape=(1, 1), axes=("data", "model")):
    """A world of one ``gloo`` rank in this process and a mesh over it on
    the CPU; the process group is destroyed on the way out."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as pmesh
    pmesh.init_world("gloo", device="cpu")
    try:
        yield pmesh.make_test_mesh(shape, axes, device="cpu")
    finally:
        dist.destroy_process_group()
