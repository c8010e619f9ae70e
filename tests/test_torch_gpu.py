"""The CUDA kernel on the card: every body of ``ws_sim.cu`` against its plain
version on the same CUDA tensors, every leaf ``torch.equal``.

A CUDA kernel has no interpret mode, so these tests carry the ``gpu`` marker
and skip where there is no CUDA device. This file imports the port alone (no
JAX, no JAX package), so that it runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import adaptive as pad
from repro_torch.core import dag as pdg
from repro_torch.core import dag_gen as pgen
from repro_torch.core import divisible as pdv
from repro_torch.core import topology as PT
from repro_torch.kernels import ref
from repro_torch.kernels.ws_sim import ws_sim_cuda

STRATEGIES = (PT.UNIFORM, PT.LOCAL_FIRST, PT.INV_DISTANCE, PT.ROUND_ROBIN)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")


def _launch_and_hold(cfg, scn, body, msg):
    before = dict(ws_sim_cuda.launches_by_body)
    total = ws_sim_cuda.launches
    got = ws_sim_cuda(cfg, scn)
    torch.cuda.synchronize()
    assert ws_sim_cuda.launches == total + 1
    assert ws_sim_cuda.launches_by_body[body] == before[body] + 1
    want = ref.ws_sim_ref(cfg, scn)
    assert type(got) is type(want)
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{msg}: {f}"
    return got


def _scenario(W, n=16, **kw):
    return pdv.batch_scenarios(W, np.arange(n) + 3, lam_local=2, lam_remote=7,
                               remote_prob=0.3, device="cuda", **kw)


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card():
    """The divisible body, four strategies, trace on."""
    _need_card()
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        cfg = pdv.EngineConfig(topology=topo, mwt=bool(strategy % 2),
                               max_events=1 << 16, log_trace=True,
                               max_trace=128)
        _launch_and_hold(cfg, _scenario(3000, theta_static=2, theta_comm=1),
                         "ws_sim_divisible", f"strategy={strategy}")


@pytest.mark.gpu
def test_dag_body_on_the_card():
    """The DAG body: LIFO and FIFO, a deque cap that halts rows, trace on."""
    _need_card()
    dagf = pgen.random_layered(6, 8, 0.4, seed=5)
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        for lifo, cap in ((True, None), (False, 12)):
            cfg = pdg.DagEngineConfig(topology=topo, dag=dagf, mwt=lifo,
                                      owner_lifo=lifo, deque_cap=cap,
                                      max_events=1 << 16, log_trace=True,
                                      max_trace=128)
            got = _launch_and_hold(cfg, _scenario(0), "ws_sim_dag",
                                   f"strategy={strategy} lifo={lifo}")
            if cap is None:
                assert (got.n_completed == dagf.n).all()


@pytest.mark.gpu
def test_adaptive_body_on_the_card():
    """The adaptive body: beta 1/16 and a negative denominator, a pool that
    fills, trace on."""
    _need_card()
    merges = (dict(merge_alpha=2, merge_beta_num=1),
              dict(merge_alpha=30, merge_beta_num=3, merge_beta_den=-5))
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        for merge, pool in zip(merges, (4096, 15)):
            cfg = pad.AdaptiveEngineConfig(topology=topo,
                                           mwt=bool(strategy % 2),
                                           pool_cap=pool, max_events=1 << 16,
                                           log_trace=True, max_trace=128,
                                           **merge)
            got = _launch_and_hold(
                cfg, _scenario(3000, theta_static=2, theta_comm=1),
                "ws_sim_adaptive", f"strategy={strategy} pool={pool}")
            assert (got.n_created <= pool).all() and not got.overflow.any()
