"""Port of ``core/adaptive.py`` and the adaptive body of the kernel: the
port's plain batched loop, oracle twin, oracle backend (with its cap guard)
and store-backed sweep against the JAX package's on the same numpy-made
inputs. Tolerance: none, on every leaf, dtypes included. The JAX side runs
on the CPU, its Pallas kernel in interpret mode."""
import json

import numpy as np
import pytest

from repro.core import adaptive as jad
from repro.core import oracle as jorc
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro.service import SimulationService as JaxService
from repro.service import store as jstore
from repro_torch.core import adaptive as pad
from repro_torch.core import backend as pbk
from repro_torch.core import oracle as porc
from repro_torch.core import sweep as psw
from repro_torch.core import topology as PT
from repro_torch.kernels import ref
from repro_torch.kernels.ws_sim import ws_sim_cuda
from repro_torch.service import SimulationService as PortService
from repro_torch.service import store as pstore
from test_torch_common import (STRATEGIES, assert_grids_equal,
                               assert_results_equal,
                               frozen_zip_clock,  # noqa: F401 (a fixture)
                               hold_port_against_jax, port_adaptive_config,
                               port_topology, seeded_scenario)

#: merge-duration settings of the strategy matrix: beta 0, beta 1/16, and a
#: negative denominator (floor division rounds toward minus infinity)
MERGES = (dict(merge_alpha=1, merge_beta_num=0),
          dict(merge_alpha=2, merge_beta_num=1),
          dict(merge_alpha=30, merge_beta_num=3, merge_beta_den=-5))


@pytest.mark.parametrize("mwt", [False, True], ids=["swt", "mwt"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_adaptive_matrix(strategy, mwt):
    """4 strategies x SWT/MWT; merge settings in turn; Pallas on half."""
    jt = JT.two_clusters(6, 9).with_strategy(strategy, remote_prob=0.3)
    merge = MERGES[(2 * strategy + mwt) % 3]
    cfg = jad.AdaptiveEngineConfig(topology=jt, mwt=mwt, max_events=1 << 14,
                                   **merge)
    scn = seeded_scenario(17 + strategy, 4, 2500, jt, theta=(2, 1),
                          remote_prob=0.3)
    got = hold_port_against_jax(cfg, scn, pallas=strategy % 2 == mwt)
    assert not got.overflow.any()
    np.testing.assert_array_equal(got.n_completed, got.n_created)
    np.testing.assert_array_equal(got.n_created, 1 + 2 * got.n_splits)
    np.testing.assert_array_equal(got.executed.sum(1),
                                  2500 + got.total_merge_work)


def test_adaptive_pool_exhaustion_budgets_and_trace_ring():
    """A pool that fills refuses further splits without an overflow; a
    one-slot deque never halts (a readied merge is popped in the event that
    pushed it); per-row budgets cut rows; the trace ring saturates."""
    jt = JT.one_cluster(5, 3)
    budgets = np.array([2**31 - 1, 0, 60, 2**31 - 1, 9], np.int32)
    cfg = jad.AdaptiveEngineConfig(topology=jt, pool_cap=9, deque_cap=1,
                                   merge_beta_num=1, max_events=1 << 14,
                                   log_trace=True, max_trace=40)
    scn = seeded_scenario(6, 5, 3000, jt, budgets=budgets)
    got = hold_port_against_jax(cfg, scn)
    full = [0, 3]
    assert not got.overflow[full].any()
    assert (got.n_created[full] == 9).all()          # 1 + 2 * 4 splits
    assert (got.n_completed[full] == 9).all()
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  [False, True, True, False, True])
    assert int(got.n_events[1]) == 0 and int(got.executed[1, 0]) == 3000
    assert int(got.n_trace.max()) == 40


def test_adaptive_trace_whole_run_and_single():
    jt = JT.two_clusters(4, 5)
    cfg = jad.AdaptiveEngineConfig(topology=jt, mwt=True, max_events=1 << 14,
                                   log_trace=True, max_trace=2048)
    got = hold_port_against_jax(cfg, seeded_scenario(3, 3, 1500, jt),
                                pallas=False)
    assert (got.n_trace <= got.n_events).all() and got.n_trace.min() > 0
    one = pad.simulate_adaptive(port_adaptive_config(cfg),
                                pad.eng.make_scenario(1500, 5, lam_local=1,
                                                      lam_remote=5,
                                                      device="cpu"))
    assert one.makespan.ndim == 0 and tuple(one.executed.shape) == (4,)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_adaptive_oracle_twin(strategy):
    """The port's copy of the numpy twin == the JAX package's == the
    port's plain loop, row by row, where no cap binds."""
    jt = JT.multi_cluster(2, 3, 7, 2, "ring").with_strategy(strategy, 0.3)
    pt = port_topology(jt)
    merge = MERGES[strategy % 3]
    seeds = np.random.default_rng(strategy).integers(0, 2**32, 3,
                                                     dtype=np.uint64)
    cfg = pad.AdaptiveEngineConfig(topology=pt, mwt=bool(strategy % 2),
                                   max_events=1 << 14, **merge)
    scn = pad.eng.batch_scenarios(2000, seeds, lam_local=2, lam_remote=7,
                                  theta_static=3, theta_comm=1,
                                  remote_prob=0.3, device="cpu")
    loop = pad.simulate_adaptive_batch(cfg, scn)
    for k, seed in enumerate(seeds):
        kw = dict(seed=int(seed), lam_local=2, lam_remote=7, theta_static=3,
                  theta_comm=1, mwt=bool(strategy % 2), remote_prob=0.3,
                  max_events=1 << 14, **merge)
        a = jorc.simulate_adaptive_oracle(jt, 2000, **kw)
        b = porc.simulate_adaptive_oracle(pt, 2000, **kw)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
            np.testing.assert_array_equal(
                np.asarray(b[f]), getattr(loop, f)[k].numpy(), err_msg=f)


def test_oracle_backend_adaptive_and_its_cap_guard():
    """Equal to the plain loop where no cap can bind — a deque of one slot
    included, which never binds; where one could, it raises instead of
    returning (and storing) a row."""
    pt = PT.one_cluster(4, 2)
    kw = dict(W_list=[800, 2000], lam_list=[2, 5], reps=2,
              task_model="adaptive", merge_beta_num=1, device="cpu")
    g_or = psw.run_grid(pt, backend="oracle", **kw)
    g_pt = psw.run_grid(pt, backend="torch", **kw)
    assert_grids_equal(g_or, g_pt)
    assert list(g_pt.extras) == ["n_events", "n_splits", "executed",
                                 "total_merge_work", "n_created",
                                 "n_completed", "lam_local"]
    assert int(g_pt.extras["n_created"].max()) < 64
    assert int(g_pt.extras["n_splits"].max()) > 1
    assert_grids_equal(psw.run_grid(pt, backend="oracle", deque_cap=1, **kw),
                       psw.run_grid(pt, backend="torch", deque_cap=1, **kw))
    with pytest.raises(ValueError, match="pool_cap"):
        psw.run_grid(pt, backend="oracle", pool_cap=9, **kw)
    with pytest.raises(ValueError, match="deque_cap"):
        psw.run_grid(pt, backend="oracle", deque_cap=0, **kw)


def test_make_model_and_resolve_model_match_the_reference():
    jt = JT.two_clusters(4, 7)
    kw = dict(W_list=[5000, 10**6], lam_list=[1, 7], pool_cap=1 << 13,
              merge_alpha=3, merge_beta_num=2, mwt=True)
    a = jsw.resolve_model(jt, "adaptive", **kw)
    b = psw.resolve_model(port_topology(jt), "adaptive", **kw)
    assert a.max_events == b.max_events and b.cfg.deque_cap == 256
    assert json.dumps(jstore.canonical_model(a), sort_keys=True) == \
        json.dumps(pstore.canonical_model(b), sort_keys=True)
    assert jstore.model_digest(a) == pstore.model_digest(b)
    assert isinstance(psw.as_model(b.cfg), pad.AdaptiveModel)


def test_adaptive_sweep_same_keys_same_bytes_shared_store(tmp_path,
                                                          frozen_zip_clock):
    """One adaptive question through both packages' SimulationService.sweep:
    same chunk keys, same npz bytes, and a store filled by the port is a
    hit for the JAX package."""
    jt = JT.one_cluster(6, 4)
    kw = dict(task_model="adaptive", W_list=[2000], lam_list=[4, 9], reps=3,
              chunk_size=4, merge_alpha=2, merge_beta_num=1, pool_cap=64)
    port = PortService(root=tmp_path / "port", device="cpu")
    g_port = port.sweep(port_topology(jt), backend="torch", **kw)
    g_jax = JaxService(root=tmp_path / "jax").sweep(jt, backend="jax", **kw)
    assert_grids_equal(g_jax, g_port)
    files = {d: {p.name: p.read_bytes()
                 for p in sorted((tmp_path / d).iterdir())}
             for d in ("jax", "port")}
    assert list(files["jax"]) == list(files["port"])
    assert sum(n.endswith(".npz") for n in files["jax"]) == 2
    for name, data in files["jax"].items():
        assert data == files["port"][name], name
    # the port's store serves the JAX package: nothing is simulated
    jax_be = pytest.importorskip("repro.core.backend").get_backend("jax")
    n = jax_be.n_run_rows
    reader = JaxService(root=tmp_path / "port")
    again = reader.sweep(jt, backend="jax", **kw)
    assert jax_be.n_run_rows == n and reader.store.hits_disk == 2
    assert_grids_equal(g_port, again)


def test_wrapper_on_cpu_tensors_and_its_checks():
    pt = PT.one_cluster(4, 2)
    cfg = pad.AdaptiveEngineConfig(topology=pt, merge_beta_num=1,
                                   max_events=1 << 12)
    scn = pad.eng.batch_scenarios(900, [1, 2, 3], lam=2, device="cpu")
    assert_results_equal(ref.ws_sim_ref(cfg, scn), ws_sim_cuda(cfg, scn))
    for bad in (dict(pool_cap=0), dict(deque_cap=0), dict(merge_beta_den=0)):
        with pytest.raises(ValueError):
            ws_sim_cuda(pad.AdaptiveEngineConfig(topology=pt, **bad), scn)
    assert pbk.get_backend("cuda").capabilities().max_p == 1024
