"""Port of ``core/engine.py`` + ``core/divisible.py``: the plain batched
PyTorch loop on the CPU against ``repro.core.engine.simulate_batch`` on the
same numpy-made inputs. Tolerance: none, on every leaf of ``SimResult``."""
import numpy as np
import pytest

from repro.core import divisible as jdv
from repro.core import topology as JT
from repro_torch.core import divisible as pdv
from repro_torch.core import engine as peng
from test_torch_common import (STRATEGIES, TOPOLOGIES, assert_results_equal,
                               port_config, port_scenario, seeded_scenario)


def _both(cfg, scn):
    expect = jdv.simulate_batch(cfg, scn)
    got = pdv.simulate_batch(port_config(cfg), port_scenario(scn))
    return expect, got


@pytest.mark.parametrize("mwt", [False, True], ids=["swt", "mwt"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_strategy_matrix(topo_name, strategy, mwt):
    topo = TOPOLOGIES[topo_name]().with_strategy(strategy, remote_prob=0.3)
    cfg = jdv.EngineConfig(topology=topo, mwt=mwt, max_events=1 << 16)
    scn = seeded_scenario(11 + strategy, 8, 3000, topo, remote_prob=0.3)
    expect, got = _both(cfg, scn)
    assert_results_equal(expect, got, f"{topo.name} s={strategy} mwt={mwt}")
    assert not np.asarray(expect.overflow).any()
    assert (got.executed.sum(1) == 3000).all()


@pytest.mark.parametrize("theta", [(3, 1), (40, 0), (0, 7)])
def test_steal_thresholds(theta):
    topo = JT.two_clusters(6, 9)
    cfg = jdv.EngineConfig(topology=topo, mwt=False, max_events=1 << 16)
    scn = seeded_scenario(5, 8, 4000, topo, theta=theta)
    assert_results_equal(*_both(cfg, scn), msg=f"theta={theta}")


def test_per_row_budgets_overflow_and_zero():
    """A row stops at min(model cap, its own budget) and then changes in no
    leaf; a budget-0 row executes nothing at all."""
    topo = JT.two_clusters(6, 9).with_strategy(JT.LOCAL_FIRST, 0.3)
    cfg = jdv.EngineConfig(topology=topo, mwt=False, max_events=60)
    budgets = np.array([2**31 - 1, 50, 0, 7, 100, 1, 59, 61], np.int32)
    scn = seeded_scenario(9, 8, 2000, topo, remote_prob=0.3, budgets=budgets)
    expect, got = _both(cfg, scn)
    assert_results_equal(expect, got)
    n_events = got.n_events.numpy()
    np.testing.assert_array_equal(n_events, np.minimum(budgets, 60))
    assert got.overflow.numpy().all()
    # the budget-0 row: nothing executed, all work still on processor 0
    assert int(got.makespan[2]) == -1 and int(got.executed[2, 0]) == 2000
    assert int(got.executed[2].sum()) == 2000


@pytest.mark.parametrize("max_trace", [48, 4096])
def test_trace_ring(max_trace):
    """``trace``/``n_trace``: rows stop at max_trace and n_trace saturates
    (48), or the whole run fits (4096)."""
    topo = JT.two_clusters(6, 9)
    cfg = jdv.EngineConfig(topology=topo, mwt=True, max_events=1 << 16,
                           log_trace=True, max_trace=max_trace)
    scn = seeded_scenario(2, 4, 1500, topo)
    expect, got = _both(cfg, scn)
    assert_results_equal(expect, got)
    assert tuple(got.trace.shape) == (4, max_trace, 4)
    if max_trace == 48:
        assert (got.n_trace == 48).all()
    else:
        np.testing.assert_array_equal(got.n_trace.numpy(),
                                      got.n_events.numpy())


def test_trace_disabled_shape():
    topo = JT.one_cluster(4, 3)
    cfg = jdv.EngineConfig(topology=topo, max_events=1 << 14)
    expect, got = _both(cfg, seeded_scenario(1, 3, 500, topo))
    assert_results_equal(expect, got)
    assert tuple(got.trace.shape) == (3, 1, 4) and not got.trace.any()


def test_single_simulation_and_make_scenario():
    topo = JT.one_cluster(8, 5)
    cfg = jdv.EngineConfig(topology=topo, mwt=True, max_events=1 << 14)
    expect = jdv.simulate(cfg, jdv.make_scenario(5000, 77, lam=5))
    got = pdv.simulate(port_config(cfg),
                       pdv.make_scenario(5000, 77, lam=5, device="cpu"))
    assert_results_equal(expect, got)
    assert got.makespan.ndim == 0 and tuple(got.executed.shape) == (8,)


def test_batch_scenarios_leaves_match():
    a = jdv.batch_scenarios(1000, np.arange(5, dtype=np.uint32) + 2**31,
                            lam_local=2, lam_remote=9, theta_static=3,
                            remote_prob=0.3, max_events=np.arange(5))
    b = pdv.batch_scenarios(1000, np.arange(5, dtype=np.uint32) + 2**31,
                            lam_local=2, lam_remote=9, theta_static=3,
                            remote_prob=0.3, max_events=np.arange(5),
                            device="cpu")
    for f in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)).astype(np.int64),
            getattr(b, f).numpy().astype(np.int64), err_msg=f)


def test_engine_version_and_constants():
    from repro.core import engine as jeng
    assert peng.ENGINE_VERSION == jeng.ENGINE_VERSION == 2
    assert int(peng.INF32) == int(jeng.INF32)
    for name in ("ACTIVE", "REQ_FLIGHT", "ANS_FLIGHT", "EV_IDLE",
                 "EV_REQ_FAIL", "EV_REQ_OK", "EV_ANS_FAIL", "EV_ANS_OK"):
        assert getattr(peng, name) == getattr(jeng, name)
    assert pdv.default_max_events(10**6, 256, 2) == \
        jdv.default_max_events(10**6, 256, 2)


def test_inv_distance_batch_split_is_invisible(monkeypatch):
    """INV_DISTANCE batches are split to bound the prefix-sum table; the
    split must not show in the result."""
    topo = JT.multi_cluster(4, 3, 7, 2, "ring").with_strategy(JT.INV_DISTANCE)
    cfg = jdv.EngineConfig(topology=topo, max_events=1 << 16)
    scn = seeded_scenario(4, 7, 2500, topo)
    whole = pdv.simulate_batch(port_config(cfg), port_scenario(scn))
    monkeypatch.setattr(peng, "_INV_TABLE_MAX_ELEMS", 3 * 12 * 12)
    split = pdv.simulate_batch(port_config(cfg), port_scenario(scn))
    assert_results_equal(whole, split)
    assert_results_equal(jdv.simulate_batch(cfg, scn), split)
