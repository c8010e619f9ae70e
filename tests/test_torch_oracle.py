"""Port of ``core/oracle.py``: the port's numpy oracle against the JAX
package's oracle and against the port's plain batched loop. Exact."""
import numpy as np
import pytest

from repro.core import oracle as jorc
from repro.core import topology as JT
from repro_torch.core import divisible as pdv
from repro_torch.core import oracle as porc
from test_torch_common import STRATEGIES, TOPOLOGIES, port_topology

_FIELDS = ("makespan", "n_events", "n_requests", "n_success", "n_fail",
           "total_idle", "startup_end", "overflow")


def _row_kwargs(topo, seed, theta=(0, 0), mwt=False, max_events=1 << 16):
    return dict(seed=seed, lam_local=topo.lam_local,
                lam_remote=topo.lam_remote, theta_static=theta[0],
                theta_comm=theta[1], mwt=mwt, remote_prob=0.3,
                max_events=max_events)


@pytest.mark.parametrize("mwt", [False, True], ids=["swt", "mwt"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_oracle_matrix(topo_name, strategy, mwt):
    jt = TOPOLOGIES[topo_name]().with_strategy(strategy, remote_prob=0.3)
    pt = port_topology(jt)
    seeds = np.random.default_rng(strategy).integers(
        0, 2**32, size=4, dtype=np.uint64)
    W = 2500
    cfg = pdv.EngineConfig(topology=pt, mwt=mwt, max_events=1 << 16)
    scn = pdv.batch_scenarios(W, seeds, lam_local=pt.lam_local,
                              lam_remote=pt.lam_remote, theta_static=2,
                              theta_comm=1, remote_prob=0.3, device="cpu")
    loop = pdv.simulate_batch(cfg, scn)
    for k, seed in enumerate(seeds):
        kw = _row_kwargs(jt, int(seed), theta=(2, 1), mwt=mwt)
        a = jorc.simulate_oracle(jt, W, **kw)
        b = porc.simulate_oracle(pt, W, **kw)
        for f in _FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, k)
            assert getattr(b, f) == getattr(loop, f)[k].item(), (f, k)
        np.testing.assert_array_equal(a.executed, b.executed)
        np.testing.assert_array_equal(b.executed,
                                      loop.executed[k].numpy())


@pytest.mark.parametrize("budget", [0, 1, 37, 75, 76, 200])
def test_oracle_budget_truncation(budget):
    jt = JT.two_clusters(6, 9)
    pt = port_topology(jt)
    kw = _row_kwargs(jt, 5, max_events=budget)
    a = jorc.simulate_oracle(jt, 2000, **kw)
    b = porc.simulate_oracle(pt, 2000, **kw)
    cfg = pdv.EngineConfig(topology=pt, max_events=1 << 16)
    scn = pdv.batch_scenarios(2000, [5], lam_local=1, lam_remote=9,
                              remote_prob=0.3, max_events=budget,
                              device="cpu")
    loop = pdv.simulate_batch(cfg, scn)
    for f in _FIELDS:
        assert getattr(a, f) == getattr(b, f) == getattr(loop, f)[0].item(), f
    # the run ends of its own accord at its 76th event
    assert b.n_events == min(budget, 76) and b.overflow == (budget < 76)
    np.testing.assert_array_equal(b.executed, loop.executed[0].numpy())
