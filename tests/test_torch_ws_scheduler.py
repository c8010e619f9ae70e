"""The port's host scheduler (``repro_torch.sched.ws_scheduler``) against
the JAX package's: ``SchedulerStats`` field for field across victim
strategies × SWT/MWT × steal thresholds (one-processor clusters included,
whose victim corner both inherit from their oracles), the live
``pop_local``/``steal`` API step for step, and ``straggler_rebalance``'s
moves; plus the item-conservation property of
``tests/test_property.py::test_rebalance_conserves_items``."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import topology as JT
from repro.sched import ws_scheduler as jws
from repro_torch.sched import ws_scheduler as ws
from test_torch_common import port_topology

STRATEGIES = (JT.UNIFORM, JT.LOCAL_FIRST, JT.INV_DISTANCE, JT.ROUND_ROBIN)
FLEETS = {"fleet_2x4": lambda: JT.tpu_fleet(2, 4, ici_delay=1, dcn_delay=20),
          "ring_3x3": lambda: JT.multi_cluster(3, 3, 30, inter="ring"),
          "singletons_4x1": lambda: JT.tpu_fleet(4, 1, dcn_delay=7)}


def _stats_equal(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def _load(sched_mod, topo, seed, n_items=48, **kw):
    """A scheduler of ``sched_mod`` with the same items: most on group 0,
    the rest spread, costs from the numpy seed."""
    rng = np.random.default_rng(seed)
    s = sched_mod.WorkStealingScheduler(topo, seed=seed, **kw)
    for uid in range(n_items):
        group = 0 if rng.random() < 0.7 else int(rng.integers(topo.p))
        s.submit(group, sched_mod.WorkItem(uid=uid,
                                           cost=float(rng.integers(1, 90))))
    return s


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mwt", [False, True])
@pytest.mark.parametrize("theta", [(0, 0), (1, 0), (0, 1)])
def test_run_stats_equal_the_jax_packages(fleet, strategy, mwt, theta):
    jtopo = FLEETS[fleet]().with_strategy(strategy, remote_prob=0.3)
    kw = dict(mwt=mwt, theta_static=theta[0], theta_comm=theta[1])
    seed = 3 + strategy
    want = _load(jws, jtopo, seed, **kw).run()
    got = _load(ws, port_topology(jtopo), seed, **kw).run()
    _stats_equal(want, got)
    assert got.completed == 48


def test_the_live_api_step_for_step():
    """A serving loop's use: pop_local on the owner end, steal on the other,
    queue lengths after every call, in both packages."""
    jtopo = JT.tpu_fleet(2, 3, dcn_delay=15).with_strategy(JT.LOCAL_FIRST,
                                                           remote_prob=0.4)
    j = _load(jws, jtopo, 11, theta_comm=1)
    p = _load(ws, port_topology(jtopo), 11, theta_comm=1)
    rng = np.random.default_rng(5)
    for _ in range(60):
        g = int(rng.integers(jtopo.p))
        if rng.random() < 0.5:
            a, b = j.pop_local(g), p.pop_local(g)
            assert (a is None) == (b is None)
            assert a is None or (a.uid, a.cost) == (b.uid, b.cost)
        else:
            (ia, va, da), (ib, vb, db) = j.steal(g), p.steal(g)
            assert (va, da) == (vb, db)
            assert (ia is None) == (ib is None)
            assert ia is None or ia.uid == ib.uid
        assert j.queue_lengths() == p.queue_lengths()
    _stats_equal(j.stats, p.stats)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_straggler_rebalance_moves_equal_the_jax_packages(fleet):
    jtopo = FLEETS[fleet]()
    topo = port_topology(jtopo)
    rng = np.random.default_rng(17)
    for ratio in (1.2, 1.5, 3.0):
        for _ in range(20):
            q = rng.integers(0, 200, jtopo.p).astype(float)
            q[int(rng.integers(jtopo.p))] *= 4
            assert ws.straggler_rebalance(list(q), topo, ratio) == \
                jws.straggler_rebalance(list(q), jtopo, ratio)
    assert ws.straggler_rebalance([0.0] * jtopo.p, topo) == []


@settings(max_examples=25, deadline=None)
@given(q=st.lists(st.integers(0, 100), min_size=2, max_size=16))
def test_rebalance_conserves_items(q):
    topo = port_topology(JT.one_cluster(len(q), 2))
    before = sum(q)
    moves = ws.straggler_rebalance([float(x) for x in q], topo)
    assert moves == jws.straggler_rebalance([float(x) for x in q],
                                            JT.one_cluster(len(q), 2))
    q2 = list(q)
    for v, t, n in moves:
        assert n >= 1
        q2[v] -= n
        q2[t] += n
    assert sum(q2) == before
    assert all(x >= 0 for x in q2)
