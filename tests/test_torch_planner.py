"""The planner (``repro_torch.sched.planner``) against the JAX package's
(``repro.sched.planner``): the same fleet and workload give the same
decision — strategy, thresholds, MWT, the whole table, the paired verdict —
and the same number of dispatches; a replanned fleet costs no dispatch."""
import dataclasses

from repro.core import topology as JT
from repro.sched import planner as jplanner
from repro.service import SimulationService as JaxService
from repro_torch.sched import PlannerDecision, plan, plan_for_mesh
from repro_torch.service import SimulationService as PortService
from test_torch_common import port_topology


def _services(tmp_path):
    return (JaxService(root=tmp_path / "jax"),
            PortService(root=tmp_path / "port", device="cpu"))


def _same_decision(j, p):
    assert isinstance(p, PlannerDecision)
    for f in dataclasses.fields(j):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.strategy_name == j.strategy_name


def test_plan_for_mesh_two_pods(tmp_path):
    js, ps = _services(tmp_path)
    kw = dict(dcn_delay=200, work_per_group=512, reps=8)
    jd = jplanner.plan_for_mesh(2, 32, service=js, **kw)
    pd = plan_for_mesh(2, 32, service=ps, **kw)
    _same_decision(jd, pd)
    # 3 strategies x 2 MWT, LOCAL_FIRST at three remote probabilities: ten
    # buckets of the theta variants, then the paired rematch's rounds
    assert len(pd.table) == 30
    assert ps.broker.dispatch_log[0]["n_queries"] == 1
    assert [e["n_rows"] for e in list(ps.broker.dispatch_log)[:10]] == \
        [24] * 10
    assert pd.n_dispatches == js.n_dispatches == ps.n_dispatches >= 11
    again = plan_for_mesh(2, 32, service=ps, **kw)     # a replanned fleet
    assert again.n_dispatches == 0
    _same_decision(dataclasses.replace(jd, n_dispatches=0), again)


def test_plan_one_cluster(tmp_path):
    js, ps = _services(tmp_path)
    jt = JT.one_cluster(8, 40)
    kw = dict(work_per_group=256, reps=4, seed0=3,
              thetas=((0, 0), (2, 0)), mwt_opts=(False, True))
    jd = jplanner.plan(jt, service=js, **kw)
    pd = plan(port_topology(jt), service=ps, **kw)
    _same_decision(jd, pd)
    assert pd.n_dispatches == js.n_dispatches
    # a second service over the same store: answered from disk
    fresh = PortService(root=tmp_path / "port", device="cpu")
    again = plan(port_topology(jt), service=fresh, **kw)
    assert again.n_dispatches == 0 and fresh.n_dispatches == 0
    _same_decision(dataclasses.replace(jd, n_dispatches=0), again)
