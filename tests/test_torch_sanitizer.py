"""The port's runtime sanitizer (``repro_torch.check.sanitizer``): the
``backend.result`` probe (steal accounting, a seeded oracle replay of
sampled dispatches) and the ``broker.observe`` probe, clean on real runs and
loud on seeded corruption — the twins of the sanitizer cases of
``tests/test_check.py``, with the JAX package's sanitizer beside it where
both can watch the same dispatch."""
import numpy as np
import pytest

from repro import obs as jobs
from repro.check import Finding as JFinding
from repro.check import sanitizer as jsz
from repro.core import backend as jbk
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro_torch import obs
from repro_torch.check import PASSES, Finding
from repro_torch.check import sanitizer as sz
from repro_torch.core import backend as bk
from repro_torch.core import dag_gen as gen
from repro_torch.core import sweep
from repro_torch.service import SimulationService
from repro_torch.service import resilience as rz
from repro_torch.service.broker import EventHistory
from test_torch_common import port_topology

JTOPO = JT.one_cluster(4, 2)
TOPO = port_topology(JTOPO)


@pytest.fixture(autouse=True)
def _isolated():
    """Mask any ambient fault plan; each test arms the sanitizers itself and
    never leaks them."""
    with rz.fault_plan(rz.no_faults()):
        yield
    rz.reload_env_plan()
    for s in (sz, jsz):
        s.uninstall()
        s.reset()


def _rows(W=5_000, lam=2, n=8, seed0=1):
    return sweep.grid_rows([W], [lam], n, seed0=seed0)


def _model():
    return sweep.make_model("divisible", topology=TOPO, max_events=1 << 14)


def test_the_switch_and_its_name(monkeypatch):
    assert sz.ENV == jsz.ENV == "REPRO_WS_SANITIZE"
    assert PASSES == ("dispatch", "protocol", "sanitizer") \
        and sz.PASS == "sanitizer"
    monkeypatch.delenv(sz.ENV, raising=False)
    assert not sz.enabled()
    monkeypatch.setenv(sz.ENV, "1")
    assert sz.enabled()
    monkeypatch.setenv(sz.ENV, "0")
    assert not sz.enabled()
    sz.install()
    assert sz.enabled()


def test_flags_steal_accounting():
    sz.install(replay_denom=1_000_000)      # no replay noise in this test
    sz.reset()
    model, rows = _model(), _rows(n=4)
    oracle = bk.get_backend("oracle")
    grid = oracle.run_rows(model, rows, device="cpu")
    assert sz.summary()["violations_total"] == 0   # an honest grid is clean
    grid.n_requests = grid.n_requests + 1          # lose/duplicate requests
    sz.probe("backend.result", backend=oracle, model=model, rows=rows,
             remote_prob=0.25, ev_budget=None, grid=grid)
    assert sz.summary()["violations_by_rule"].get("steal_accounting")


class _EvilBackend(bk.TorchBackend):
    """The bit-exact plain loop, then +7 on every makespan — the silently
    wrong answer the oracle replay exists to catch."""
    name = "evil"

    def _run_rows(self, model, rows, remote_prob, ev_budget, devices):
        grid = super()._run_rows(model, rows, remote_prob, ev_budget,
                                 devices)
        grid.makespan = grid.makespan + 7
        return grid


def test_replay_catches_a_bit_mismatch():
    sz.install(replay_denom=1, replay_rows=2)
    sz.reset()
    _EvilBackend().run_rows(_model(), _rows(n=8), device="cpu")
    s = sz.summary()
    assert s["n_replayed_dispatches"] == 1 and s["n_replayed_rows"] == 2
    assert s["violations_by_rule"].get("replay_mismatch")
    diff = [v for v in sz.violations() if v["rule"] == "replay_mismatch"]
    assert diff and any(d["field"] == "makespan" for d in diff[0]["diff"])
    assert all(d["got"] == d["want"] + 7 for d in diff[0]["diff"]
               if d["field"] == "makespan")


def test_replay_passes_an_honest_backend_as_the_jax_packages_does():
    """The same rows through the port's plain loop and the JAX package's
    engine, each watched by its own sanitizer: the same probes, the same
    replays, no violation."""
    for s in (sz, jsz):
        s.install(replay_denom=1, replay_rows=2)
        s.reset()
    rows = _rows(n=8)
    budgets = np.array([40, 1 << 14] * 4, np.int32)   # half of them overflow
    g = bk.get_backend("torch").run_rows(_model(), rows, ev_budget=budgets,
                                         device="cpu")
    jmodel = jsw.make_model("divisible", topology=JTOPO, max_events=1 << 14)
    jbk.get_backend("jax").run_rows(jmodel, rows, ev_budget=budgets)
    assert g.overflow.any() and not g.overflow.all()
    ps, js = sz.summary(), jsz.summary()
    assert ps["n_replayed_dispatches"] == 1 and ps["violations_total"] == 0
    for k in ("n_probes", "n_dispatch_probes", "n_replayed_dispatches",
              "n_replayed_rows", "violations_total", "violations_by_rule"):
        assert ps[k] == js[k], k


def test_sampling_is_the_reference_rule():
    """1 in ``replay_denom`` dispatches by the xor of their row seeds: the
    same dispatches are replayed in both packages."""
    for s in (sz, jsz):
        s.install(replay_denom=3, replay_rows=1)
        s.reset()
    jmodel = jsw.make_model("divisible", topology=JTOPO, max_events=1 << 14)
    for seed0 in range(1, 9):
        rows = _rows(W=800, n=3, seed0=seed0)
        bk.get_backend("torch").run_rows(_model(), rows, device="cpu")
        jbk.get_backend("jax").run_rows(jmodel, rows)
        assert sz.summary()["n_replayed_dispatches"] == \
            jsz.summary()["n_replayed_dispatches"]
    assert 0 < sz.summary()["n_replayed_dispatches"] < 8


def test_replay_skips_models_the_oracle_cannot_twin():
    """A DAG whose deque cap could bind and an adaptive model: the oracle
    backend would raise on them, so the replay is skipped — no violation,
    no crash, the backend's answer returned."""
    sz.install(replay_denom=1, replay_rows=2)
    sz.reset()
    dag = sweep.resolve_model(TOPO, "dag", lam_list=[2],
                              dag=gen.binary_tree(5), deque_cap=4)
    adaptive = sweep.resolve_model(TOPO, "adaptive", W_list=[3000],
                                   lam_list=[2], pool_cap=8)
    torch_be = bk.get_backend("torch")
    for m, W in ((dag, 0), (adaptive, 3000)):
        g = torch_be.run_rows(m, _rows(W=W, n=4), device="cpu")
        assert len(g) == 4
    s = sz.summary()
    assert s["n_dispatch_probes"] == 2
    assert s["n_replayed_dispatches"] == 0 and s["violations_total"] == 0


def test_flags_event_history_poison():
    sz.install()
    sz.reset()
    cols = np.array([[100, 2, 2, 0, 0]], np.int64)
    sz.probe("broker.observe", sig="s", cols=cols,
             ev=np.array([0]), cap=256, history=EventHistory(), p=4)
    sz.probe("broker.observe", sig="s", cols=cols,
             ev=np.array([300]), cap=256, history=EventHistory(), p=4)
    assert sz.summary()["violations_by_rule"] == {"event_history": 2}
    h = EventHistory()
    h.observe("s", cols, np.array([np.nan]))   # a poisoned EMA
    sz.probe("broker.observe", sig="s", cols=cols, ev=np.array([5]),
             cap=256, history=h, p=4)
    assert sz.summary()["violations_by_rule"] == {"event_history": 3}


def test_chaos_run_zero_violations(tmp_path):
    """Faults fire, recovery heals them (on the CPU: bisection, then the
    oracle), and every probe — steal accounting, the oracle replay of every
    dispatch, the event history — stays silent."""
    sz.install(replay_denom=1, replay_rows=2)
    sz.reset()
    cfg = rz.ResilienceConfig(
        retry=rz.RetryPolicy(max_attempts=1, base_s=0.0, cap_s=0.0),
        breaker_failures=10_000)
    plan = rz.FaultPlan(rng_seed=7, sites={
        "backend.run_rows": rz.Prob(0.2, kind="raise", per_row=True,
                                    match={"backend": "torch"})})
    svc = SimulationService(root=tmp_path, resilience=cfg, device="cpu",
                            metrics=obs.MetricsRegistry())
    qs = [svc.make_query(TOPO, W_list=[2000], lam_list=[3], reps=1,
                         seed0=s) for s in range(1, 41)]
    with rz.fault_plan(plan):
        res = svc.query_many(qs)
    assert len(res) == 40
    st = svc.stats()
    s = st["sanitizer"]
    assert s["enabled"] and s["n_probes"] > 0
    assert s["violations_total"] == 0, s["violations_by_rule"]
    assert s["n_replayed_rows"] > 0
    assert st["degraded"]["salvaged_rows"] > 0


def test_stats_exposes_the_summary(tmp_path):
    svc = SimulationService(root=tmp_path, device="cpu")
    svc.query(TOPO, W_list=[1000], lam_list=[2], reps=2)
    s = svc.stats()["sanitizer"]
    assert s["enabled"] is False and s["violations_total"] == 0
    assert set(s) == set(jsz.summary())


def test_violations_reach_the_metrics_registry():
    def jax_unit_test_violations():
        return sum(c.value for lbl, c in
                   jobs.REGISTRY.find("counter", "check.violations")
                   if lbl.get("rule") == "unit_test")

    sz.install()
    sz.reset()
    before = sum(c.value for _, c in
                 obs.REGISTRY.find("counter", "check.violations"))
    # the JAX package's own tests may have counted one in this process
    jax_before = jax_unit_test_violations()
    sz.violation("unit_test", "nowhere", message="seeded")
    found = obs.REGISTRY.find("counter", "check.violations")
    assert sum(c.value for _, c in found) == before + 1
    assert any(lbl.get("pass") == "sanitizer" and
               lbl.get("rule") == "unit_test" for lbl, _ in found)
    # the JAX package's registry is its own: the port's violation adds
    # nothing there
    assert jax_unit_test_violations() == jax_before


def test_findings_fingerprint_like_the_jax_packages():
    kw = dict(pass_name="sanitizer", rule="replay_mismatch",
              where="backend.result", symbol="torch", message="diverges")
    f, jf = Finding(**kw), JFinding(**kw)
    assert f.fingerprint() == jf.fingerprint()
    assert f.to_dict() == jf.to_dict()
    assert Finding.from_dict(f.to_dict()) == f
    moved = Finding(**dict(kw, where="src/x.py:12"))
    assert moved.fingerprint() == Finding(
        **dict(kw, where="src/x.py:99")).fingerprint()


def test_the_pass_runs_clean_on_the_cpu():
    assert sz.run(device="cpu") == []
    assert not sz.summary()["enabled"]          # the pass restores the state


def _tamper(run, how):
    """Corrupt a segmented run's state between two segments, the way the
    JAX package's sanitizer tests do (``tests/test_check.py``)."""
    if how == "clock":            # the per-row clock memory runs ahead
        run._san_prev_t[:] = 1e12
    elif how == "budget":         # rows seem to have run > seg_len events
        run._san_prev_ev[:] = -1000
    elif how == "conservation":   # every row claims one more unit of work
        if hasattr(run, "loop"):
            scn = run.loop.scn
            run.loop = run.loop._replace(scn=scn._replace(W=scn.W + 1))
        else:
            run.scn = run.scn._replace(W=run.scn.W + 1)


@pytest.mark.parametrize("how,rules", [
    ("clean", set()), ("clock", {"clock_monotonic"}),
    ("budget", {"segment_budget"}),
    ("conservation", {"work_conservation"})])
def test_the_segment_probe_as_the_jax_packages(how, rules):
    """The ``engine.segment`` probe at every boundary of a segmented run:
    silent on an honest run, and on a tampered one the reference's rule
    names, probe for probe equal to the JAX package's sanitizer watching the
    same rows."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as eng

    summaries = []
    for s, e, make, scn in (
            (sz, eng, _model,
             lambda rows: sweep.scenario_from_rows(rows, device="cpu")),
            (jsz, jeng,
             lambda: jsw.make_model("divisible", topology=JTOPO,
                                    max_events=1 << 14),
             jsw.scenario_from_rows)):
        s.install(replay_denom=1_000_000)
        s.reset()
        run = e.SegmentedRun(make(), scn(_rows(n=64 if how == "clean"
                                               else 8)), seg_len=16)
        run.step()
        assert not run.done, "the workload must span two segments"
        _tamper(run, how)
        while not run.done:
            run.step()
        summaries.append(s.summary())
        assert s.summary()["n_probes"] == run.stats.n_segments
    ps, js = summaries
    assert set(ps["violations_by_rule"]) == rules
    for k in ("n_probes", "violations_total", "violations_by_rule"):
        assert ps[k] == js[k], k
