"""The port's segmented loop (``repro_torch.core.engine``: ``SegmentedRun``,
``simulate_segmented``, ``default_segment_len``) and the torch backend that
segments, against the JAX package's: the cases of ``tests/test_segmented.py``
that apply to the port. In each, the segmented run equals the monolithic
loop, which equals the JAX engine, and ``SegmentStats`` equals the JAX
package's ``simulate_segmented`` field for field on the same rows and
segment length. No tolerance."""
import dataclasses

import numpy as np
import pytest

from repro.core import backend as jbk
from repro.core import dag_gen as jgen
from repro.core import engine as jeng
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro_torch import obs
from repro_torch.core import backend as bk
from repro_torch.core import engine as eng
from repro_torch.core import sweep as sw
from test_torch_common import (assert_grids_equal, assert_results_equal,
                               port_dag, port_scenario, port_topology)


def _models(jtopo, task_model, **kw):
    """The same model in both packages (``dag=`` a JAX TaskDag)."""
    jmodel = jsw.resolve_model(jtopo, task_model, **kw)
    if "dag" in kw:
        kw = dict(kw, dag=port_dag(kw["dag"]))
    return jmodel, sw.resolve_model(port_topology(jtopo), task_model, **kw)


def _hold(jmodel, model, jscn, seg_len):
    """JAX monolithic == JAX segmented == port monolithic == port segmented,
    and the two packages' SegmentStats equal; returns (port result, port
    stats)."""
    expect = jeng.simulate_batch(jmodel, jscn)
    jgot, jstats = jeng.simulate_segmented(jmodel, jscn, seg_len=seg_len)
    scn = port_scenario(jscn)
    mono = eng.simulate_batch(model, scn)
    got, stats = eng.simulate_segmented(model, scn, seg_len=seg_len)
    for what, res in (("jax segmented", jgot), ("port monolithic", mono),
                      ("port segmented", got)):
        assert_results_equal(expect, res, msg=what)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.wasted_frac == jstats.wasted_frac
    return got, stats


def test_default_segment_len_bounds():
    for args, kw, want in (((1 << 20,), {}, 128), ((8,), {}, 32),
                           ((48,), {}, 64),
                           ((1 << 20,), dict(ev_budget=[64, 0]), 64),
                           ((1 << 20,), dict(ev_budget=[1 << 20]), 128)):
        assert eng.default_segment_len(*args, **kw) == want
        assert jeng.default_segment_len(*args, **kw) == want
    assert bk.get_backend("torch").capabilities().segment_len == 128
    assert bk.get_backend("cuda").capabilities().segment_len is None
    assert bk.SEG_LEN_ENV == jbk.SEG_LEN_ENV == "REPRO_WS_SEG_LEN"


@pytest.mark.parametrize("strategy", [JT.UNIFORM, JT.LOCAL_FIRST,
                                      JT.INV_DISTANCE, JT.ROUND_ROBIN])
@pytest.mark.parametrize("mwt", [False, True])
def test_segmented_parity_divisible(strategy, mwt):
    jtopo = JT.two_clusters(3, 9).with_strategy(strategy, remote_prob=0.2)
    rows = jsw.grid_rows([1500], [(1, 9)], 2, theta=((0, 0), (3, 1)))
    jmodel, model = _models(jtopo, "divisible", W_list=[1500],
                            lam_list=[(1, 9)], mwt=mwt)
    jscn = jsw.scenario_from_rows(rows, remote_prob=0.2)
    got, stats = _hold(jmodel, model, jscn, seg_len=16)
    assert stats.n_segments >= 1
    assert stats.events_executed == int(got.n_events.sum())


def test_segmented_parity_dag_and_adaptive():
    jtopo = JT.two_clusters(3, 11).with_strategy(JT.LOCAL_FIRST,
                                                 remote_prob=0.3)
    cases = (
        (_models(jtopo, "dag", dag=jgen.merge_sort(300, 32),
                 max_events=1 << 16), jsw.grid_rows([0], [(1, 11)], 2)),
        (_models(jtopo, "adaptive", W_list=[900], lam_list=[(1, 11)],
                 merge_alpha=2, merge_beta_num=1),
         jsw.grid_rows([900], [(1, 11)], 2)))
    for (jmodel, model), rows in cases:
        _hold(jmodel, model, jsw.scenario_from_rows(rows, remote_prob=0.3),
              seg_len=32)


def test_segmented_ev_budget_overflow_parity():
    jtopo = JT.one_cluster(6, 30)
    rows = jsw.grid_rows([40_000], [30], 4)
    jmodel, model = _models(jtopo, "divisible", W_list=[40_000],
                            lam_list=[30], max_events=1 << 18)
    # a uniform tight budget, then budgets that mix truncated and full rows
    # in one batch
    for budget in (128, np.array([128, 1 << 18, 128, 1 << 18], np.int64)):
        got, _ = _hold(jmodel, model,
                       jsw.scenario_from_rows(rows, ev_budget=budget),
                       seg_len=32)
        overflow = got.overflow.numpy()
        assert overflow.any()
        assert np.isscalar(budget) or not overflow.all()


def test_compaction_down_to_a_single_lane():
    """15 budget-capped rows and one long straggler: the batch compacts to
    width 1 and wastes fewer lane-cycles than one convoyed batch."""
    jtopo = JT.one_cluster(4, 2)
    jmodel, model = _models(jtopo, "divisible", W_list=[300], lam_list=[2],
                            max_events=1 << 14)
    budgets = np.full(16, 64, np.int64)   # short rows stop at 64 events
    budgets[0] = 1 << 14                  # the straggler runs to its end
    jscn = jsw.scenario_from_rows(jsw.grid_rows([300], [2], 16),
                                  ev_budget=budgets)
    W = np.asarray(jscn.W).copy()
    W[0] = 10_000_000
    jscn = jscn._replace(W=W)
    got, stats = _hold(jmodel, model, jscn, seg_len=64)
    overflow = got.overflow.numpy()
    assert overflow.any() and not overflow[0]
    assert stats.n_compactions >= 1
    assert stats.max_width == 16 and stats.final_width == 1
    ev = got.n_events.numpy().astype(np.float64)
    convoy = 1.0 - ev.sum() / (len(ev) * ev.max())
    assert 0.0 < stats.wasted_frac < convoy


def test_compaction_gathers_the_inv_distance_table():
    """Rows of an INV_DISTANCE batch each own a slice of the victim table:
    after a compaction the survivors must still draw from their own."""
    jtopo = JT.two_clusters(4, 20).with_strategy(JT.INV_DISTANCE)
    jmodel, model = _models(jtopo, "divisible", W_list=[2000],
                            lam_list=[(1, 5), (2, 40)], max_events=1 << 14)
    rows = jsw.grid_rows([2000], [(1, 5), (2, 40)], 4)
    _, stats = _hold(jmodel, model, jsw.scenario_from_rows(rows), seg_len=32)
    assert stats.n_compactions >= 1


def test_seg_len_env_override_and_stats(monkeypatch):
    be, jbe = bk.get_backend("torch"), jbk.get_backend("jax")
    jtopo = JT.one_cluster(4, 2)
    jmodel, model = _models(jtopo, "divisible", W_list=[900], lam_list=[2])
    rows = jsw.grid_rows([900], [2], 48)          # >= seg_min_rows
    assert be.seg_min_rows == jbe.seg_min_rows == 32
    monkeypatch.setenv(bk.SEG_LEN_ENV, "0")       # the off switch
    a = sw.run_rows(model, rows, backend="torch", device="cpu")
    assert be.last_stats is None                  # the monolithic loop ran
    for env in ("64", None):                      # forced, then the default
        if env is None:
            monkeypatch.delenv(bk.SEG_LEN_ENV)
        else:
            monkeypatch.setenv(bk.SEG_LEN_ENV, env)
        g = sw.run_rows(model, rows, backend="torch", device="cpu")
        jg = jsw.run_rows(jmodel, rows, backend="jax", reroute=False)
        st, jst = be.last_stats, jbe.last_stats
        assert dataclasses.asdict(st) == dataclasses.asdict(jst), env
        assert st.n_segments >= 1
        assert 0 < st.events_executed <= st.lane_cycles
        assert 0.0 <= st.wasted_frac < 1.0
        assert_grids_equal(a, g, msg=f"env={env}")
        assert_grids_equal(jg, g, msg=f"jax env={env}")
    # a batch below seg_min_rows runs the monolithic loop
    sw.run_rows(model, rows.slice(0, 8), backend="torch", device="cpu")
    assert be.last_stats is None


def test_the_segment_span_and_counters():
    """Each segment is one ``engine.segment`` span and one
    ``engine.segments`` count; a finished run adds its lane cycles and
    events and sets ``engine.wasted_frac``, as the JAX package does."""
    jtopo = JT.one_cluster(4, 2)
    _, model = _models(jtopo, "divisible", W_list=[3000], lam_list=[2])
    scn = sw.scenario_from_rows(sw.grid_rows([3000], [2], 8), device="cpu")

    def counters():
        return obs.REGISTRY.snapshot()["counters"]

    before = counters()
    with obs.trace_to() as tr:
        _, stats = eng.simulate_segmented(model, scn, seg_len=32)
    after = counters()
    names = [e["name"] for e in tr.events() if e["ph"] == "B"]
    assert stats.n_segments > 1
    assert names.count("engine.segment") == stats.n_segments
    for name, want in (("engine.segments", stats.n_segments),
                       ("engine.lane_cycles", stats.lane_cycles),
                       ("engine.events_executed", stats.events_executed),
                       ("engine.compactions", stats.n_compactions)):
        assert after.get(name, 0) - before.get(name, 0) == want, name
    assert obs.REGISTRY.snapshot()["gauges"]["engine.wasted_frac"] == \
        round(stats.wasted_frac, 4)
