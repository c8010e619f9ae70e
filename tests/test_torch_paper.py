"""The paper's experiments on the port against the JAX package: the §4.1.1
configuration (``configs/ws_paper.py``), every figure function of
``benchmarks/paper_torch.py`` at reps=2 on reduced grids (each cell's batch
held leaf for leaf to the JAX engine on the same seeds, each row equal to
the row the JAX bench's code computes from the JAX engine), the backend
matrix, the paper sweep's backend table, and ``serve.main()`` at reduced
width (the planner's decision and the scheduler's stats of the JAX
``main()``; ``--no-reduced`` selects the full config). No tolerance."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import ws_paper as jws_paper
from repro.core import analysis as janalysis
from repro.core import backend as jbk
from repro.core import divisible as jdv
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro_torch.configs import ws_paper
from test_torch_common import assert_results_equal, port_scenario

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import paper_torch as pt  # noqa: E402
from examples import paper_sweep_torch as ps  # noqa: E402
sys.path.remove(str(ROOT))


def test_ws_paper_equals_the_jax_packages():
    for full in (False, True):
        g, jg = ws_paper.grid(full), jws_paper.grid(full)
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        assert list(g.cells()) == list(jg.cells())
    g = ws_paper.grid(full=True)
    assert len(list(g.cells())) == 96 and g.reps == 1000
    assert ws_paper.MULTICLUSTER_SCENARIOS == \
        jws_paper.MULTICLUSTER_SCENARIOS


class JaxCells:
    """The JAX side of a figure: every cell's batch as the JAX bench builds
    it (``jdv.batch_scenarios`` with the bench's seeds, ``simulate_batch``),
    checked against the port's batch and result of the same cell, which the
    port's figure function hands to ``on_cell`` in the same order."""

    def __init__(self):
        self.port = []

    def on_cell(self, cfg, scn, res):
        self.port.append((cfg, scn, res))

    def run(self, k, topo, W, seeds, mwt=False, **kw):
        cfg = jdv.EngineConfig(
            topology=topo, mwt=mwt,
            max_events=jdv.default_max_events(W, topo.p,
                                              kw.get("lam_remote",
                                                     kw.get("lam", 1))))
        scn = jdv.batch_scenarios(W, seeds, **kw)
        res = jdv.simulate_batch(cfg, scn)
        pcfg, pscn, pres = self.port[k]
        assert (pcfg.max_events, pcfg.mwt) == (cfg.max_events, cfg.mwt)
        assert pcfg.topology.p == topo.p
        for f in scn._fields:
            np.testing.assert_array_equal(
                getattr(port_scenario(scn), f).numpy(),
                getattr(pscn, f).numpy(), err_msg=f)
        assert_results_equal(res, pres, msg=f"cell {k}")
        return res


def _seeds(reps, k):
    return np.arange(reps, dtype=np.uint32) + k


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_fig10_rows(capsys):
    grid = ws_paper.PaperGrid(W_list=(2000, 20000), p_list=(4, 8),
                              lam_list=(2, 30), reps=2)
    j = JaxCells()
    got = pt.fig10_overhead_ratio(2, grid, device="cpu", on_cell=j.on_cell)
    want = []
    for k, (W, p, lam) in enumerate(grid.cells()):
        ms = np.asarray(j.run(k, JT.one_cluster(p, 1), W, _seeds(2, 1),
                              lam=lam).makespan)
        r = janalysis.summarize(janalysis.overhead_ratio(ms, W, p, lam))
        c = janalysis.summarize(janalysis.fitted_constant(ms, W, p, lam))
        want.append(dict(p=p, W=W, lam=lam, ratio_med=r["median"],
                         ratio_q1=r["q1"], ratio_q3=r["q3"],
                         fit_med=c["median"]))
    _same_rows(got, want)
    assert capsys.readouterr().out.startswith("fig10_overhead_ratio,")


def test_fig11_rows():
    j = JaxCells()
    got = pt.fig11_accept_latency(2, p_list=(4,), W_list=(2000, 20000),
                                  device="cpu", on_cell=j.on_cell)
    want, k = [], 0
    for W in (2000, 20000):
        lam_th = janalysis.theoretical_limit_latency(W, 4)
        by_lam = {}
        for lam in np.unique(np.linspace(max(lam_th * 0.4, 1), lam_th * 2.2,
                                         8).astype(int)):
            by_lam[int(lam)] = np.asarray(j.run(
                k, JT.one_cluster(4, 1), W, _seeds(2, 3),
                lam=int(lam)).makespan)
            k += 1
        lam_exp = janalysis.experimental_limit_latency(by_lam, W, 4)
        want.append(dict(p=4, W=W, lam_theory=lam_th, lam_exp=lam_exp,
                         ratio=(W / 4) / max(lam_exp, 1)))
    assert k == len(j.port)
    _same_rows(got, want)


def test_fig12_rows():
    j = JaxCells()
    got = pt.fig12_mwt_swt(2, False, p_list=(4, 8), W=20000, device="cpu",
                           on_cell=j.on_cell)
    want, k = [], 0
    for p in (4, 8):
        out = {}
        for mwt in (False, True):
            res = j.run(k, JT.one_cluster(p, 262), 20000, _seeds(2, 5),
                        mwt=mwt, lam=262)
            out[mwt] = (np.asarray(res.makespan), np.asarray(res.startup_end))
            k += 1
        want.append(dict(
            p=p, W=20000, lam=262,
            startup_speedup=float(np.median(out[False][1])
                                  / np.median(out[True][1])),
            overall_speedup=float(np.median(out[False][0])
                                  / np.median(out[True][0]))))
    _same_rows(got, want)


def test_steal_threshold_rows():
    j = JaxCells()
    cases = ((4, 100), (8, 50))
    got = pt.steal_threshold(2, cases, W=20000, device="cpu",
                             on_cell=j.on_cell)
    want, k = [], 0
    for p, lam in cases:
        out = {}
        for tc in (0, 1, 2, 4):
            out[tc] = float(np.median(np.asarray(j.run(
                k, JT.one_cluster(p, lam), 20000, _seeds(2, 1), lam=lam,
                theta_comm=tc).makespan)))
            k += 1
        best = min(out, key=out.get)
        want.append(dict(p=p, lam=lam, base=out[0], best_theta_comm=best,
                         gain=out[0] / out[best],
                         **{f"ms_tc{t}": out[t] for t in out}))
    _same_rows(got, want)


def test_multicluster_rows():
    j = JaxCells()
    scenarios = ((2, 2, 50, "complete"), (3, 2, 20, "ring"))
    got = pt.multicluster(2, scenarios, W=20000, device="cpu",
                          on_cell=j.on_cell)
    want, k = [], 0
    for (c, m, lam_r, inter) in scenarios:
        for strat, rp in ((JT.UNIFORM, 0.25), (JT.LOCAL_FIRST, 0.1)):
            topo = JT.multi_cluster(c, m, lam_r, inter=inter) \
                .with_strategy(strat, remote_prob=rp)
            res = j.run(k, topo, 20000, _seeds(2, 7), lam_local=1,
                        lam_remote=lam_r, remote_prob=rp)
            k += 1
            med = float(np.median(np.asarray(res.makespan)))
            want.append(dict(
                clusters=c, per_cluster=m, lam_remote=lam_r, inter=inter,
                strategy=JT.strategy_name(strat), median_makespan=med,
                overhead=med - 20000 / (c * m),
                fail_frac=float(np.mean(np.asarray(res.n_fail) / np.maximum(
                    np.asarray(res.n_requests), 1)))))
    _same_rows(got, want)


def test_backend_matrix_on_the_cpu(tmp_path):
    """The 66-row grid shape of ``BENCH_backends.json`` (22 reps × three
    λ), narrowed to p=4: ``oracle`` and ``torch`` agree on every column,
    ``cuda`` has no CPU form, and the torch backend's segmented run has the
    JAX backend's SegmentStats on the same rows."""
    doc = pt.backend_matrix(2, device="cpu", out=tmp_path, p=4, W=3000)
    by = {r["backend"]: r for r in doc["backends"]}
    assert doc["grid"]["n_rows"] == 66
    assert by["oracle"]["parity_vs_oracle"] and by["torch"]["parity_vs_oracle"]
    assert by["cuda"]["available"] is False
    rows = jsw.grid_rows([3000], (2, 6, 20), 22)
    model = jsw.resolve_model(JT.one_cluster(4, 1), "divisible",
                              W_list=[3000], lam_list=(2, 6, 20),
                              pow2_max_events=True)
    jg = jsw.run_rows(model, rows, backend="jax", reroute=False)
    st = jbk.get_backend("jax").last_stats
    assert by["torch"]["segment_stats"] == dataclasses.asdict(st)
    ev = np.asarray(jg.extras["n_events"], np.float64)
    assert by["torch"]["wasted_frac_convoy"] == round(
        1.0 - ev.sum() / (len(rows) * ev.max()), 4)
    assert (tmp_path / "BENCH_backends_torch.json").is_file()


def test_paper_sweep_backend_table_on_the_cpu():
    assert ps.execution_backends(2, device="cpu") == {"oracle": True,
                                                      "torch": True}


# ---------------------------------------------------------------------------
# serve.main()
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--requests", "6", "--prompt-len", "8", "--max-new", "2"]


def _port_serve_on_the_cpu(monkeypatch, root):
    """The port's serve module with its planner's default service, its model
    and its decode on the CPU (``main()`` itself runs on the card)."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.sched import planner
    from repro_torch.service import SimulationService as PortService
    monkeypatch.setattr(planner, "_DEFAULT_SERVICE",
                        PortService(root=root, device="cpu"))
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg: build_model(cfg, device="cpu"))
    decode = serve.decode_batch
    monkeypatch.setattr(serve, "decode_batch",
                        lambda m, p, r: decode(m, p, r, device="cpu"))
    return serve


def test_serve_main_plans_and_schedules_as_the_jax_packages(
        tmp_path, monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro.sched import planner as jplanner
    from repro.service import SimulationService as JaxService
    jsvc = JaxService(root=tmp_path / "jax")
    monkeypatch.setattr(jplanner, "_DEFAULT_SERVICE", jsvc)
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGS)
    jstats = jserve.main()
    jout = capsys.readouterr().out
    serve = _port_serve_on_the_cpu(monkeypatch, tmp_path / "port")
    run = serve.main(SERVE_ARGS)
    out = capsys.readouterr().out

    def lines(text, head):
        return [ln for ln in text.splitlines() if ln.startswith(head)]

    for head in ("serving ", "planner:", "scheduler:"):
        assert lines(out, head) == lines(jout, head), head
    for f in dataclasses.fields(jstats):
        np.testing.assert_array_equal(np.asarray(getattr(run.stats, f.name)),
                                      np.asarray(getattr(jstats, f.name)),
                                      err_msg=f.name)
    # the JAX main()'s decision, asked again of its service (from its store)
    jdec = jplanner.plan_for_mesh(n_pods=2, chips_per_pod=32, dcn_delay=40,
                                  work_per_group=8 * 64, reps=8)
    for f in dataclasses.fields(jdec):
        if f.name != "n_dispatches":
            assert getattr(run.decision, f.name) == getattr(jdec, f.name), \
                f.name
    assert run.tokens.shape == (6, 2) and run.stats.completed == 6


def test_serve_example_serves_mixtral_through_main(tmp_path, monkeypatch,
                                                   capsys):
    """``examples/serve_lm_torch.py``'s command line (the JAX example's):
    the reduced mixtral-8x7b planned, scheduled and served; the tokens are
    ``decode_batch``'s on the same weights."""
    sys.path.insert(0, str(ROOT))
    try:
        from examples import serve_lm_torch
    finally:
        sys.path.remove(str(ROOT))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request
    from repro_torch.models import build_model
    serve = _port_serve_on_the_cpu(monkeypatch, tmp_path)
    run = serve.main(serve_lm_torch.ARGV)
    out = capsys.readouterr().out
    assert "serving mixtral-8x7b (" in out and "on 2 pods" in out
    assert run.tokens.shape == (24, 8) and run.stats.completed == 24
    cfg = get_config("mixtral-8x7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 16).astype(np.int32),
                    8) for i in range(24)]
    np.testing.assert_array_equal(
        run.tokens, serve.decode_batch(model, params, reqs))


def test_serve_reduced_is_a_switch(monkeypatch):
    """``--reduced`` is the default, as in the JAX package; ``--no-reduced``
    serves the full config (checked at the model build, which is stopped
    there)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    class Built(Exception):
        pass

    def build(cfg):
        raise Built(cfg)

    monkeypatch.setattr(serve, "build_model", build)
    full = get_config("qwen3-1.7b")
    for argv, want in (([], full.reduced()), (["--reduced"], full.reduced()),
                       (["--no-reduced"], full)):
        with pytest.raises(Built) as e:
            serve.main(argv)
        assert e.value.args[0] == want, argv
    assert full.d_model == 2048 and full.n_layers == 28
