"""The simulator benches of ``benchmarks/run.py`` on the port
(``benchmarks/run_torch.py``), run on the CPU at a small size: each twin's
deterministic outputs — events summed, the planner's decision, dispatches
cold and warm, queries per dispatch, adaptive and fixed reps, the paired
verdicts, the sanitizer's probe and replay counts and the fault counters —
equal the JAX package's on the same inputs, made by the JAX bench's own
calls at the same size. Nothing is written outside ``--out``, and the port's
``BENCH_*_torch.json`` files pass the unchanged
``benchmarks/check_regression.py``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.check import sanitizer as jsan
from repro.core import dag_gen as jgen
from repro.core import divisible as jdv
from repro.core import engine as jeng
from repro.core import sweep as jsw
from repro.core.backend import get_backend as jget_backend
from repro.core.topology import one_cluster as jone_cluster
from repro.sched.planner import plan_for_mesh as jplan_for_mesh
from repro.service import PairedPolicy as JPairedPolicy
from repro.service import SimulationService as JaxService
from repro.service import resilience as jrz
from repro.service.estimator import fixed_reps_for_width as jfixed_reps
from repro.service.estimator import z_value as jz_value
from repro_torch.core import dag_gen as pgen

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import check_regression  # noqa: E402
from benchmarks import run_torch as rt  # noqa: E402

CPU = dict(device="cpu")

# The port's tensors here are tiny; one thread is fastest and keeps the test
# workers from fighting over cores.
torch.set_num_threads(1)


def test_sim_throughput_sums_the_events_of_the_jax_engine(tmp_path):
    p, W, lam, reps = 8, 5000, 5, 4
    got = rt.sim_throughput(reps, p=p, W=W, lam=lam, out=tmp_path, **CPU)
    cfg = jdv.EngineConfig(topology=jone_cluster(p, lam),
                           max_events=jdv.default_max_events(W, p, lam))
    scn = jdv.batch_scenarios(W, np.arange(reps, dtype=np.uint32) + 1,
                              lam=lam)
    want = int(np.asarray(jdv.simulate_batch(cfg, scn).n_events).sum())
    assert got[0]["events"] == want > 0
    assert got[0]["kernel_ms"] is None          # no card, no CUDA events
    assert (tmp_path / "sim_throughput.csv").is_file()


def test_model_throughput_sums_the_events_of_each_model():
    p, W, lam, reps = 4, 2000, 5, 3
    got = rt.model_throughput(reps, p=p, W=W, lam=lam,
                              dag=pgen.merge_sort(200, 16), pool_cap=256,
                              **CPU)
    topo = jone_cluster(p, lam)
    models = {
        "divisible": jsw.make_model(
            "divisible", topology=topo,
            max_events=jdv.default_max_events(W, p, lam)),
        "dag": jsw.make_model("dag", topology=topo,
                              dag=jgen.merge_sort(200, 16),
                              max_events=1 << 20),
        "adaptive": jsw.make_model(
            "adaptive", topology=topo, pool_cap=256,
            max_events=jdv.default_max_events(W, p, lam)),
    }
    assert [r["model"] for r in got] == list(models)
    for row, (name, model) in zip(got, models.items()):
        scn = jeng.batch_scenarios(W, np.arange(reps, dtype=np.uint32) + 1,
                                   lam=lam)
        want = int(np.asarray(jeng.simulate_batch(model, scn).n_events).sum())
        assert row["events"] == want > 0, name


def test_sched_planner_makes_the_jax_decision(tmp_path):
    kw = dict(n_pods=2, chips_per_pod=16, dcn_delay=100, work_per_group=256)
    row, = rt.sched_planner(2, **kw, **CPU)
    jd = jplan_for_mesh(**kw, reps=2, service=JaxService(root=tmp_path),
                        backend="oracle")
    for f in ("strategy", "remote_prob", "theta_static", "theta_comm", "mwt",
              "expected_makespan", "baseline_makespan", "n_dispatches",
              "significant", "delta_mean", "n_paired_reps"):
        assert row[f] == getattr(jd, f), f
    assert row["policy"] == jd.strategy_name


def _jax_service_throughput(root, reps, p, W, lams, thetas, tgt_rel):
    """``run.service_throughput``'s calls on the JAX package."""
    svc = JaxService(root=root)

    def make():
        return [svc.make_query(jone_cluster(p, 1), W_list=[W],
                               lam_list=list(lams), theta=(th,), reps=reps,
                               seed0=11) for th in thetas]
    svc.query_many(make())
    d_cold = svc.n_dispatches
    svc.query_many(make())
    d_warm = svc.n_dispatches - d_cold
    sizes = [d["n_queries"] for d in svc.broker.dispatch_log]
    ares = svc.query(jone_cluster(p, 1), W_list=[W], lam_list=list(lams),
                     ci=tgt_rel, ci_relative=True, batch_reps=8,
                     max_reps=64 * max(reps, 16), seed0=23)
    cells = ares.cells
    n_fixed = max(jfixed_reps(float(cells.std[c]),
                              tgt_rel * float(cells.mean[c]))
                  for c in range(len(cells))) * len(cells)
    return dict(dispatches_cold=d_cold,
                dispatches_warm=d_warm,
                mean_queries_per_dispatch=sum(sizes) / max(len(sizes), 1),
                adaptive_reps=int(cells.n.sum()), fixed_reps_equiv=n_fixed)


def test_service_throughput_matches_the_jax_bench(tmp_path):
    kw = dict(p=4, W=2000, lams=(2, 10, 30, 50),
              thetas=((0, 0), (0, 2), (8, 0), (16, 2)), tgt_rel=0.05)
    row, = rt.service_throughput(4, **kw, **CPU)
    want = _jax_service_throughput(tmp_path, 4, **kw)
    for f, v in want.items():
        assert row[f] == v, f
    assert row["dispatches_warm"] == 0 and row["dispatches_cold"] >= 1


def test_paired_comparison_matches_the_jax_bench(tmp_path):
    p, W, lam, max_reps = 4, 3000, 20, 64
    got = rt.paired_comparison(4, p=p, W=W, lam=lam, max_reps=max_reps, **CPU)
    svc = JaxService(root=tmp_path)
    topo = jone_cluster(p, lam)
    arms = {"swt_vs_mwt": (dict(mwt=False), dict(mwt=True)),
            "theta0_vs_theta2": (dict(theta=((0, 0),)),
                                 dict(theta=((0, 2),)))}
    assert [r["pair"] for r in got] == list(arms)
    for row, (kw_a, kw_b) in zip(got, arms.values()):
        base = dict(W_list=[W], lam_list=[lam], reps=8, seed0=31)
        pc = svc.query_pair(
            svc.make_query(topo, **{**base, **kw_a}),
            svc.make_query(topo, **{**base, **kw_b}),
            policy=JPairedPolicy(batch_reps=8, min_reps=8,
                                 max_reps=max_reps)).paired
        assert row["n_paired"] == int(pc.n[0])
        assert row["delta"] == float(pc.delta_mean[0])
        assert row["delta_hw"] == float(pc.delta_half_width[0])
        assert row["significant"] == bool(pc.significant[0])
        if pc.significant[0]:
            z = jz_value(pc.confidence)
            var_sum = float(pc.var_a[0] + pc.var_b[0])
            delta = float(pc.delta_mean[0])
            assert row["n_indep_equiv"] == int(np.ceil(
                z * z * var_sum / max(delta * delta, 1e-12)))


def test_obs_overhead_matches_the_jax_bench(tmp_path):
    kw = dict(p=4, W=1000, lams=(2, 6, 20))
    doc = rt.obs_overhead(0, n_timed=1, out=tmp_path, **kw, **CPU)
    rows = jsw.grid_rows([kw["W"]], kw["lams"], 22)
    model = jsw.resolve_model(jone_cluster(kw["p"], 1), "divisible",
                              W_list=[kw["W"]], lam_list=kw["lams"],
                              pow2_max_events=True)
    jsw.run_rows(model, rows, backend="jax", reroute=False)
    assert doc["n_rows"] == len(rows) == 66
    assert doc["wasted_frac_actual"] == jget_backend("jax").last_stats \
        .wasted_frac
    svc = JaxService(root=tmp_path / "jax", metrics=jobs.MetricsRegistry())
    qkw = dict(W_list=[kw["W"]], lam_list=list(kw["lams"]), reps=16,
               seed0=7, backend="jax")
    svc.query(jone_cluster(kw["p"], 1), **qkw)
    svc.query(jone_cluster(kw["p"], 1), **qkw)
    c = svc.stats()["metrics"]["counters"]
    hits = c.get("store.hits_mem", 0) + c.get("store.hits_disk", 0)
    assert doc["cache_hit_ratio"] == hits / (hits + c.get("store.misses", 0))
    for name in ("obs_overhead.csv", "obs_metrics.json", "obs_trace.json",
                 "BENCH_obs_torch.json"):
        assert (tmp_path / name).is_file(), name


def _jax_sanitized_grids(W, lams, n_reps, denom=16):
    """``run.sanitizer_overhead``'s sixteen grids, one of them sampled."""
    def sampled(cand):
        seeds = np.asarray(cand.seed, dtype=np.uint32)
        return int(np.bitwise_xor.reduce(seeds)) % denom == 0

    grids = [jsw.grid_rows([W], lams, n_reps, seed0=s)
             for s in range(1, denom + 1)]
    if not any(sampled(g) for g in grids):
        grids[0] = next(c for nr in range(n_reps, n_reps + 4)
                        for c in (jsw.grid_rows([W], lams, nr, seed0=s)
                                  for s in range(1, 65)) if sampled(c))
    return grids


def test_sanitizer_overhead_matches_the_jax_bench(tmp_path):
    kw = dict(p=4, W=1000, lams=(2, 6, 20))
    doc = rt.sanitizer_overhead(0, n_timed=1, out=tmp_path, **kw, **CPU)
    model, grids = rt.sanitized_grids(0, **kw)
    jrows = _jax_sanitized_grids(kw["W"], kw["lams"], 22)
    for g, j in zip(grids, jrows):
        np.testing.assert_array_equal(np.asarray(g.seed), np.asarray(j.seed))
    jmodel = jsw.resolve_model(jone_cluster(kw["p"], 1), "divisible",
                               W_list=[kw["W"]], lam_list=kw["lams"],
                               pow2_max_events=True)
    try:
        jsan.install(replay_denom=16, replay_rows=2)
        jsan.reset()
        for g in jrows:
            jsw.run_rows(jmodel, g, backend="jax", reroute=False)
        summ = jsan.summary()
    finally:
        jsan.uninstall()
        jsan.reset()
    assert doc["n_rows"] == sum(len(g) for g in jrows)
    for f in ("n_dispatch_probes", "n_replayed_dispatches",
              "n_replayed_rows", "violations_total"):
        assert doc[f] == summ[f], f
    assert doc["n_replayed_dispatches"] == 1 and doc["violations_total"] == 0
    assert (tmp_path / "BENCH_check_torch.json").is_file()


def _jax_fault_counters(root, p, W, n_q, rate):
    """``run.fault_recovery``'s calls on the JAX package at one rate."""
    cfg = jrz.ResilienceConfig(
        retry=jrz.RetryPolicy(max_attempts=1, base_s=0.0, cap_s=0.0),
        breaker_failures=1 << 30)
    plan = jrz.FaultPlan(rng_seed=11, sites={
        "backend.run_rows": jrz.Prob(rate, kind="raise", per_row=True,
                                     match={"backend": "jax"})})
    svc = JaxService(root=root, metrics=jobs.MetricsRegistry(),
                     resilience=cfg)

    def mk(s):
        return svc.make_query(jone_cluster(p, 1), W_list=[W], lam_list=[3],
                              reps=1, seed0=s, backend="jax")
    with jrz.fault_plan(jrz.no_faults()):
        svc.query_many([mk(0)])
    with jrz.fault_plan(plan):
        for s in range(1, n_q + 1):
            svc.query_many([mk(s)])
    deg = svc.stats()["degraded"]
    return {k: int(deg[k]) for k in ("retries", "fallbacks", "salvaged_rows",
                                     "dispatch_failures")}


def test_fault_recovery_counts_as_the_jax_bench(tmp_path):
    p, W, n_q = 4, 500, 16
    doc = rt.fault_recovery(0, p=p, W=W, n_queries=n_q, out=tmp_path, **CPU)
    assert doc["workload"]["faults"] == "per row"
    fired = 0
    for rate in rt.FAULT_RATES:
        entry = doc["rates"][f"{rate:g}"]
        want = _jax_fault_counters(tmp_path / f"jax{rate}", p, W, n_q, rate)
        for k, v in want.items():
            assert entry[k] == v, (rate, k)
        assert entry["client_errors"] == 0
        fired += entry["fallbacks"]
    assert fired > 0                     # the faults fired and were healed
    assert (tmp_path / "BENCH_fault_torch.json").is_file()


def test_bench_files_pass_the_unchanged_regression_guard(tmp_path, capsys):
    kw = dict(p=4, W=1000, lams=(2, 6, 20), n_timed=1, out=tmp_path, **CPU)
    rt.obs_overhead(0, **kw)
    rt.sanitizer_overhead(0, **kw)
    rt.fault_recovery(0, p=4, W=500, n_queries=4, out=tmp_path, **CPU)
    backends = tmp_path / "BENCH_backends_torch.json"
    backends.write_text(json.dumps({"backends": []}))
    args = [str(backends), str(backends)]
    for kind, name in (("obs", "BENCH_obs_torch.json"),
                       ("fault", "BENCH_fault_torch.json"),
                       ("check", "BENCH_check_torch.json")):
        args += [f"--{kind}-baseline", str(tmp_path / name),
                 f"--{kind}-new", str(tmp_path / name)]
    assert check_regression.main(args) == 0
    out = capsys.readouterr().out
    assert "no cache-hit-ratio regression" in out
    assert "no fault-recovery p99 latency regression" in out
    assert "skipping" not in out


def test_nothing_is_written_outside_out(tmp_path, monkeypatch):
    bench = ROOT / "artifacts" / "bench"
    before = sorted(bench.rglob("*")) if bench.exists() else []
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    rt.sim_throughput(2, p=4, W=500, lam=2, **CPU)
    rt.fault_recovery(0, p=4, W=300, n_queries=2, **CPU)
    after = sorted(bench.rglob("*")) if bench.exists() else []
    assert after == before
    assert not list((tmp_path / "tmp").iterdir())    # stores removed


def test_main_knows_every_name_of_run_py(capsys):
    import ast
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    benches = next(n.value for n in ast.walk(main)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "benches")
    names = tuple(k.value for k in benches.keys)
    assert rt.ALL_NAMES == names
    with pytest.raises(SystemExit) as e:
        rt.main(["--only", "roofline", "--device", "cpu"])
    assert e.value.code != 0 and "Queue A 11" in str(e.value.code)
    rt.main(["--only", "sched_planner", "--device", "cpu"])
    assert "sched_planner," in capsys.readouterr().out


def test_a_run_of_every_bench_prints_no_row_for_roofline(capsys,
                                                         monkeypatch):
    """``roofline`` is not run: no CSV row (no ``us_per_call`` that was not
    measured), only the notice on stderr."""
    for name in rt.BENCHES:
        monkeypatch.setattr(rt, name, lambda *a, **k: None)
    for name in ("fig10_overhead_ratio", "fig11_accept_latency",
                 "fig12_mwt_swt", "steal_threshold", "multicluster",
                 "backend_matrix"):
        monkeypatch.setattr(rt.paper_torch, name, lambda *a, **k: None)
    monkeypatch.setattr(rt.daemon_torch, "daemon_throughput",
                        lambda *a, **k: None)
    rt.main(["--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == "name,us_per_call,derived\n"
    assert "roofline" not in got.out and "Queue A 11" in got.err


def test_smoke_ab_reads_the_end_to_end_numbers_of_a_run(tmp_path):
    """``benchmarks/smoke_ab.py``: an arm names a checkout and its phases;
    a run's summary holds the decode, prefill and query numbers of its
    ``chip_smoke.py`` lines and each phase's seconds."""
    from benchmarks import smoke_ab
    name, tree, phases = smoke_ab.parse_arm(f"parent={tmp_path}:paths,lm")
    assert (name, tree, phases) == ("parent", tmp_path.resolve(), "paths,lm")
    decode = dict.fromkeys(smoke_ab.DECODE_KEYS, 1.5)
    qps = {"cold": 50.0, "warm_memory": 180.0}
    lines = ["not json", json.dumps({"phase": "smoke_ab", "ran": "lm",
                                     "seconds": 9.0}),
             json.dumps({"phase": "lm_main_path",
                         "path": "serve.decode_batch", "arch": "x",
                         **decode}),
             json.dumps({"phase": "lm_main_path",
                         "path": "steps.build_prefill_step",
                         "wall_seconds": 0.07}),
             json.dumps({"phase": "query_main_path",
                         "step": "parity_and_rate", "queries_per_second": qps,
                         "queries_per_second_without_replay": qps})]
    assert smoke_ab.summarize(lines) == {
        "phase_seconds": {"lm": 9.0}, "decode": decode,
        "prefill_wall_seconds": 0.07, "query_per_second": qps,
        "query_per_second_without_replay": qps}


def test_smoke_ab_keeps_the_moe_phase_apart():
    """Phase ``lm_moe``'s serving and prefill lines (the same paths as
    ``lm_main_path``'s) land under their own keys."""
    from benchmarks import smoke_ab
    dense = dict.fromkeys(smoke_ab.DECODE_KEYS, 1.5)
    moe = dict.fromkeys(smoke_ab.DECODE_KEYS, 4.5)
    lines = [json.dumps({"phase": "lm_moe", "path": "serve.decode_batch",
                         **moe}),
             json.dumps({"phase": "lm_main_path",
                         "path": "serve.decode_batch", **dense}),
             json.dumps({"phase": "lm_moe",
                         "path": "steps.build_prefill_step",
                         "wall_seconds": 0.2}),
             json.dumps({"phase": "lm_main_path",
                         "path": "steps.build_prefill_step",
                         "wall_seconds": 0.07})]
    assert smoke_ab.summarize(lines) == {
        "phase_seconds": {}, "decode": dense, "moe_decode": moe,
        "prefill_wall_seconds": 0.07, "moe_prefill_wall_seconds": 0.2}


def test_smoke_ab_keeps_each_recurrent_arch_apart():
    """Phase ``lm_recurrent`` serves three architectures: each one's
    serving and prefill lines land under keys named by its ``arch``."""
    from benchmarks import smoke_ab
    lines = []
    want = {"phase_seconds": {}}
    for i, arch in enumerate(("xlstm-350m", "jamba-v0.1-52b",
                              "phi3-mini-3.8b")):
        decode = dict.fromkeys(smoke_ab.DECODE_KEYS, float(i))
        lines += [json.dumps({"phase": "lm_recurrent", "arch": arch,
                              "path": "serve.decode_batch", **decode}),
                  json.dumps({"phase": "lm_recurrent", "arch": arch,
                              "path": "steps.build_prefill_step",
                              "wall_seconds": i + 0.5})]
        want[f"{arch} decode"] = decode
        want[f"{arch} prefill_wall_seconds"] = i + 0.5
    assert smoke_ab.summarize(lines) == want
