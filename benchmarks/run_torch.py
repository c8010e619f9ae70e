#!/usr/bin/env python3
"""The simulator benches of ``benchmarks/run.py`` on the PyTorch/CUDA port:
``sim_throughput``, ``model_throughput``, ``sched_planner``,
``service_throughput``, ``paired_comparison``, ``obs_overhead``,
``sanitizer_overhead`` and ``fault_recovery``.

    python3 benchmarks/run_torch.py [--full] [--only NAME] [--out DIR]
                                    [--device cpu]

Each bench is the JAX bench's workload, with the JAX bench's values as its
keyword defaults (so that a test can run it small), on the card unless
``--device cpu`` asks for the host. Every simulation goes through the port's
main path: the ``ws_sim`` kernel (``ws_sim_cuda``, or the ``cuda`` backend
under the service) on the card; on CPU tensors the wrapper and the ``torch``
backend run the plain loop. Each function prints the JAX bench's
``name,us_per_call,derived`` CSV line and returns its rows. Files are
written only under ``--out DIR``: one CSV a bench and, in the JAX package's
schema, ``BENCH_obs_torch.json`` (with ``obs_trace.json`` and
``obs_metrics.json``), ``BENCH_check_torch.json`` and
``BENCH_fault_torch.json``; stores live in temporary directories, removed
at the end. Reps: 16, or 100 with ``--full``; the two throughput benches
take at least 32.

``main()`` knows every name of ``run.py``'s: the figure benches and
``backend_matrix`` run ``benchmarks/paper_torch.py``, ``daemon_throughput``
runs ``benchmarks/daemon_torch.py``, and ``--only roofline`` exits
non-zero: it waits for the port of the dry-run and HLO analysis (ROADMAP
Queue A 11); a run of every bench prints no row for it, only a notice on
stderr.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import daemon_torch, paper_torch  # noqa: E402
from benchmarks.paper_torch import _row, _write_csv  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import dag_gen as gen  # noqa: E402
from repro_torch.core import divisible as dv  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import sweep as sw  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.core.topology import one_cluster  # noqa: E402
from repro_torch.kernels.ws_sim import ws_sim_cuda  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _main_backend(dev: torch.device) -> str:
    """The backend a bench times: the kernel's on the card, the plain
    loop's on the host."""
    return "cuda" if dev.type == "cuda" else "torch"


#: ``on_cell(model, scn, res)``: called with each timed launch's batch and
#: its result (tensors on the bench's device)
OnCell = Optional[Callable]


def timed_launch(model, scn: eng.Scenario, on_cell: OnCell = None) -> tuple:
    """One warm launch of ``ws_sim_cuda`` on ``scn`` (after a first one that
    builds and warms): CUDA events around the launch, the wall around the
    launch and the copy of its result to the host. Returns (host result as
    a dict of numpy arrays, kernel ms or None on the CPU, wall seconds)."""
    dev = scn.W.device
    ws_sim_cuda(model, scn)
    _sync(dev)
    kernel_ms = None
    t0 = time.perf_counter()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = ws_sim_cuda(model, scn)
        end.record()
    else:
        res = ws_sim_cuda(model, scn)
    host = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        kernel_ms = start.elapsed_time(end)
    if on_cell is not None:
        on_cell(model, scn, res)
    return host, kernel_ms, wall


def _rates(name: str, host: dict, kernel_ms, wall: float, reps: int) -> dict:
    ev = int(host["n_events"].astype(np.int64).sum())
    return dict(model=name, reps=reps, events=ev, wall_s=wall,
                kernel_ms=kernel_ms, scn_per_s=reps / wall,
                events_per_s=ev / wall, us_per_scn=wall * 1e6 / reps,
                events_per_s_kernel=(ev / (kernel_ms * 1e-3)
                                     if kernel_ms else None))


def sim_throughput(reps: int, device=None, p: int = 64, W: int = 10**6,
                   lam: int = 50, on_cell: OnCell = None,
                   out: Optional[Path] = None) -> list:
    """Events per second of the divisible-load simulator: ``reps`` parallel
    simulations (seeds 1..reps) through one launch of the kernel; the
    events are summed from ``n_events``."""
    dev = eng.resolve_device(device)
    cfg = dv.EngineConfig(topology=one_cluster(p, lam),
                          max_events=dv.default_max_events(W, p, lam))
    scn = eng.batch_scenarios(W, np.arange(reps, dtype=np.uint32) + 1,
                              lam=lam, device=dev)
    host, kernel_ms, wall = timed_launch(cfg, scn, on_cell)
    row = dict(p=p, W=W, lam=lam, device=str(dev),
               **_rates("divisible", host, kernel_ms, wall, reps))
    _write_csv(out, "sim_throughput", [row])
    _row("sim_throughput", wall * 1e6 / reps,
         f"{row['events_per_s']:,.0f} events/s over {reps} parallel sims "
         f"(p={p})")
    return [row]


def model_throughput(reps: int, device=None, p: int = 32, lam: int = 10,
                     W: int = 200_000, dag=None,
                     dag_max_events: int = 1 << 20, pool_cap: int = 1 << 13,
                     on_cell: OnCell = None,
                     out: Optional[Path] = None) -> list:
    """Scenarios and events per second for each task model: ``reps``
    simulations (seeds 1..reps) a model, one launch each (``dag`` defaults
    to ``merge_sort(20000, 64)``)."""
    dev = eng.resolve_device(device)
    topo = one_cluster(p, lam)
    models = {
        "divisible": sw.make_model(
            "divisible", topology=topo,
            max_events=dv.default_max_events(W, p, lam)),
        "dag": sw.make_model(
            "dag", topology=topo,
            dag=dag if dag is not None else gen.merge_sort(20_000, 64),
            max_events=dag_max_events),
        "adaptive": sw.make_model(
            "adaptive", topology=topo, pool_cap=pool_cap,
            max_events=dv.default_max_events(W, p, lam)),
    }
    rows = []
    for name, model in models.items():
        scn = eng.batch_scenarios(W, np.arange(reps, dtype=np.uint32) + 1,
                                  lam=lam, device=dev)
        host, kernel_ms, wall = timed_launch(model, scn, on_cell)
        row = dict(p=p, device=str(dev),
                   **_rates(name, host, kernel_ms, wall, reps))
        rows.append(row)
        _row(f"model_throughput_{name}", row["us_per_scn"],
             f"{row['scn_per_s']:,.1f} scn/s; {row['events_per_s']:,.0f} "
             f"events/s (p={p})")
    _write_csv(out, "model_throughput", rows)
    return rows


def _service(root, device, **kw):
    from repro_torch.service import SimulationService
    return SimulationService(root=root, device=device, **kw)


def sched_planner(reps: int, device=None, n_pods: int = 2,
                  chips_per_pod: int = 32, dcn_delay: int = 100,
                  work_per_group: int = 4096,
                  out: Optional[Path] = None) -> list:
    """The planner's decision on a 2-pod fleet, ``plan_for_mesh`` with
    ``reps=min(reps, 12)``. The JAX bench plans on its module's service,
    whose store under ``artifacts/store`` keeps answers between runs; this
    one plans on a service of its own over a temporary store, so every run
    is cold."""
    from repro_torch.sched.planner import plan_for_mesh

    dev = eng.resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="bench_planner_")
    try:
        svc = _service(tmp, dev)
        t0 = time.perf_counter()
        dec = plan_for_mesh(n_pods=n_pods, chips_per_pod=chips_per_pod,
                            dcn_delay=dcn_delay,
                            work_per_group=work_per_group,
                            reps=min(reps, 12), service=svc)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gain = dec.baseline_makespan / max(dec.expected_makespan, 1)
    row = dict(policy=dec.strategy_name, strategy=dec.strategy,
               remote_prob=dec.remote_prob, theta_static=dec.theta_static,
               theta_comm=dec.theta_comm, mwt=dec.mwt,
               expected_makespan=dec.expected_makespan,
               baseline_makespan=dec.baseline_makespan, gain=gain,
               n_dispatches=dec.n_dispatches, significant=dec.significant,
               delta_mean=dec.delta_mean, n_paired_reps=dec.n_paired_reps,
               wall_s=wall, device=str(dev))
    _write_csv(out, "sched_planner", [row])
    _row("sched_planner", wall * 1e6,
         f"policy={dec.strategy_name}/theta=({dec.theta_static}"
         f";{dec.theta_comm})/mwt={dec.mwt}; x{gain:.2f} vs uniform")
    return [row]


def service_throughput(reps: int, device=None, p: int = 32,
                       W: int = 200_000, lams: Sequence[int] = (2, 10, 30, 50),
                       thetas: Sequence[tuple] = ((0, 0), (0, 2), (8, 0),
                                                  (16, 2)),
                       tgt_rel: float = 0.01,
                       out: Optional[Path] = None) -> list:
    """The sweep service's cold against warm queries per second, queries
    per dispatch when four θ queries share a bucket, and the replications
    an adaptive 1 % CI query spends against ``fixed_reps_for_width`` (the
    JAX bench's workload; its queries run on the service's default
    backend, ``cuda`` on the card)."""
    from repro_torch.service.estimator import fixed_reps_for_width

    dev = eng.resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="bench_store_")
    try:
        svc = _service(tmp, dev)

        def make():
            return [svc.make_query(one_cluster(p, 1), W_list=[W],
                                   lam_list=list(lams), theta=(th,),
                                   reps=reps, seed0=11)
                    for th in thetas]
        t0 = time.perf_counter()
        svc.query_many(make())
        cold_s = time.perf_counter() - t0
        d_cold = svc.n_dispatches
        t0 = time.perf_counter()
        warm_res = svc.query_many(make())
        warm_s = time.perf_counter() - t0
        d_warm = svc.n_dispatches - d_cold
        if not all(r.from_cache for r in warm_res) or d_warm:
            raise AssertionError(f"warm queries dispatched {d_warm} times")
        sizes = [d["n_queries"] for d in svc.broker.dispatch_log]
        coalesce = sum(sizes) / max(len(sizes), 1)

        t0 = time.perf_counter()
        ares = svc.query(one_cluster(p, 1), W_list=[W], lam_list=list(lams),
                         ci=tgt_rel, ci_relative=True, batch_reps=8,
                         max_reps=64 * max(reps, 16), seed0=23)
        adapt_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = ares.cells
    n_adapt = int(cells.n.sum())
    n_fixed = max(fixed_reps_for_width(float(cells.std[c]),
                                       tgt_rel * float(cells.mean[c]))
                  for c in range(len(cells))) * len(cells)
    n_q = len(thetas)
    row = dict(n_queries=n_q, cold_s=cold_s, warm_s=warm_s,
               cold_qps=n_q / cold_s, warm_qps=n_q / warm_s,
               speedup=cold_s / max(warm_s, 1e-9),
               dispatches_cold=d_cold, dispatches_warm=d_warm,
               mean_queries_per_dispatch=coalesce,
               adaptive_reps=n_adapt, fixed_reps_equiv=n_fixed,
               rep_savings=n_fixed / max(n_adapt, 1), adaptive_s=adapt_s,
               ci_rel_target=tgt_rel, device=str(dev))
    _write_csv(out, "service_throughput", [row])
    _row("service_throughput", warm_s * 1e6 / n_q,
         f"warm x{row['speedup']:.1f} vs cold ({row['warm_qps']:,.0f} vs "
         f"{row['cold_qps']:.1f} q/s); {coalesce:.2f} queries/dispatch; "
         f"adaptive {n_adapt} reps vs fixed {n_fixed} for ±{tgt_rel:.0%} CI "
         f"(x{row['rep_savings']:.2f} fewer)")
    return [row]


def paired_comparison(reps: int, device=None, p: int = 32, W: int = 10**6,
                      lam: int = 262, max_reps: Optional[int] = None,
                      out: Optional[Path] = None) -> list:
    """Paired (common random numbers) against independent A/B arms: the
    replications a significant verdict on two small policy gaps (SWT vs
    MWT, θ_comm 0 vs 2) costs, against ``n >= (z·sqrt(var_A +
    var_B)/|delta|)²`` independent pairs. ``max_reps`` defaults to the JAX
    bench's ``64 * max(reps, 16)``."""
    from repro_torch.service import PairedPolicy
    from repro_torch.service.estimator import z_value

    dev = eng.resolve_device(device)
    max_reps = 64 * max(reps, 16) if max_reps is None else max_reps
    topo = one_cluster(p, lam)
    arms = {
        "swt_vs_mwt": (dict(mwt=False), dict(mwt=True)),
        "theta0_vs_theta2": (dict(theta=((0, 0),)), dict(theta=((0, 2),))),
    }
    rows = []
    tmp = tempfile.mkdtemp(prefix="bench_paired_")
    t0 = time.perf_counter()
    try:
        svc = _service(tmp, dev)
        for name, (kw_a, kw_b) in arms.items():
            base = dict(W_list=[W], lam_list=[lam], reps=8, seed0=31)
            qa = svc.make_query(topo, **{**base, **kw_a})
            qb = svc.make_query(topo, **{**base, **kw_b})
            pc = svc.query_pair(qa, qb, policy=PairedPolicy(
                batch_reps=8, min_reps=8, max_reps=max_reps)).paired
            n_paired = int(pc.n[0])
            delta = float(pc.delta_mean[0])
            var_sum = float(pc.var_a[0] + pc.var_b[0])
            z = z_value(pc.confidence)
            n_indep = int(np.ceil(z * z * var_sum
                                  / max(delta * delta, 1e-12))) \
                if pc.significant[0] else np.inf
            rows.append(dict(
                pair=name, p=p, W=W, lam=lam, delta=delta,
                delta_hw=float(pc.delta_half_width[0]),
                indep_hw_same_n=float(pc.independent_half_width()[0]),
                significant=bool(pc.significant[0]),
                n_paired=n_paired, n_indep_equiv=n_indep,
                savings=n_indep / max(n_paired, 1)
                if np.isfinite(n_indep) else "", device=str(dev)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    us = (time.perf_counter() - t0) * 1e6 / len(rows)
    _write_csv(out, "paired_comparison", rows)
    sig = [r for r in rows if r["significant"] and r["savings"] != ""]
    med = float(np.median([r["savings"] for r in sig])) if sig else 0.0
    _row("paired_comparison", us,
         f"{len(sig)}/{len(rows)} gaps significant; paired needs "
         f"x{med:.1f} fewer reps than independent arms")
    return rows


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def obs_overhead(reps: int, device=None, p: int = 16, W: int = 30_000,
                 lams: Sequence[int] = (2, 6, 20), n_timed: int = 5,
                 out: Optional[Path] = None) -> dict:
    """Cost of the observability layer on ``backend_matrix``'s grid:
    tracer-enabled against disabled rows/s, best of ``n_timed`` alternated
    runs, then a traced cold and warm service query for the cache-hit
    ratio. The JAX bench times its ``jax`` backend; this one times ``cuda``,
    the port's main backend (``torch`` on the host). ``cuda`` does not
    segment, so ``wasted_frac_actual`` comes from one run of the same rows
    on the segmented ``torch`` backend."""
    dev = eng.resolve_device(device)
    bname = _main_backend(dev)
    n_reps = max(reps + 6, 22)    # >= 66 rows: backend_matrix's convoy grid
    rows = sw.grid_rows([W], lams, n_reps)
    model = sw.resolve_model(one_cluster(p, 1), "divisible", W_list=[W],
                             lam_list=lams, pow2_max_events=True)

    def run():
        sw.run_rows(model, rows, backend=bname, device=dev)
        _sync(dev)
    run()                                    # build + warm
    offs, ons = [], []
    for _ in range(n_timed):
        offs.append(_seconds(run))
        with obs.trace_to() as tracer:
            ons.append(_seconds(run))
    dt_off, dt_on = min(offs), min(ons)
    n_events = len(tracer)
    overhead = dt_on / dt_off - 1.0
    sw.run_rows(model, rows, backend="torch", device=dev)
    wasted = get_backend("torch").last_stats

    tmp = tempfile.mkdtemp(prefix="bench_obs_")
    try:
        svc = _service(tmp, dev, metrics=obs.MetricsRegistry())
        qkw = dict(W_list=[W], lam_list=list(lams), reps=min(n_reps, 16),
                   seed0=7, backend=bname)
        trace_path = None if out is None else out / "obs_trace.json"
        if out is not None:
            out.mkdir(parents=True, exist_ok=True)
        with obs.trace_to(trace_path) as qtr:
            svc.query(one_cluster(p, 1), **qkw)    # cold: dispatches
            svc.query(one_cluster(p, 1), **qkw)    # warm: store hit
        snap = svc.stats()["metrics"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c = snap["counters"]
    hits = c.get("store.hits_mem", 0) + c.get("store.hits_disk", 0)
    lookups = hits + c.get("store.misses", 0)
    doc = dict(
        n_rows=len(rows), backend=bname, device=str(dev),
        disabled_rows_per_s=len(rows) / dt_off,
        enabled_rows_per_s=len(rows) / dt_on,
        overhead_frac=overhead, n_trace_events=n_events,
        trace_query_spans=len(qtr.durations_ms()),
        cache_hit_ratio=hits / lookups if lookups else None,
        wasted_frac_actual=wasted.wasted_frac if wasted else None)
    _write_csv(out, "obs_overhead", [doc])
    if out is not None:
        with open(out / "obs_metrics.json", "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        with open(out / "BENCH_obs_torch.json", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    _row("obs_overhead", dt_on * 1e6 / len(rows),
         f"tracer overhead {overhead:+.1%} ({doc['enabled_rows_per_s']:,.0f}"
         f" vs {doc['disabled_rows_per_s']:,.0f} rows/s on {bname}, "
         f"{n_events} events; target <3%); "
         f"cache_hit_ratio={doc['cache_hit_ratio']}")
    return doc


#: the sanitizer's replay sampling in the bench: one dispatch in 16
REPLAY_DENOM = 16


def sanitized_grids(reps: int, p: int = 16, W: int = 30_000,
                    lams: Sequence[int] = (2, 6, 20)):
    """The JAX bench's sixteen grids, exactly one of them in the 1-in-16
    replay sample (xor-folded seeds): (model, grids)."""
    denom = REPLAY_DENOM
    n_reps = max(reps + 6, 22)

    def sampled(cand) -> bool:
        seeds = np.asarray(cand.seed, dtype=np.uint32)
        return int(np.bitwise_xor.reduce(seeds)) % denom == 0

    grids = [sw.grid_rows([W], lams, n_reps, seed0=s)
             for s in range(1, denom + 1)]
    if not any(sampled(g) for g in grids):
        hit = None
        for nr in range(n_reps, n_reps + 4):
            for seed0 in range(1, 65):
                cand = sw.grid_rows([W], lams, nr, seed0=seed0)
                if sampled(cand):
                    hit = cand
                    break
            if hit is not None:
                break
        if hit is not None:
            grids[0] = hit
    model = sw.resolve_model(one_cluster(p, 1), "divisible", W_list=[W],
                             lam_list=lams, pow2_max_events=True)
    return model, grids


def sanitizer_overhead(reps: int, device=None, p: int = 16, W: int = 30_000,
                       lams: Sequence[int] = (2, 6, 20), n_timed: int = 5,
                       out: Optional[Path] = None) -> dict:
    """Cost of the determinism sanitizer (replay 1/16 of the dispatches, 2
    rows each, through the numpy oracle) on ``obs_overhead``'s workload:
    sixteen grids, one of them sampled, armed against disarmed, best of
    ``n_timed`` alternated runs. Timed on ``cuda``, the port's main backend
    (the JAX bench times ``jax``; ``torch`` on the host)."""
    from repro_torch.check import sanitizer as san

    dev = eng.resolve_device(device)
    bname = _main_backend(dev)
    denom = REPLAY_DENOM
    model, grids = sanitized_grids(reps, p, W, lams)
    n_rows = sum(len(g) for g in grids)

    def run():
        for g in grids:
            sw.run_rows(model, g, backend=bname, device=dev)
        _sync(dev)
    run()                                    # build + warm
    offs, ons = [], []
    try:
        for _ in range(n_timed):
            san.uninstall()
            offs.append(_seconds(run))
            san.install(replay_denom=denom, replay_rows=2)
            san.reset()
            ons.append(_seconds(run))
        summ = san.summary()
    finally:
        san.uninstall()
        san.reset()
    dt_off, dt_on = min(offs), min(ons)
    overhead = dt_on / dt_off - 1.0
    doc = dict(
        n_rows=n_rows, backend=bname, device=str(dev),
        disarmed_rows_per_s=n_rows / dt_off, armed_rows_per_s=n_rows / dt_on,
        overhead_frac=overhead, replay_denom=denom,
        n_dispatch_probes=summ["n_dispatch_probes"],
        n_replayed_dispatches=summ["n_replayed_dispatches"],
        n_replayed_rows=summ["n_replayed_rows"],
        violations_total=summ["violations_total"])
    _write_csv(out, "sanitizer_overhead", [doc])
    if out is not None:
        with open(out / "BENCH_check_torch.json", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    _row("sanitizer_overhead", dt_on * 1e6 / n_rows,
         f"sanitizer overhead {overhead:+.1%} ({doc['armed_rows_per_s']:,.0f}"
         f" vs {doc['disarmed_rows_per_s']:,.0f} rows/s on {bname}; target "
         f"<5%); replayed {summ['n_replayed_rows']} rows in "
         f"{summ['n_replayed_dispatches']} dispatches; "
         f"violations={summ['violations_total']}")
    return doc


#: the fault rates of the JAX bench
FAULT_RATES = (0.0, 0.05, 0.20)
#: attempts a dispatch gets on the card, where transient faults must heal
CARD_ATTEMPTS = 8


def fault_recovery(reps: int, device=None, p: int = 8, W: int = 20_000,
                   n_queries: Optional[int] = None,
                   out: Optional[Path] = None) -> dict:
    """Per-query latency (p50/p99) and the recovery counters at each
    injected fault rate; one query of one row a flush, ``n_queries`` of them
    (the JAX bench's ``max(3 * reps, 48)``), after a fault-free warm-up.

    On the host this is the JAX bench's workload as it is: ``per_row``
    faults on the ``torch`` backend with one attempt a dispatch, so a
    poisoned row fails on every try and is demoted to ``oracle``, as the
    JAX chain demotes ``jax``. On the card the device rule makes the chain
    ``cuda`` alone (``service/resilience.py``): a poisoned row fails on
    every attempt and raises once bisection isolates it, so that workload
    cannot heal there and no host fallback is added to make it. The card's
    run injects the same rates as per-call transient faults on ``cuda``
    with up to :data:`CARD_ATTEMPTS` attempts a dispatch, which heal on
    the card alone: it measures retries, not demotion. ``client_errors``
    counts the queries that raised (0 on a healthy run)."""
    from repro_torch.service import resilience as rz

    dev = eng.resolve_device(device)
    bname = _main_backend(dev)
    on_card = bname == "cuda"           # a chain of one: no demotion
    topo = one_cluster(p, 1)
    n_q = max(3 * reps, 48) if n_queries is None else n_queries
    cfg = rz.ResilienceConfig(
        retry=rz.RetryPolicy(max_attempts=CARD_ATTEMPTS if on_card else 1,
                             base_s=0.0, cap_s=0.0),
        breaker_failures=1 << 30)   # keep bisecting instead of tripping
    rows, per_rate = [], {}
    for rate in FAULT_RATES:
        plan = rz.FaultPlan(rng_seed=11, sites={
            "backend.run_rows": rz.Prob(rate, kind="raise",
                                        per_row=not on_card,
                                        match={"backend": bname})})
        tmp = tempfile.mkdtemp(prefix="bench_fault_")
        try:
            svc = _service(tmp, dev, metrics=obs.MetricsRegistry(),
                           resilience=cfg)

            def mk(s):
                return svc.make_query(topo, W_list=[W], lam_list=[3],
                                      reps=1, seed0=s, backend=bname)
            with rz.fault_plan(rz.no_faults()):
                svc.query_many([mk(0)])          # warm-up, fault-free
            lats, errors = [], 0
            with rz.fault_plan(plan):
                for s in range(1, n_q + 1):
                    t0 = time.perf_counter()
                    try:
                        svc.query_many([mk(s)])
                    except Exception:            # noqa: BLE001 — counted
                        errors += 1
                    lats.append((time.perf_counter() - t0) * 1e3)
            deg = svc.stats()["degraded"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        entry = dict(
            fault_rate=rate, n_queries=n_q,
            p50_ms=float(np.percentile(lats, 50)),
            p99_ms=float(np.percentile(lats, 99)),
            retries=int(deg["retries"]), fallbacks=int(deg["fallbacks"]),
            salvaged_rows=int(deg["salvaged_rows"]),
            dispatch_failures=int(deg["dispatch_failures"]),
            client_errors=errors)
        rows.append(entry)
        per_rate[f"{rate:g}"] = entry
    doc = {"engine_version": eng.ENGINE_VERSION,
           "workload": dict(p=p, W=W, n_queries=n_q, backend=bname,
                            device=str(dev),
                            faults="transient per call" if on_card
                            else "per row"),
           "rates": per_rate}
    _write_csv(out, "fault_recovery", rows)
    if out is not None:
        with open(out / "BENCH_fault_torch.json", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    clean, worst = rows[0], rows[-1]
    _row("fault_recovery", worst["p99_ms"] * 1e3,
         f"p99 {clean['p99_ms']:.1f}ms@{clean['fault_rate']:.0%} -> "
         f"{worst['p99_ms']:.1f}ms@{worst['fault_rate']:.0%} "
         f"({worst['fallbacks']} fallbacks, {worst['retries']} retries, "
         f"{sum(r['client_errors'] for r in rows)} client errors)")
    return doc


#: the benches this file ports, in ``run.py``'s order
BENCHES = ("sim_throughput", "model_throughput", "sched_planner",
           "service_throughput", "paired_comparison", "obs_overhead",
           "sanitizer_overhead", "fault_recovery")
#: every name of ``run.py``'s ``main()``
ALL_NAMES = paper_torch.BENCHES[:5] + BENCHES[:5] + (
    "backend_matrix", "obs_overhead", "sanitizer_overhead", "fault_recovery",
    "daemon_throughput", "roofline")


ROOFLINE_WAITS = ("roofline waits for ROADMAP Queue A 11: the port of "
                  "launch/dryrun.py and launch/hlo_analysis.py")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale reps (100)")
    ap.add_argument("--only", default=None, choices=ALL_NAMES)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the CSVs and the BENCH_*.json")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card; 'cpu' asks for "
                         "the host)")
    args = ap.parse_args(argv)
    if args.only == "roofline":
        sys.exit(ROOFLINE_WAITS)
    reps = 100 if args.full else 16
    kw = dict(device=args.device, out=args.out)
    runs = {
        "fig10_overhead_ratio": lambda: paper_torch.fig10_overhead_ratio(
            reps, **kw),
        "fig11_accept_latency": lambda: paper_torch.fig11_accept_latency(
            reps, **kw),
        "fig12_mwt_swt": lambda: paper_torch.fig12_mwt_swt(reps, args.full,
                                                           **kw),
        "steal_threshold": lambda: paper_torch.steal_threshold(reps, **kw),
        "multicluster": lambda: paper_torch.multicluster(reps, **kw),
        "sim_throughput": lambda: sim_throughput(max(reps, 32), **kw),
        "model_throughput": lambda: model_throughput(max(reps, 32), **kw),
        "sched_planner": lambda: sched_planner(reps, **kw),
        "service_throughput": lambda: service_throughput(reps, **kw),
        "paired_comparison": lambda: paired_comparison(reps, **kw),
        "backend_matrix": lambda: paper_torch.backend_matrix(reps, **kw),
        "obs_overhead": lambda: obs_overhead(reps, **kw),
        "sanitizer_overhead": lambda: sanitizer_overhead(reps, **kw),
        "fault_recovery": lambda: fault_recovery(reps, **kw),
        "daemon_throughput": lambda: daemon_torch.daemon_throughput(**kw),
    }
    print("name,us_per_call,derived")
    for name in ALL_NAMES:
        if name == "roofline":
            if args.only is None:            # not run: no row, a notice
                print(ROOFLINE_WAITS, file=sys.stderr)
        elif args.only in (None, name):
            runs[name]()


if __name__ == "__main__":
    main()
