#!/usr/bin/env python3
"""The paper's figure benches on the PyTorch/CUDA port: the twins of
``benchmarks/run.py``'s ``fig10_overhead_ratio``, ``fig11_accept_latency``,
``fig12_mwt_swt``, ``steal_threshold``, ``multicluster`` and
``backend_matrix``.

    python3 benchmarks/paper_torch.py [--full] [--only NAME] [--out DIR]

Each figure function builds the same scenario batches as the JAX bench (the
same grids, the seeds ``arange(reps) + 1/3/5/1/7``, the same ``theta_comm``,
latencies and ``remote_prob``) and runs every batch through the ``ws_sim``
kernel (``kernels.ws_sim.ws_sim_cuda``), one launch a cell; on CPU tensors
(``device="cpu"``) the wrapper runs its plain version instead. The analysis
is the float64 numpy of ``core/analysis.py``, so the rows equal the JAX
bench's. Each function prints its ``name,us_per_call,derived`` CSV line and
returns its rows; ``--out DIR`` also writes one CSV a bench (and
``BENCH_backends_torch.json``). Reduced repetitions by default; ``--full``
runs the paper-scale 100 and W=10^8 for Fig 12. Runs on the card; needs
one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ws_paper  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import divisible as dv  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.kernels.ws_sim import ws_sim_cuda  # noqa: E402

#: ``on_cell(cfg, scn, res)``: called with each cell's batch and its result
OnCell = Optional[Callable]


def _row(name: str, us: float, derived: str):
    print(f"{name},{us:.1f},{derived}", flush=True)


def _write_csv(out: Optional[Path], name: str, rows):
    if out is None or not rows:
        return
    out.mkdir(parents=True, exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(out / f"{name}.csv", "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def _seeds(reps: int, k: int) -> np.ndarray:
    return np.arange(reps, dtype=np.uint32) + k


def simulate_cell(cfg: dv.EngineConfig, W: int, seeds: np.ndarray, device,
                  on_cell: OnCell = None, **kw):
    """One cell: the JAX bench's ``batch_scenarios`` batch, one launch of
    the kernel. Returns the result (tensors on ``device``)."""
    scn = eng.batch_scenarios(W, seeds, device=device, **kw)
    res = ws_sim_cuda(cfg, scn)
    if on_cell is not None:
        on_cell(cfg, scn, res)
    return res


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def fig10_overhead_ratio(reps: int, grid: Optional[ws_paper.PaperGrid] = None,
                         device=None, on_cell: OnCell = None,
                         out: Optional[Path] = None) -> list:
    """Paper §4.1: bound/simulated overhead (4-5.5x), fitted constant (3.8).
    ``grid`` (its cells; ``reps`` sets the repetitions) defaults to
    ``ws_paper.grid()``, the JAX bench's grid."""
    dev = eng.resolve_device(device)
    grid = grid or ws_paper.grid()
    rows = []
    t0 = time.time()
    for W, p, lam in grid.cells():
        topo = T.one_cluster(p, 1)
        cfg = dv.EngineConfig(topology=topo,
                              max_events=dv.default_max_events(W, p, lam))
        res = simulate_cell(cfg, W, _seeds(reps, 1), dev, on_cell, lam=lam)
        ms = _host(res.makespan)
        r = analysis.summarize(analysis.overhead_ratio(ms, W, p, lam))
        c = analysis.summarize(analysis.fitted_constant(ms, W, p, lam))
        rows.append(dict(p=p, W=W, lam=lam, ratio_med=r["median"],
                         ratio_q1=r["q1"], ratio_q3=r["q3"],
                         fit_med=c["median"]))
    us = (time.time() - t0) * 1e6 / len(rows)
    med = float(np.median([r["ratio_med"] for r in rows]))
    fit = float(np.median([r["fit_med"] for r in rows]))
    _write_csv(out, "fig10_overhead_ratio", rows)
    _row("fig10_overhead_ratio", us,
         f"median_ratio={med:.2f} (paper 4-5.5); fit_c={fit:.2f} (paper 3.8)")
    return rows


def fig11_accept_latency(reps: int, p_list: Sequence[int] = (32, 64),
                         W_list: Sequence[int] = (10**5, 10**6, 10**7),
                         device=None, on_cell: OnCell = None,
                         out: Optional[Path] = None) -> list:
    """Paper §4.2: the acceptable-latency law W/p ≈ 470·λ."""
    dev = eng.resolve_device(device)
    rows = []
    t0 = time.time()
    for p in p_list:
        topo = T.one_cluster(p, 1)
        for W in W_list:
            lam_th = analysis.theoretical_limit_latency(W, p)
            by_lam = {}
            for lam in np.unique(np.linspace(max(lam_th * 0.4, 1),
                                             lam_th * 2.2, 8).astype(int)):
                cfg = dv.EngineConfig(
                    topology=topo,
                    max_events=dv.default_max_events(W, p, int(lam)))
                res = simulate_cell(cfg, W, _seeds(reps, 3), dev, on_cell,
                                    lam=int(lam))
                by_lam[int(lam)] = _host(res.makespan)
            lam_exp = analysis.experimental_limit_latency(by_lam, W, p)
            rows.append(dict(p=p, W=W, lam_theory=lam_th, lam_exp=lam_exp,
                             ratio=(W / p) / max(lam_exp, 1)))
    us = (time.time() - t0) * 1e6 / len(rows)
    med = float(np.median([r["ratio"] for r in rows]))
    _write_csv(out, "fig11_accept_latency", rows)
    _row("fig11_accept_latency", us, f"(W/p)/lam*={med:.0f} (paper ~470)")
    return rows


def fig12_mwt_swt(reps: int, full: bool,
                  p_list: Sequence[int] = (16, 32, 64, 128),
                  W: Optional[int] = None, device=None,
                  on_cell: OnCell = None, out: Optional[Path] = None) -> list:
    """Paper §4.3: MWT's startup speedup against its flat overall effect;
    W = 10^8 with ``full``, else 10^6, unless ``W`` is given."""
    dev = eng.resolve_device(device)
    rows = []
    if W is None:
        W = 10**8 if full else 10**6
    lam = 262
    t0 = time.time()
    for p in p_list:
        topo = T.one_cluster(p, lam)
        res_by = {}
        for mwt in (False, True):
            cfg = dv.EngineConfig(
                topology=topo, mwt=mwt,
                max_events=dv.default_max_events(W, p, lam))
            res = simulate_cell(cfg, W, _seeds(reps, 5), dev, on_cell,
                                lam=lam)
            res_by[mwt] = (_host(res.makespan), _host(res.startup_end))
        su = float(np.median(res_by[False][1]) / np.median(res_by[True][1]))
        ov = float(np.median(res_by[False][0]) / np.median(res_by[True][0]))
        rows.append(dict(p=p, W=W, lam=lam, startup_speedup=su,
                         overall_speedup=ov))
    us = (time.time() - t0) * 1e6 / len(rows)
    _write_csv(out, "fig12_mwt_swt", rows)
    best = max(r["startup_speedup"] for r in rows)
    flat = float(np.median([r["overall_speedup"] for r in rows]))
    _row("fig12_mwt_swt", us,
         f"startup_speedup<= x{best:.2f}; overall x{flat:.2f} (paper: flat)")
    return rows


def steal_threshold(reps: int,
                    cases: Sequence[tuple] = ((8, 482), (32, 262),
                                              (64, 482), (128, 262)),
                    W: int = 10**6, device=None, on_cell: OnCell = None,
                    out: Optional[Path] = None) -> list:
    """Paper §2.4.2 / Fig 3: a communication-dependent steal threshold
    against 'artificial idle times' at high latency; ``cases`` are (p, λ)."""
    dev = eng.resolve_device(device)
    rows = []
    t0 = time.time()
    for p, lam in cases:
        topo = T.one_cluster(p, lam)
        med = {}
        for tc in (0, 1, 2, 4):
            cfg = dv.EngineConfig(
                topology=topo, max_events=dv.default_max_events(W, p, lam))
            res = simulate_cell(cfg, W, _seeds(reps, 1), dev, on_cell,
                                lam=lam, theta_comm=tc)
            med[tc] = float(np.median(_host(res.makespan)))
        best_tc = min(med, key=med.get)
        rows.append(dict(p=p, lam=lam, base=med[0], best_theta_comm=best_tc,
                         gain=med[0] / med[best_tc],
                         **{f"ms_tc{t}": med[t] for t in med}))
    us = (time.time() - t0) * 1e6 / len(rows)
    _write_csv(out, "steal_threshold", rows)
    gain = float(np.median([r["gain"] for r in rows]))
    _row("steal_threshold", us,
         f"comm-scaled threshold gains x{gain:.3f} median at high lambda "
         f"(paper Fig 3: prevents artificial idle times)")
    return rows


def multicluster(reps: int,
                 scenarios: Sequence[tuple] = ws_paper.MULTICLUSTER_SCENARIOS,
                 W: int = 10**6, device=None, on_cell: OnCell = None,
                 out: Optional[Path] = None) -> list:
    """WS overhead across multi-cluster topologies × victim strategies
    (paper §1.1): locality-aware stealing (LOCAL_FIRST) against uniform;
    ``scenarios`` as ``ws_paper.MULTICLUSTER_SCENARIOS``."""
    dev = eng.resolve_device(device)
    rows = []
    t0 = time.time()
    for (k, m, lam_r, inter) in scenarios:
        p = k * m
        for strat, rp in ((T.UNIFORM, 0.25), (T.LOCAL_FIRST, 0.1)):
            topo = (T.multi_cluster(k, m, lam_r, inter=inter)
                    .with_strategy(strat, remote_prob=rp))
            cfg = dv.EngineConfig(
                topology=topo,
                max_events=dv.default_max_events(W, p, lam_r))
            res = simulate_cell(cfg, W, _seeds(reps, 7), dev, on_cell,
                                lam_local=1, lam_remote=lam_r,
                                remote_prob=rp)
            med = float(np.median(_host(res.makespan)))
            rows.append(dict(clusters=k, per_cluster=m, lam_remote=lam_r,
                             inter=inter, strategy=T.strategy_name(strat),
                             median_makespan=med,
                             overhead=med - W / p,
                             fail_frac=float(np.mean(
                                 _host(res.n_fail)
                                 / np.maximum(_host(res.n_requests), 1)))))
    us = (time.time() - t0) * 1e6 / len(rows)
    _write_csv(out, "multicluster", rows)
    gains = []
    for i in range(0, len(rows), 2):
        gains.append(rows[i]["overhead"] / max(rows[i + 1]["overhead"], 1))
    _row("multicluster", us,
         f"local_first cuts WS overhead x{float(np.median(gains)):.2f} "
         f"(median over {len(gains)} fleet topologies)")
    return rows


def backend_matrix(reps: int, device=None, out: Optional[Path] = None,
                   p: int = 16, W: int = 30_000,
                   lams: Sequence[int] = (2, 6, 20)) -> dict:
    """One grid (by default ``BENCH_backends.json``'s: p=16, W=30000,
    λ∈{2,6,20}, 22 reps = 66 rows) on every backend of the port: rows/s,
    bit-parity of every column with the oracle, and the wasted-lane
    accounting: ``wasted_frac_convoy`` is the share of row-steps one
    monolithic batch spends on finished rows, ``1 − sum(events) / (n_rows ×
    max(events))``; the torch backend's ``wasted_frac_actual`` is what is
    left of it under the segmented loop. ``cuda`` does not segment. Returns
    the JSON document it prints."""
    from repro_torch.core import sweep as sw
    from repro_torch.core.backend import (backend_names, default_backend_name,
                                          get_backend)

    dev = eng.resolve_device(device)
    n_reps = max(reps + 6, 22)    # >= 66 rows: the convoy regime (batch >= 64)
    topo = T.one_cluster(p, 1)
    rows = sw.grid_rows([W], lams, n_reps)
    model = sw.resolve_model(topo, "divisible", W_list=[W], lam_list=lams,
                             pow2_max_events=True)
    ref = None
    out_rows = []
    for name in backend_names():
        be = get_backend(name)
        caps = be.capabilities()
        if not caps.available or (dev.type not in caps.devices
                                  and name != "oracle"):
            out_rows.append(dict(backend=name, available=False,
                                 note=caps.note or f"no {dev.type} form"))
            continue

        def run():
            return sw.run_rows(model, rows, backend=name, device=dev)
        run()                                # build + warm
        t0 = time.time()
        g = run()
        dt = max(time.time() - t0, 1e-9)
        if ref is None:
            ref = g                          # the oracle: the first backend
            ev = g.extras["n_events"].astype(np.float64)
            convoy = 1.0 - ev.sum() / (len(rows) * ev.max())
        rec = dict(
            backend=name, available=True, kind=caps.kind,
            devices="+".join(caps.devices), n_rows=len(rows),
            n_devices=caps.n_devices,
            rows_per_s=round(len(rows) / dt, 2),
            events_per_s=round(float(g.extras["n_events"].sum()) / dt, 1),
            us_per_row=round(dt * 1e6 / len(rows), 1),
            wasted_frac_convoy=round(convoy, 4),
            parity_vs_oracle=grids_equal(g, ref))
        if name == "torch" and be.last_stats is not None:
            st = be.last_stats
            rec.update(wasted_frac_actual=round(st.wasted_frac, 4),
                       n_segments=st.n_segments,
                       n_compactions=st.n_compactions,
                       segment_len=caps.segment_len,
                       segment_stats=dataclasses.asdict(st))
        out_rows.append(rec)
    doc = {"engine_version": eng.ENGINE_VERSION,
           "default_backend": default_backend_name(),
           "device": str(dev),
           "grid": dict(p=p, W=W, lams=list(lams), reps=n_reps,
                        n_rows=len(rows)),
           "backends": out_rows}
    _write_csv(out, "backend_matrix", out_rows)
    if out is not None:
        with open(out / "BENCH_backends_torch.json", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    print(json.dumps(doc, sort_keys=True), flush=True)
    ran = [r for r in out_rows if r.get("available")]
    bad = [r["backend"] for r in ran if not r["parity_vs_oracle"]]
    fastest = max(ran, key=lambda r: r["rows_per_s"])
    _row("backend_matrix", fastest["us_per_row"],
         f"{len(ran)}/{len(out_rows)} backends available; parity "
         f"{'OK' if not bad else 'FAIL ' + ','.join(bad)}; fastest "
         f"{fastest['backend']} at {fastest['rows_per_s']:,.0f} rows/s")
    return doc


def grids_equal(a, b) -> bool:
    """Every column of two GridResults, extras included, bit for bit."""
    same = all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a)
               if f.name not in ("p", "extras"))
    return same and list(a.extras) == list(b.extras) and all(
        np.array_equal(a.extras[k], b.extras[k]) for k in a.extras)


BENCHES = ("fig10_overhead_ratio", "fig11_accept_latency", "fig12_mwt_swt",
           "steal_threshold", "multicluster", "backend_matrix")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale reps (100) and W=10^8 for Fig 12")
    ap.add_argument("--only", default=None, choices=BENCHES)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for one CSV a bench")
    args = ap.parse_args(argv)
    reps = 100 if args.full else 16
    runs = {
        "fig10_overhead_ratio": lambda: fig10_overhead_ratio(reps,
                                                             out=args.out),
        "fig11_accept_latency": lambda: fig11_accept_latency(reps,
                                                             out=args.out),
        "fig12_mwt_swt": lambda: fig12_mwt_swt(reps, args.full, out=args.out),
        "steal_threshold": lambda: steal_threshold(reps, out=args.out),
        "multicluster": lambda: multicluster(reps, out=args.out),
        "backend_matrix": lambda: backend_matrix(reps, out=args.out),
    }
    print("name,us_per_call,derived")
    for name in BENCHES:
        if args.only in (None, name):
            runs[name]()


if __name__ == "__main__":
    main()
