"""Reproduce the paper's §4 experiments on the PyTorch/CUDA port at reduced
repetition count (the twin of ``examples/paper_sweep.py``).

Fig 10: overhead ratio 4-5.5x; fitted constant ~3.8.
Fig 11: acceptable-latency law  W/p ~= 470*lambda.
Fig 12/14: MWT vs SWT: startup-phase speedup, flat overall gain.

Fig 10 runs through the sweep *service*'s query path: each table cell is
adaptively replicated until E[Cmax] has a 1% confidence interval, and the
printed table carries the CI columns plus median/p10/p90 from the streaming
P² estimator. The MWT-vs-SWT comparison is a paired common-random-numbers
A/B query. Every simulation runs through the ``ws_sim`` kernel on the card
(the service's default backend there, or a direct launch); rerunning this
script answers every service cell from the content-addressed store. The
functions take ``device="cpu"`` (or a CPU service), where the kernel's
plain version runs. The paper-scale grid and the figure benches are in
``benchmarks/paper_torch.py``.

  PYTHONPATH=src python examples/paper_sweep_torch.py
"""
import numpy as np

from repro_torch import obs
from repro_torch.core import analysis, engine as eng, one_cluster
from repro_torch.core import divisible as dv
from repro_torch.kernels.ws_sim import ws_sim_cuda
from repro_torch.service import PairedPolicy, SimulationService


def overhead_and_fit(service=None, rel_hw=0.01):
    print("=== Fig 10: overhead ratio + fitted constant "
          f"(adaptive, ±{rel_hw:.0%} CI on E[Cmax]; "
          "p10/med/p90 via streaming P²) ===")
    svc = service or SimulationService()
    ratios_all, fits_all, total_reps = [], [], 0
    for p in (32, 64):
        topo = one_cluster(p, 1)
        res = svc.query(topo, W_list=[10**5, 10**6, 10**7],
                        lam_list=[2, 62, 262], ci=rel_hw, ci_relative=True,
                        batch_reps=8, max_reps=96, seed0=1)
        cells = res.cells
        total_reps += int(cells.n.sum())
        p10 = cells.quantile(0.1)
        p50 = cells.quantile(0.5)
        p90 = cells.quantile(0.9)
        for c in range(len(cells)):
            W, lam = int(cells.W[c]), int(cells.lam_remote[c])
            mean, hw, n = cells.mean[c], cells.half_width[c], int(cells.n[c])
            # ratio/fit are affine in Cmax, so the CI transfers directly.
            r = analysis.overhead_ratio(mean, W, p, lam)
            r_hw = r - analysis.overhead_ratio(mean + hw, W, p, lam)
            fit = analysis.fitted_constant(mean, W, p, lam)
            ratios_all.append(float(r))
            fits_all.append(float(fit))
            print(f"  p={p:3d} W=1e{int(np.log10(W))} lam={lam:3d}: "
                  f"Cmax={mean:12.1f} ±{hw:8.1f} (n={n:3d})  "
                  f"p10/med/p90={p10[c]:10.0f}/{p50[c]:10.0f}/{p90[c]:10.0f}  "
                  f"ratio={r:5.2f}±{abs(r_hw):4.2f} fit_c={fit:5.2f}")
    print(f"  => median overhead ratio {np.median(ratios_all):.2f} "
          f"(paper: 4-5.5); fitted constant {np.median(fits_all):.2f} "
          f"(paper: 3.8); {total_reps} adaptive replications")
    return ratios_all, fits_all


def acceptable_latency(reps=16, device=None):
    """The JAX example's cells and seeds (``arange(reps) + 3``), one launch
    of the kernel a cell; returns {W: experimental λ*}."""
    dev = eng.resolve_device(device)
    print("\n=== Fig 11: acceptable latency (overhead <= 10%) ===")
    p = 32
    topo = one_cluster(p, 1)
    out = {}
    for W in (10**5, 10**6, 10**7):
        lam_th = analysis.theoretical_limit_latency(W, p)
        by_lam = {}
        for lam in np.unique(np.linspace(max(lam_th * 0.4, 1), lam_th * 2.2,
                                         8).astype(int)):
            cfg = dv.EngineConfig(
                topology=topo, max_events=dv.default_max_events(W, p, int(lam)))
            scn = eng.batch_scenarios(W, np.arange(reps, dtype=np.uint32) + 3,
                                      lam=int(lam), device=dev)
            by_lam[int(lam)] = ws_sim_cuda(cfg, scn).makespan.cpu().numpy()
        lam_exp = analysis.experimental_limit_latency(by_lam, W, p)
        out[W] = lam_exp
        print(f"  W=1e{int(np.log10(W))}: theoretical lam*={lam_th:7.1f} "
              f"experimental lam*={lam_exp:7.1f} "
              f"(W/p)/lam*={(W / p) / max(lam_exp, 1):6.0f} (paper: ~470)")
    return out


def mwt_vs_swt(service=None, reps=24):
    """Fig 12/14 as a paired CRN A/B query: arm A = SWT, arm B = MWT, both
    simulating the *same* seed streams, replicated until the CI on the
    per-seed makespan difference resolves the verdict (or the budget ends).
    """
    print("\n=== Fig 12/14: MWT vs SWT (paired CRN A/B) ===")
    svc = service or SimulationService()
    W, lam = 10**6, 262
    out = []
    for p in (16, 32, 64):
        topo = one_cluster(p, lam)
        q_swt = svc.make_query(topo, W_list=[W], lam_list=[lam], reps=reps,
                               seed0=5, mwt=False)
        q_mwt = svc.make_query(topo, W_list=[W], lam_list=[lam], reps=reps,
                               seed0=5, mwt=True)
        res = svc.query_pair(q_swt, q_mwt, policy=PairedPolicy(
            batch_reps=8, min_reps=8, max_reps=4 * reps))
        pc = res.paired
        ms_gain = float(pc.mean_a[0] / pc.mean_b[0])
        su_gain = float(np.mean(res.grid_a.startup_end)
                        / np.mean(res.grid_b.startup_end))
        verdict = ("MWT faster" if pc.delta_mean[0] > 0 else "SWT faster") \
            if pc.significant[0] else "no significant gap"
        out.append(res)
        print(f"  p={p:3d}: startup speedup x{su_gain:4.2f} "
              f"overall speedup x{ms_gain:4.2f}; "
              f"dCmax={pc.delta_mean[0]:8.1f} ±{pc.delta_half_width[0]:7.1f} "
              f"(n={int(pc.n[0])} pairs) -> {verdict} "
              f"(paper: startup up to 2x+, overall ~flat)")
    return out


def execution_backends(reps=4, device=None):
    """The same grid through every backend of the port that runs here
    (``oracle``, ``torch``, and ``cuda`` on the card). The parity column is
    the contract that lets the content-addressed store share cached answers
    across backends. Returns {backend: bit-parity with the first}."""
    from repro_torch.core.backend import backend_names, get_backend
    from repro_torch.core.sweep import grid_rows, resolve_model, run_rows

    dev = eng.resolve_device(device)
    print("\n=== Execution backends: one grid, every substrate ===")
    topo = one_cluster(8, 1)
    rows = grid_rows([20_000], [2, 30], reps)
    model = resolve_model(topo, "divisible", W_list=[20_000], lam_list=[2, 30],
                          pow2_max_events=True)
    ref = None
    parity = {}
    for name in backend_names():
        caps = get_backend(name).capabilities()
        if not caps.available or (dev.type not in caps.devices
                                  and name != "oracle"):
            print(f"  {name:16s} unavailable "
                  f"({caps.note or 'no ' + dev.type + ' form'})")
            continue
        g = run_rows(model, rows, backend=name, device=dev)
        if ref is None:
            ref = g
        ok = np.array_equal(g.makespan, ref.makespan) and np.array_equal(
            g.extras["executed"], ref.extras["executed"])
        parity[name] = ok
        print(f"  {name:16s} kind={caps.kind:9s} devices={caps.devices} "
              f"median Cmax={float(np.median(g.makespan)):8.0f} "
              f"bit-parity={'OK' if ok else 'FAIL'}")
    return parity


def all_task_models(reps=8, device=None):
    """One sweep program per task model (§2.1.1-§2.1.3), all through the
    unified event core on the default backend (the kernel's three bodies on
    the card). Returns the three grids."""
    from repro_torch.core import dag_gen as gen
    from repro_torch.core.sweep import run_grid

    print("\n=== Unified sweeps: divisible / dag / adaptive ===")
    topo = one_cluster(8, 1)
    g = run_grid(topo, W_list=[10**5], lam_list=[2, 62], reps=reps,
                 device=device)
    print(f"  divisible: {len(g)} cells, median makespan "
          f"{float(np.median(g.makespan)):.0f}")
    d = run_grid(topo, lam_list=[2, 62], reps=reps, task_model="dag",
                 dag=gen.merge_sort(20_000, 64), device=device)
    print(f"  dag:       {len(d)} cells, median makespan "
          f"{float(np.median(d.makespan)):.0f} "
          f"(tasks completed {int(d.extras['n_completed'][0])})")
    a = run_grid(topo, W_list=[10**5], lam_list=[2, 62], reps=reps,
                 task_model="adaptive", merge_alpha=2, merge_beta_num=1,
                 device=device)
    print(f"  adaptive:  {len(a)} cells, median makespan "
          f"{float(np.median(a.makespan)):.0f} "
          f"(median splits {float(np.median(a.extras['n_splits'])):.0f})")
    return g, d, a


def trace_and_metrics(out="paper_sweep_trace.json"):
    """The observability layer: trace one query end to end —
    service.query -> broker.flush -> broker.dispatch -> backend.run_rows ->
    store puts/gets — into a Perfetto-loadable Chrome-trace JSON, and print
    the span summary plus the metrics snapshot. The same tracing is
    available process-wide via ``REPRO_WS_TRACE=path.json``."""
    print("\n=== Observability: one traced query + metrics snapshot ===")
    svc = SimulationService(metrics=obs.MetricsRegistry())
    topo = one_cluster(16, 5)
    with obs.trace_to(out) as tr:
        svc.query(topo, W_list=[10**5], lam_list=[5], reps=32)
        svc.query(topo, W_list=[10**5], lam_list=[5], reps=32)  # cache hit
    print(tr.summary())
    print(f"  Chrome trace -> {out} "
          f"({len(tr.events())} events; open in ui.perfetto.dev)")
    snap = svc.stats()["metrics"]
    print("  metrics snapshot (daemon payload):")
    for kind in ("counters", "gauges"):
        for k, v in sorted(snap[kind].items()):
            print(f"    {k}: {v}")
    return tr


if __name__ == "__main__":
    svc = SimulationService()
    overhead_and_fit(svc)
    acceptable_latency()
    mwt_vs_swt(svc)
    all_task_models()
    execution_backends()
    trace_and_metrics()
    print(f"\nservice: {svc.stats()}")
