"""Quickstart on the PyTorch/CUDA port: simulate Work Stealing like the paper
does (the twin of ``examples/quickstart.py``).

Runs one scenario with full logging through the ``ws_sim`` kernel (Gantt +
JSON + Paje export of its trace), then a small parameter sweep with
median/IQR stats and two-cluster victim strategies on the default backend —
the two modes of the paper's simulator engine — and a DAG application (merge
sort, Fig 9's example) through the kernel's DAG body. Runs on the card; the
functions take ``device="cpu"``, where the kernel's plain version runs.

  PYTHONPATH=src python examples/quickstart_torch.py
"""
import numpy as np

from repro_torch.core import (EngineConfig, analysis, engine as eng,
                              one_cluster, resolve_device, two_clusters)
from repro_torch.core import dag as dg
from repro_torch.core import dag_gen as gen
from repro_torch.core.gantt import ascii_gantt, decode_trace, to_json, to_paje
from repro_torch.core.sweep import GridRows, resolve_model, run_grid, run_rows
from repro_torch.kernels.ws_sim import ws_sim_cuda


def _one_row(model, W, seed, device, **kw):
    """One scenario through the kernel (a batch of one row); the result of
    that row."""
    scn = eng.batch_scenarios(W, np.array([seed], np.uint32),
                              device=device, **kw)
    res = ws_sim_cuda(model, scn)
    return type(res)(*(x[0] for x in res))


def single_run(device=None):
    """W=5000, p=8, λ=10, seed 42 with its trace; returns (result, decoded
    trace)."""
    dev = resolve_device(device)
    print("=== one scenario: W=5000 unit tasks, p=8, lambda=10 ===")
    topo = one_cluster(8, 10)
    cfg = EngineConfig(topology=topo, log_trace=True, max_trace=8192,
                       max_events=1 << 18)
    res = _one_row(cfg, 5000, 42, dev, lam=10)
    makespan = int(res.makespan)
    print(f"makespan={makespan}  (W/p lower bound = {5000 // 8})")
    print(f"steal requests={int(res.n_requests)} "
          f"ok={int(res.n_success)} fail={int(res.n_fail)}")
    dec = decode_trace(res.trace, res.n_trace, 8, 5000, makespan)
    print(ascii_gantt(dec["runs"], makespan, width=64))
    paje = to_paje(dec["runs"], makespan)
    print(f"paje trace: {len(paje.splitlines())} lines "
          f"(write to .trace for ViTE/Paje)")
    print(to_json(res, 8, 5000)[:160], "...")
    return res, dec


def sweep(device=None):
    """The overhead ratio against the theoretical bound; returns the
    grid."""
    print("\n=== sweep: overhead ratio vs the theoretical bound ===")
    topo = one_cluster(32, 1)
    grid = run_grid(topo, W_list=[100_000, 1_000_000], lam_list=[2, 50, 200],
                    reps=16, device=device)
    for W in (100_000, 1_000_000):
        for lam in (2, 50, 200):
            sel = (grid.W == W) & (grid.lam == lam)
            ratios = analysis.overhead_ratio(grid.makespan[sel], W, 32, lam)
            s = analysis.summarize(ratios)
            print(f"W=1e{int(np.log10(W))} lam={lam:4d}: overhead ratio "
                  f"median={s['median']:.2f} IQR=[{s['q1']:.2f},{s['q3']:.2f}]"
                  f"  (paper: 4-5.5)")
    return grid


def two_cluster_strategies(device=None):
    """Victim-selection strategies on two clusters; the rows are the JAX
    quickstart's (seeds 1..8). Returns {(strategy, remote_prob): median}."""
    print("\n=== two clusters: victim-selection strategies ===")
    from repro_torch.core import LOCAL_FIRST, UNIFORM, strategy_name
    n = 8
    rows = GridRows(W=np.full(n, 200_000, np.int32),
                    lam_local=np.ones(n, np.int32),
                    lam_remote=np.full(n, 100, np.int32),
                    theta_static=np.zeros(n, np.int32),
                    theta_comm=np.zeros(n, np.int32),
                    seed=np.arange(n, dtype=np.uint32) + 1)
    out = {}
    for strat, rp in ((UNIFORM, 0.25), (LOCAL_FIRST, 0.1), (LOCAL_FIRST, 0.5)):
        topo = two_clusters(16, 100).with_strategy(strat, remote_prob=rp)
        model = resolve_model(topo, "divisible", max_events=1 << 20)
        g = run_rows(model, rows, remote_prob=rp, device=device)
        med = int(np.median(g.makespan))
        out[(strat, rp)] = med
        print(f"  {strategy_name(strat):12s} remote_prob={rp:.2f}: "
              f"median makespan {med}")
    return out


def dag_application(device=None):
    """Merge sort on 6 processors through the DAG body; returns the
    result."""
    dev = resolve_device(device)
    print("\n=== DAG application: merge sort on 6 processors ===")
    dagf = gen.merge_sort(4000, cutoff=64)
    topo = one_cluster(6, 5)
    cfg = dg.DagEngineConfig(topology=topo, dag=dagf, max_events=1 << 18)
    res = _one_row(cfg, 0, 3, dev, lam=5)
    t1, d = dagf.total_work, dagf.critical_path()
    print(f"tasks={dagf.n} T1={t1} critical_path={d} "
          f"makespan={int(res.makespan)} "
          f"(bounds: max(T1/p, D)={max(t1 // 6, d)})")
    return res


if __name__ == "__main__":
    single_run()
    sweep()
    two_cluster_strategies()
    dag_application()
