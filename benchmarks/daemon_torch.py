#!/usr/bin/env python3
"""The simulation daemon's bench on the PyTorch/CUDA port: the twin of
``benchmarks/run.py``'s ``daemon_throughput``.

    python3 benchmarks/daemon_torch.py [--out DIR]

Three client processes ask four queries each (p=8, W=20000, λ {3, 5}, 8
reps, seeds 100.., one connection a client) of one warm shared daemon
(``repro_torch.service.SimulationDaemon``, warmed by a disjoint query,
seed 999); then the same twelve queries run in cold per-process library
mode — a fresh process and a private store root per query, three at a time
— each paying the interpreter, the ``torch`` import, the CUDA context and
the load of the kernel library itself. Prints the ``name,us_per_call,
derived`` CSV row and one JSON line with queries per second, dispatches and
per-query p50/p99 for each mode; ``--out DIR`` also writes
``daemon_throughput.csv`` and ``BENCH_daemon_torch.json`` there (nothing
is written elsewhere but temporary store roots, removed at the end). Runs on
the card; needs one.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import one_cluster  # noqa: E402
from repro_torch.service import DaemonClient, SimulationDaemon  # noqa: E402

#: the JAX bench's workload
N_CLIENTS, N_QUERIES = 3, 4
P, W, LAMS, REPS = 8, 20_000, [3, 5], 8

#: Child process: answers its queries through a DaemonClient (the shared
#: daemon) or through its own SimulationService (per-process library mode).
_CLIENT = """
import json, sys, time
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["src"])
from repro_torch.core import one_cluster
topo = one_cluster(cfg["p"], 1)
kw = dict(W_list=[cfg["W"]], lam_list=cfg["lams"], reps=cfg["reps"])
if cfg["mode"] == "daemon":
    from repro_torch.service import DaemonClient
    svc = DaemonClient(root=cfg["root"], fallback=False)
else:
    from repro_torch.service import SimulationService
    svc = SimulationService(root=cfg["root"], device=cfg["device"])
lats = []
for i in range(cfg["n_queries"]):
    t0 = time.perf_counter()
    svc.query(topo, seed0=cfg["seed0"] + i, **kw)
    lats.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"lats": lats,
                  "dispatches": getattr(svc, "n_dispatches", 0)}))
"""


def _run_clients(mode: str, roots, per_proc: int, seed0: int,
                 device: str) -> tuple:
    cfgs = [dict(mode=mode, src=str(ROOT / "src"), root=str(r), p=P, W=W,
                 lams=LAMS, reps=REPS, n_queries=per_proc, seed0=seed0,
                 device=device) for r in roots]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLIENT, json.dumps(c)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cfgs]
    outs = []
    for pr in procs:
        out, err = pr.communicate(timeout=600)
        if pr.returncode != 0:
            raise RuntimeError(f"{mode} client failed:\n{err[-2000:]}")
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return ([l for o in outs for l in o["lats"]],
            sum(o["dispatches"] for o in outs))


def _mode(lats, wall: float, dispatches: int) -> dict:
    n = len(lats)
    return dict(queries=n, qps=n / wall, wall_s=wall, n_dispatches=dispatches,
                p50_ms=float(np.percentile(lats, 50)),
                p99_ms=float(np.percentile(lats, 99)))


def daemon_throughput(device: eng.DeviceLike = None,
                      out: Optional[Path] = None) -> dict:
    """N client processes × M queries against one warm shared daemon, then
    the same queries in cold per-process library mode (module docstring).
    Returns the workload and each mode's q/s, wall, dispatches and p50/p99
    latency; ``device`` follows the device rule (None: the card)."""
    dev = str(eng.resolve_device(device))
    topo = one_cluster(P, 1)
    tmps = []
    try:
        tmp = Path(tempfile.mkdtemp(prefix="bench_daemon_"))
        tmps.append(tmp)
        d = SimulationDaemon(root=tmp / "store", coalesce_window_s=0.02,
                             device=dev).start()
        try:
            warm = DaemonClient(root=d.store.root, fallback=False)
            warm.query(topo, W_list=[W], lam_list=LAMS, reps=REPS,
                       seed0=999)
            d0, r0 = d.service.broker.n_dispatches, d.n_rounds
            t0 = time.perf_counter()
            lats_d, _ = _run_clients("daemon", [d.store.root] * N_CLIENTS,
                                     N_QUERIES, 100, dev)
            wall_d = time.perf_counter() - t0
            disp_d = d.service.broker.n_dispatches - d0
            rounds_d = d.n_rounds - r0
        finally:
            d.stop()

        t0 = time.perf_counter()
        lats_l, disp_l = [], 0
        for i in range(N_QUERIES):
            roots = [Path(tempfile.mkdtemp(prefix="bench_daemon_lib_"))
                     for _ in range(N_CLIENTS)]
            tmps.extend(roots)
            lats, disp = _run_clients("library", roots, 1, 100 + i, dev)
            lats_l.extend(lats)
            disp_l += disp
        wall_l = time.perf_counter() - t0
    finally:
        for t in tmps:
            shutil.rmtree(t, ignore_errors=True)

    modes = {"daemon": dict(_mode(lats_d, wall_d, disp_d), rounds=rounds_d),
             "library": _mode(lats_l, wall_l, disp_l)}
    speedup = modes["daemon"]["qps"] / modes["library"]["qps"]
    doc = dict(workload=dict(n_clients=N_CLIENTS, n_queries=N_QUERIES, p=P,
                             W=W, lams=LAMS, reps=REPS),
               device=dev, speedup_vs_library=speedup, **modes)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        keys = sorted({k for m in modes.values() for k in m})
        with open(out / "daemon_throughput.csv", "w") as f:
            f.write(",".join(["mode"] + keys) + "\n")
            for name, m in modes.items():
                f.write(",".join([name] + [str(m.get(k, ""))
                                           for k in keys]) + "\n")
        with open(out / "BENCH_daemon_torch.json", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    dm, lb = modes["daemon"], modes["library"]
    print(f"daemon_throughput,{wall_d * 1e6 / dm['queries']:.1f},"
          f"warm daemon x{speedup:.1f} vs cold per-process library "
          f"({dm['qps']:.2f} vs {lb['qps']:.2f} q/s, {N_CLIENTS} clients x "
          f"{N_QUERIES} queries); dispatches {disp_d} vs {disp_l}; "
          f"daemon p50/p99 {dm['p50_ms']:.0f}/{dm['p99_ms']:.0f}ms",
          flush=True)
    print(json.dumps(doc, sort_keys=True), flush=True)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the CSV and the JSON")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    daemon_throughput(out=args.out)


if __name__ == "__main__":
    main()
