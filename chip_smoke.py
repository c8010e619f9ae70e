#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels/``, holds each kernel against its plain PyTorch
version and the numpy oracle on the card, drives the port's main path — a
store-backed divisible-load sweep through ``SimulationService.sweep`` on the
``cuda`` backend at the paper's largest platform — and checks the answers.

Phases, one JSON line each: ``build``, ``kernels`` (bit-exact against the plain
loop), ``oracle`` (bit-exact against the serial numpy simulator), ``main_path``
(sweeps, invariants, repeat served from the store, sampled oracle rows) and
``timing`` (the kernel, its plain version and its bound at a main-path shape).
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the exit code is
then not 0 and no result line is printed. Needs one CUDA device, no network.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# One card: the backend would otherwise shard every chunk across all of them.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is false")

from repro_torch import obs  # noqa: E402
from repro_torch.core import backend as bk  # noqa: E402
from repro_torch.core import divisible as dv  # noqa: E402
from repro_torch.core import oracle as orc  # noqa: E402
from repro_torch.core import sweep as sw  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ws_sim as ws  # noqa: E402
from repro_torch.kernels.ref import ws_sim_ref  # noqa: E402
from repro_torch.service import SimulationService  # noqa: E402

DEV = "cuda"

# Peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM; 67 TFLOP/s of
# float32 outside the tensor cores, i.e. 33.5e12 lane-operations a second with
# a fused multiply-add counted twice. The kernel's work is int32, which issues
# on half of those lanes: 16.75e12 int32 operations a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

SCALAR_FIELDS = ("makespan", "n_events", "n_requests", "n_success", "n_fail",
                 "total_idle", "startup_end")


def say(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def max_abs_diff(a: dv.SimResult, b: dv.SimResult) -> int:
    """Largest |a - b| over every element of every leaf (0: bit-exact)."""
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"leaf shape/dtype differs: {x.shape} "
                                 f"{x.dtype} vs {y.shape} {y.dtype}")
        if x.numel():
            worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64))
                                   .abs().max()))
    return worst


def hold_against_plain(model, scn, what: str) -> tuple:
    """Launch the kernel and the plain loop on the same CUDA tensors; every
    leaf must be ``torch.equal``. Returns (kernel result, max |diff|)."""
    got = ws.ws_sim_cuda(model, scn)
    torch.cuda.synchronize()
    want = ws_sim_ref(model, scn)
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    bad = [f for f in got._fields
           if not torch.equal(getattr(got, f), getattr(want, f))]
    if bad or err:
        raise AssertionError(f"kernel != plain version on {what}: leaves "
                             f"{bad}, max abs diff {err}")
    return got, err


def hold_against_oracle(topo, mwt, remote_prob, scn, res, rows, what: str,
                        max_events: int):
    """Rows ``rows`` of a kernel result against the serial numpy oracle."""
    host = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    s = {f: getattr(scn, f).cpu().numpy() for f in scn._fields}
    for k in rows:
        o = orc.simulate_oracle(
            topo, int(s["W"][k]), seed=int(s["seed"][k]),
            lam_local=int(s["lam_local"][k]),
            lam_remote=int(s["lam_remote"][k]),
            theta_static=int(s["theta_static"][k]),
            theta_comm=int(s["theta_comm"][k]), mwt=mwt,
            remote_prob=remote_prob,
            max_events=min(max_events, int(s["max_events"][k])))
        for f in SCALAR_FIELDS:
            if int(getattr(o, f)) != int(host[f][k]):
                raise AssertionError(
                    f"kernel != oracle on {what} row {k}: {f} "
                    f"{int(host[f][k])} vs {int(getattr(o, f))}")
        if bool(o.overflow) != bool(host["overflow"][k]) or not \
                np.array_equal(o.executed, host["executed"][k]):
            raise AssertionError(f"kernel != oracle on {what} row {k}: "
                                 "executed/overflow")


# ---------------------------------------------------------------------------
# Phase 2/3: the kernel against its plain version and the oracle.
# ---------------------------------------------------------------------------

P_LIST = (4, 16, 64)
W_LIST = (1000, 20000)
THETAS = ((0, 0), (3, 1))
N_SEEDS = 16
REMOTE_PROB = 0.3


def case_topologies(p: int):
    # intra-cluster latencies of 3 and 2, not 1: an idle processor's failed
    # steals then come every 6 or 4 time units, which keeps the event count —
    # and with it the plain loop's step count — within this script's time
    return (T.two_clusters(p, 20, lam_local=3),
            T.multi_cluster(4, p // 4, 7, 2, "ring"))


def case_scenario(topo, budgets=None):
    """W x theta x seeds rows for one (topology, strategy, mwt) model."""
    rows = sw.grid_rows(W_LIST, [(topo.lam_local, topo.lam_remote)], N_SEEDS,
                        theta=THETAS, seed0=1 + topo.p)
    return sw.scenario_from_rows(rows, remote_prob=REMOTE_PROB,
                                 ev_budget=budgets, device=DEV)


def phase_kernels_and_oracle():
    t0 = time.perf_counter()
    n_cases = n_rows = 0
    worst = 0
    oracle_rows = 0
    for p in P_LIST:
        for base in case_topologies(p):
            for strategy in (T.UNIFORM, T.LOCAL_FIRST, T.INV_DISTANCE,
                             T.ROUND_ROBIN):
                topo = base.with_strategy(strategy, REMOTE_PROB)
                for mwt in (False, True):
                    cfg = dv.EngineConfig(topology=topo, mwt=mwt,
                                          max_events=1 << 20)
                    scn = case_scenario(topo)
                    what = f"{topo.name} p={p} strategy={strategy} mwt={mwt}"
                    res, err = hold_against_plain(cfg, scn, what)
                    if bool(res.overflow.any()):
                        raise AssertionError(f"unexpected overflow on {what}")
                    worst = max(worst, err)
                    n_cases += len(W_LIST) * len(THETAS)
                    n_rows += int(scn.W.shape[0])
                    if p == 16 or (p == 64 and not mwt):
                        # first and last row: (W, theta) = (1000, (0, 0)) and
                        # (20000, (3, 1))
                        rows = (0, int(scn.W.shape[0]) - 1)
                        hold_against_oracle(topo, mwt, REMOTE_PROB, scn, res,
                                            rows, what, 1 << 20)
                        oracle_rows += len(rows)
    # the trace ring, and rows that stop at their own event budget
    topo = case_topologies(16)[0].with_strategy(T.LOCAL_FIRST, REMOTE_PROB)
    cfg = dv.EngineConfig(topology=topo, mwt=True, max_events=1 << 20,
                          log_trace=True, max_trace=256)
    res, err = hold_against_plain(cfg, case_scenario(topo), "log_trace")
    if int(res.n_trace.max()) != 256 or not bool(res.trace.any()):
        raise AssertionError("trace ring was not filled")
    worst = max(worst, err)
    n = len(W_LIST) * len(THETAS) * N_SEEDS
    budgets = np.where(np.arange(n) % 3 == 0, np.arange(n) * 5, 2**31 - 1)
    cfg = dv.EngineConfig(topology=topo, mwt=False, max_events=1 << 20)
    scn = case_scenario(topo, budgets=budgets)
    res, err = hold_against_plain(cfg, scn, "per-row budgets")
    cut = torch.as_tensor(np.arange(n) % 3 == 0, device=DEV)
    if not bool(res.overflow[cut].all()) or bool(res.overflow[~cut].any()) \
            or int(res.makespan[0]) != -1 or int(res.n_events[0]) != 0:
        raise AssertionError("per-row budgets: wrong rows overflowed")
    hold_against_oracle(topo, False, REMOTE_PROB, scn, res, (0, 3, 4),
                        "per-row budgets", 1 << 20)
    worst = max(worst, err)
    oracle_rows += 3
    n_cases += 2
    n_rows += 2 * n
    say("kernels", kernels=[ws.KERNEL_NAME], cases=n_cases, rows=n_rows,
        bit_exact=True, max_abs_err=worst,
        seconds=round(time.perf_counter() - t0, 3))
    say("oracle", rows=oracle_rows, bit_exact=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the main path.
# ---------------------------------------------------------------------------

# configs/ws_paper.py of the JAX package, paper §4.1.1: one cluster, the
# largest platform p = 256, W = 10^6 unit tasks, latencies across the range;
# then a two-cluster platform under the LOCAL_FIRST strategy.
MAIN_W = 10**6
MAIN_REPS = 256
MAIN_SWEEPS = (
    dict(name="one_cluster_p256",
         topo=lambda: T.one_cluster(256, 1),
         kw=dict(W_list=[MAIN_W], lam_list=[2, 62, 262, 482], reps=MAIN_REPS,
                 chunk_size=256)),
    dict(name="two_clusters_p64_local_first",
         topo=lambda: T.two_clusters(64, 100).with_strategy(T.LOCAL_FIRST),
         kw=dict(W_list=[MAIN_W], lam_list=[(1, 100)], reps=MAIN_REPS,
                 chunk_size=256)),
)


def check_invariants(g: sw.GridResult, name: str):
    if g.overflow.any():
        raise AssertionError(f"{name}: {int(g.overflow.sum())} rows overflowed")
    if not np.array_equal(g.extras["executed"].sum(1), g.W):
        raise AssertionError(f"{name}: executed work does not sum to W")
    if (g.makespan < -(-g.W // g.p)).any():
        raise AssertionError(f"{name}: a makespan below ceil(W/p)")
    if not np.array_equal(g.n_requests, g.n_success + g.n_fail):
        raise AssertionError(f"{name}: n_requests != n_success + n_fail")
    if g.makespan.shape != (len(g),) or g.extras["executed"].shape != \
            (len(g), g.p) or g.makespan.dtype != np.int32:
        raise AssertionError(f"{name}: wrong shapes or types")


def check_sampled_rows_against_oracle(g: sw.GridResult, topo, rows, name):
    for k in rows:
        o = orc.simulate_oracle(
            topo, int(g.W[k]), seed=int(g.seed[k]),
            lam_local=int(g.extras["lam_local"][k]), lam_remote=int(g.lam[k]),
            theta_static=int(g.theta_static[k]),
            theta_comm=int(g.theta_comm[k]), mwt=False,
            remote_prob=topo.remote_prob, max_events=1 << 30)
        got = (int(g.makespan[k]), int(g.n_requests[k]), int(g.n_success[k]),
               int(g.total_idle[k]), int(g.extras["n_events"][k]))
        want = (o.makespan, o.n_requests, o.n_success, int(o.total_idle),
                o.n_events)
        if got != want or not np.array_equal(o.executed,
                                             g.extras["executed"][k]):
            raise AssertionError(f"{name} row {k}: sweep {got} != oracle "
                                 f"{want}")


def phase_main_path(store_root: Path) -> dict:
    cuda_be = bk.get_backend("cuda")
    svc = SimulationService(root=store_root)       # device=None: the card
    # ---- the run that is counted: every count at 0 just before ------------
    ws.ws_sim_cuda.launches = 0
    runs_before = cuda_be.n_run_rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.trace_to(None) as tracer:             # spans: where the wall goes
        grids = [svc.sweep(s["topo"](), backend="cuda", **s["kw"])
                 for s in MAIN_SWEEPS]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ws.ws_sim_cuda.launches             # read just after
    # backend.run_rows = scenario upload + launch + wait + copy to the host;
    # store.put = npz compression + two atomic writes; store.get = the misses
    span_ms = {name: round(sum(ms), 3)
               for name, ms in tracer.durations_ms().items()}
    n_chunks = sum(math.ceil(len(g) / 256) for g in grids)
    if launches < 1 or launches != n_chunks:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             f"expected one per chunk = {n_chunks}")
    if cuda_be.n_run_rows - runs_before != n_chunks:
        raise AssertionError("the cuda backend's n_run_rows did not rise by "
                             "one per chunk")
    for s, g in zip(MAIN_SWEEPS, grids):
        check_invariants(g, s["name"])
    rows = sum(len(g) for g in grids)
    events = int(sum(g.extras["n_events"].astype(np.int64).sum()
                     for g in grids))
    # ---- the same question again: answered from the store -----------------
    puts = svc.store.puts
    again = [svc.sweep(s["topo"](), backend="cuda", **s["kw"])
             for s in MAIN_SWEEPS]
    if ws.ws_sim_cuda.launches != launches or svc.store.puts != puts:
        raise AssertionError("the repeated sweep launched a kernel or wrote "
                             "the store")
    fresh = SimulationService(root=store_root)     # empty memory tier: disk
    disk = [fresh.sweep(s["topo"](), backend="cuda", **s["kw"])
            for s in MAIN_SWEEPS]
    if ws.ws_sim_cuda.launches != launches or \
            fresh.store.hits_disk != n_chunks:
        raise AssertionError("a fresh service did not answer from disk")
    for g, a, d in zip(grids, again, disk):
        for f in ("makespan", "n_requests", "total_idle", "seed"):
            if not (np.array_equal(getattr(g, f), getattr(a, f))
                    and np.array_equal(getattr(g, f), getattr(d, f))):
                raise AssertionError(f"stored answer differs in {f}")
    # ---- sampled rows against the serial numpy oracle ---------------------
    t1 = time.perf_counter()
    check_sampled_rows_against_oracle(
        grids[0], MAIN_SWEEPS[0]["topo"](), (3 * MAIN_REPS + 5, len(grids[0]) - 1),
        MAIN_SWEEPS[0]["name"])
    check_sampled_rows_against_oracle(
        grids[1], MAIN_SWEEPS[1]["topo"](), (0, MAIN_REPS - 1),
        MAIN_SWEEPS[1]["name"])
    out = dict(rows=rows, chunks=n_chunks, launches=launches,
               total_events=events, wall_seconds=wall,
               events_per_second=events / wall, span_ms=span_ms,
               mean_makespan={s["name"]: float(g.makespan.mean())
                              for s, g in zip(MAIN_SWEEPS, grids)},
               repeat_from_store=True, oracle_rows=4,
               oracle_seconds=round(time.perf_counter() - t1, 3),
               card=card_line())
    say("main_path", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the kernel's time, its plain version's, and its bound.
# ---------------------------------------------------------------------------

# int32 operations the *function* needs per event, whatever the implementation:
# counted from the handlers of ``repro_torch.core.divisible`` / ``engine`` with
# the next event kept in a tournament tree over the p event times (an update
# costs one compare and one select per level) and the remaining work kept as a
# running sum, so that no event needs a pass over the p processors.
OPS_DISPATCH = 4        # load state[i], three-way branch, budget test, n_events
OPS_DIST = 5            # cluster compare, lam_remote * hops, select, i == j
OPS_VICTIM = {          # select_victim, tables of cluster members / prefix sums
    T.UNIFORM: 9,       # xorshift32 (3 shifts, 3 xors), mod, compare, add
    T.LOCAL_FIRST: 18,  # two xorshift32, compare, mod, table index, v == i fix
    T.INV_DISTANCE: 11,  # xorshift32, convert, two multiplies, v == i fix
    T.ROUND_ROBIN: 6,   # add, mod, compare, add, mod, select
}
OPS_IDLE = 3            # active_count, finished test on the running sums
OPS_REQUEST = 18        # w_v (3), threshold (2), channel (1), amt and ok (6),
#                         new idle time (2), executed (1), arrival (1), counts (2)
OPS_ANSWER_OK = 9       # amt > 0, end time, active_count and startup (4),
#                         executed (1), idle time (2)
OPS_ANSWER_FAIL = 1     # amt > 0, then the steal of OPS_VICTIM + OPS_DIST + 1


def kernel_bound_ms(model, scn, res) -> tuple:
    """The least time the card could take for this launch: the larger of
    (bytes that must move) / (memory rate) and (int32 operations this run's
    data needs) / (int32 rate). Returns (ms, "bytes" | "operations", detail).

    The operations are those of the function, not of this kernel: per event
    the handler's scalar arithmetic (the ``OPS_*`` counts above, times how
    often this run's data took each handler) and an O(log p) update of the
    next-event structure per changed event time; per row one pass over the p
    processors for the terminal idle time.
    """
    G, p = int(scn.W.shape[0]), model.p
    trace_rows = int(res.trace.shape[1])
    bytes_in = sum(x.numel() * x.element_size() for x in scn) \
        + 4 * p + 4 * p * p                       # cluster ids and hops, once
    # nine int32 scalars a row, executed[p], the trace rows
    bytes_out = 4 * G * 9 + 4 * G * p + 16 * G * trace_rows
    total = lambda x: int(x.to(torch.int64).sum())
    events, n_req = total(res.n_events), total(res.n_requests)
    n_ok, n_fail = total(res.n_success), total(res.n_fail)
    # an event is an idle, a request or an answer; answers follow requests
    idle_events = max(events - 2 * n_req, 0)
    levels = math.ceil(math.log2(p))
    strategy = model.topology.strategy
    steal = OPS_VICTIM[strategy] + OPS_DIST + 1   # + the request's arrival time
    if strategy == T.INV_DISTANCE:
        steal += levels                           # binary search of the sums
    # event times that change: the thief's on every event, the victim's on a
    # successful request
    tree = 2 * levels * (events + n_ok)
    ops = (events * OPS_DISPATCH + tree
           + idle_events * (OPS_IDLE + steal)
           + n_req * (OPS_REQUEST + OPS_DIST)
           + n_ok * OPS_ANSWER_OK + n_fail * (OPS_ANSWER_FAIL + steal)
           + G * 2 * p)                           # finish: idle_now and its sum
    bytes_ms = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(bytes_ms, ops_ms), by, dict(
        bytes=bytes_in + bytes_out, int32_ops=ops, events=events,
        idle_events=idle_events, requests=n_req, ops_per_event=ops / events,
        bytes_ms=bytes_ms, ops_ms=ops_ms)


def time_kernel_ms(model, scn, reps: int = 5) -> float:
    ws.ws_sim_cuda(model, scn)                     # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ws.ws_sim_cuda(model, scn)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing(main: dict, worst_err: int) -> dict:
    """The kernel alone on every chunk the main path launches, then — at each
    of the two shapes the main path gives it — the kernel beside its plain
    version: the last chunk of the p = 256 sweep (256 rows, W = 10^6,
    lam = 482: the chunk with the fewest events, so that the plain version,
    which takes one step of every row per event, ends in time) and the chunk
    of the p = 64 two-cluster sweep. The first is the shape the ``kernels``
    line reports, with its bound."""
    per_chunk = []
    at_shape = {}
    for s in MAIN_SWEEPS:
        topo, kw = s["topo"](), s["kw"]
        model = sw.resolve_model(
            topo, W_list=kw["W_list"], backend="cuda",
            lam_list=[l for e in kw["lam_list"] for l in sw.lam_pair(e)])
        rows = sw.grid_rows(kw["W_list"], kw["lam_list"], kw["reps"])
        for lo in range(0, len(rows), kw["chunk_size"]):
            c = rows.slice(lo, lo + kw["chunk_size"])
            scn = sw.scenario_from_rows(c, remote_prob=topo.remote_prob,
                                        device=DEV)
            ms = time_kernel_ms(model, scn)
            res = ws.ws_sim_cuda(model, scn)
            ev = int(res.n_events.to(torch.int64).sum())
            per_chunk.append(dict(
                sweep=s["name"], lam=int(c.lam_remote[0]), rows=len(c),
                p=topo.p, events=ev, ms=ms, events_per_second=ev / ms * 1e3))
            at_shape[s["name"]] = (model, scn, per_chunk[-1])  # last chunk
    err = worst_err
    plain = {}
    for name, (model, scn, chunk) in at_shape.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ws_sim_ref(model, scn)
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t0) * 1e3
        got = ws.ws_sim_cuda(model, scn)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff(got, want))
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"kernel != plain version at the main-path "
                                 f"shape of {name}")
        chunk["plain_ms"] = plain[name]
    model, scn, chunk = at_shape[MAIN_SWEEPS[0]["name"]]
    plain_ms = plain[MAIN_SWEEPS[0]["name"]]
    bound_ms, bound_by, detail = kernel_bound_ms(
        model, scn, ws.ws_sim_cuda(model, scn))
    entry = {
        "name": ws.KERNEL_NAME, "route": "cuda", "source": ws.KERNEL_SOURCE,
        "replaces": "src/repro/kernels/ws_sim.py:119",
        "launches": main["launches"], "max_abs_err": err,
        "ms": chunk["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": {"rows": chunk["rows"], "p": chunk["p"], "W": MAIN_W,
                  "lam": chunk["lam"]},
        "bound_detail": detail, "per_chunk": per_chunk,
    }
    say("timing", kernel=ws.KERNEL_NAME, ms=chunk["ms"], plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, per_chunk=per_chunk,
        card=card_line())
    return entry


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    t_start = time.perf_counter()
    say("start", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), card=card_line())
    # 1. build every kernel from the sources in this checkout
    seconds = _build.build_all()
    ws._lib()
    say("build", seconds=seconds, directory=str(_build.build_dir()),
        ptxas=[l for log in _build.build_logs.values()
               for l in log.splitlines() if "registers" in l or "spill" in l])
    # 2, 3. each kernel against its plain version and the oracle
    worst = phase_kernels_and_oracle()
    # 4. the main path
    with tempfile.TemporaryDirectory(prefix="ws_store_") as tmp:
        main_out = phase_main_path(Path(tmp))
    # 5. times at a main-path shape
    entry = phase_timing(main_out, worst)
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
