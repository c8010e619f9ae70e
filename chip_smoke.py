#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels/``, holds each kernel body — divisible load, DAG
of tasks, adaptive tasks — against its plain PyTorch version and the numpy
oracles on the card, drives the port's main paths — store-backed sweeps
through ``SimulationService.sweep`` on the ``cuda`` backend: divisible load at
the paper's largest platform, the repository's merge-sort DAG, and adaptive
tasks at the paper's W and p — and checks the answers. Then the
language-model serving path of ``qwen3-1.7b`` at full width (random weights
from a seed): its kernels (RMSNorm, flash attention — bf16 on the tensor
cores, float32 on the CUDA cores — and flash decode, kv_len as an int and on
the device, one split and several) against their plain versions,
``serve.decode_batch`` (each step after the first a replay of one CUDA
graph; its tokens equal to an eager loop's) and ``steps.build_prefill_step``
with their launch counts (per kernel variant too), and the float32 parity
of forward and sequential prefill.

Phases, one JSON line each: ``build`` (seconds, ptxas's registers and spills,
the count of ``HGMMA`` instructions in each library's SASS, and the
resources of every instantiation of the simulator kernel, where a spill
fails the run), ``kernels`` (bit-exact against the plain loop, the
simulator at every slot-count boundary), ``oracle`` (bit-exact
against the serial numpy simulators), ``main_path`` (one line per path:
sweeps, invariants, every launch on the register variant, repeat served from
the store, sampled oracle rows), ``query_main_path`` (one line per step of
the query path under the sanitizer — the planner and its replan, an
adaptive CI query, ``query_many`` over the DAG and adaptive bodies with
every row held to the sweep's row of the same seed or to the serial twin,
the planner's queries under injected faults, and ``cuda`` against the plain
loop on the card at a small size — each with its dispatches, rows per
dispatch, launches by body, wall with and without the sanitizer's replays,
kernel time, store writes and device idle share), ``paper`` (one line per
step, each counted on its own: ``benchmarks/paper_torch.py``'s Fig 10 on the
paper's own grid of 96 cells x 1000 reps through the kernel, with one row of
every cell held to the numpy oracle; Fig 11, Fig 12 at W=10^8, the steal
threshold and the multi-cluster scenarios at ``--full``, a few rows each
held to the oracle; ``examples/quickstart_torch.py``'s traced launch against
the plain loop and decoded by the log engine, then the rest of the
quickstart; ``examples/paper_sweep_torch.py``'s task models and backend
table; the backend matrix with the segmented ``torch`` loop on the card
equal to ``cuda`` and a run under the sanitizer; ``serve.main(
["--no-reduced"])`` at full width with the planner's decision, the
scheduler's stats and the launches), ``daemon`` (one line per step, each
counted on its own, every daemon client with ``fallback=False``: three
client processes asking one question of an in-process daemon on the card —
one dispatch, one launch, npz bytes equal to library mode's; the paper's
grid of 96000 rows as 96 ``sweep_chunk`` RPCs from four client processes —
96 launches, every chunk's bytes equal to library mode's, one row a p held
to the oracle, rows/s and events/s beside library mode's and the wire bytes;
an adaptive question and a paired comparison through the rounds, equal to
library mode; a DAG question, which cannot cross the wire, answered by the
client's library mode on the card; ``python -m repro_torch.service.daemon``
killed at its first dispatch — two client threads fall back on the card with
no exception, exit code 17 — then restarted, serving the question from the
store and, after a graceful stop, leaving a history a new daemon loads; and
``benchmarks/daemon_torch.py``'s warm daemon against cold processes),
``timing`` (one line per body: the kernel
per chunk with ns per event on its longest row and its time before the
redesign, the path's summed kernel time, its plain version and its bound),
``lm_kernels`` (one line
per language-model kernel: every case's max error beside its tolerance),
``lm_main_path`` (one line per path: tokens per second, launch counts;
for ``decode_batch`` also the graph's warm-up and capture seconds and ms
per replayed step, beside the eager loop's wall), ``lm_parity``,
``lm_timing`` (one line per kernel and shape: the kernel, its
plain version and one PyTorch call as a yardstick, each as device time from
a replayed CUDA graph, its bound, the rate it reached and its share of the
bound, the variant that ran and its time before its redesign; and the cost
of a one-element fill in a replayed graph, the fixed cost of a launch there) and ``lm_profile`` (where a decode
step's time goes, over a window of eight steps: eager, then replayed from
the step's graph; device idle share and the host's launch calls a step).
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any
failed phase raises: the exit code is then not 0 and no result line is
printed. Needs one CUDA device, no network.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import zipfile
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the port's figure benches and examples (benchmarks/, examples/)
sys.path.insert(1, str(Path(__file__).resolve().parent))
# One card: the backend would otherwise shard every chunk across all of them.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is false")

from repro_torch import obs  # noqa: E402
from repro_torch.core import adaptive as ad  # noqa: E402
from repro_torch.core import backend as bk  # noqa: E402
from repro_torch.core import dag as dg  # noqa: E402
from repro_torch.core import dag_gen as gen  # noqa: E402
from repro_torch.core import divisible as dv  # noqa: E402
from repro_torch.core import oracle as orc  # noqa: E402
from repro_torch.core import sweep as sw  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.configs import get_config as get_lm_config  # noqa: E402
from repro_torch.configs import ws_paper  # noqa: E402
from repro_torch.core import gantt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as fd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ws_sim as ws  # noqa: E402
from repro_torch.kernels.ref import ws_sim_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import Request, decode_batch  # noqa: E402
from repro_torch.launch.steps import (GraphedDecodeStep,  # noqa: E402
                                     build_prefill_step)
from repro_torch.models import build_model as build_lm_model  # noqa: E402
from repro_torch.check import sanitizer as san  # noqa: E402
from repro_torch.sched import plan_for_mesh  # noqa: E402
from repro_torch.service import (DaemonClient, SimulationDaemon,  # noqa: E402
                                 SimulationService)
from repro_torch.service import resilience as rz  # noqa: E402
from repro_torch.service import store as store_mod  # noqa: E402
from repro_torch.service.estimator import fixed_reps_for_width  # noqa: E402
from benchmarks import daemon_torch as dt  # noqa: E402
from benchmarks import paper_torch as pt  # noqa: E402
from examples import paper_sweep_torch as ps  # noqa: E402
from examples import quickstart_torch as qs  # noqa: E402

DEV = "cuda"
# float32 products in full float32 (these are PyTorch's defaults for a matrix
# product; set here so that no environment turns TF32 on for the float32
# parity check of the language-model path)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM; 67 TFLOP/s of
# float32 outside the tensor cores, i.e. 33.5e12 lane-operations a second with
# a fused multiply-add counted twice. The kernel's work is int32, which issues
# on half of those lanes: 16.75e12 int32 operations a second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

BODIES = ("ws_sim_divisible", "ws_sim_dag", "ws_sim_adaptive")
REPLACES = "src/repro/kernels/ws_sim.py:119"
MODEL_SOURCE = {"ws_sim_divisible": "DivisibleModel (src/repro/core/divisible.py)",
                "ws_sim_dag": "DagModel (src/repro/core/dag.py)",
                "ws_sim_adaptive": "AdaptiveModel (src/repro/core/adaptive.py)"}

#: the worst |kernel - plain| per body over every comparison of this run
WORST = {b: 0 for b in BODIES}


def say(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def max_abs_diff(a, b) -> int:
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
    model = sw.as_model(model)
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
    body = ws.kernel_name(model)
    WORST[body] = max(WORST[body], err)
    return got, err


def twin(model, row: dict, remote_prob: float, max_events: int) -> dict:
    """The serial numpy twin's answer for one scenario row (``row`` holds
    W, seed, lam_local, lam_remote, theta_static, theta_comm)."""
    kw = dict(seed=int(row["seed"]), lam_local=int(row["lam_local"]),
              lam_remote=int(row["lam_remote"]),
              theta_static=int(row["theta_static"]), mwt=model.mwt,
              remote_prob=remote_prob, max_events=max_events)
    if isinstance(model, dg.DagModel):
        return orc.simulate_dag_oracle(model.topology, model.cfg.dag,
                                       owner_lifo=model.cfg.owner_lifo, **kw)
    if isinstance(model, ad.AdaptiveModel):
        c = model.cfg
        return orc.simulate_adaptive_oracle(
            model.topology, int(row["W"]), theta_comm=int(row["theta_comm"]),
            merge_alpha=c.merge_alpha, merge_beta_num=c.merge_beta_num,
            merge_beta_den=c.merge_beta_den, **kw)
    return dataclasses.asdict(orc.simulate_oracle(
        model.topology, int(row["W"]), theta_comm=int(row["theta_comm"]),
        **kw))


def twin_may_answer(model, want: dict) -> bool:
    """The twins model no deque_cap/pool_cap (unbounded lists): a row is
    theirs to answer only where no cap can bind (the oracle backend's
    guard; an adaptive deque of one slot or more never binds)."""
    if isinstance(model, dg.DagModel):
        return model.cfg.cap >= model.cfg.dag.n
    if isinstance(model, ad.AdaptiveModel):
        return (want["n_created"] <= model.cfg.pool_cap
                and model.cfg.deque_cap >= 1)
    return True


def hold_against_oracle(model, scn, res, rows, what: str,
                        remote_prob: float) -> int:
    """Rows ``rows`` of a kernel result against the serial numpy twin, every
    field the twin returns. Returns the number of rows compared."""
    model = sw.as_model(model)
    host = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    s = {f: getattr(scn, f).cpu().numpy() for f in scn._fields}
    for k in rows:
        want = twin(model, {f: s[f][k] for f in s}, remote_prob,
                    min(int(model.max_events), int(s["max_events"][k])))
        if not twin_may_answer(model, want):
            raise AssertionError(f"{what} row {k}: a cap could bind; the "
                                 "twin cannot answer it")
        for f, v in want.items():
            if not np.array_equal(np.asarray(v), host[f][k]):
                raise AssertionError(f"kernel != oracle on {what} row {k}: "
                                     f"{f} {host[f][k]} vs {v}")
    return len(rows)


# ---------------------------------------------------------------------------
# Phase 2/3: each body against its plain version and the oracle.
# ---------------------------------------------------------------------------

P_LIST = (4, 16)
W_LIST = (1000, 5000)
THETAS = ((0, 0), (3, 1))
N_SEEDS = 16
REMOTE_PROB = 0.3
STRATEGIES = (T.UNIFORM, T.LOCAL_FIRST, T.INV_DISTANCE, T.ROUND_ROBIN)

#: the DAGs of the DAG body's cases, taken in turn
CASE_DAGS = (lambda: gen.merge_sort(500, 32),
             lambda: gen.random_layered(8, 12, 0.3, seed=3),
             lambda: gen.fork_join(5))
DAG_THETAS = ((0, 0), (1, 0))    # a DAG's threshold is a queue length
AD_W = 3000
AD_THETAS = ((0, 0), (2, 1))


def case_topologies(p: int):
    # intra-cluster latencies of 3 and 2, not 1: an idle processor's failed
    # steals then come every 6 or 4 time units, which keeps the event count —
    # and with it the plain loop's step count — within this script's time
    return (T.two_clusters(p, 20, lam_local=3),
            T.multi_cluster(4, p // 4, 7, 2, "ring"))


def case_scenario(topo, W_list=None, thetas=None, n_seeds=None,
                  budgets=None):
    """W x theta x seeds rows for one (topology, strategy, mwt) model (the
    divisible cases' W, theta and seeds unless given)."""
    rows = sw.grid_rows(W_list or W_LIST, [(topo.lam_local, topo.lam_remote)],
                        n_seeds or N_SEEDS, theta=thetas or THETAS,
                        seed0=1 + topo.p)
    return sw.scenario_from_rows(rows, remote_prob=REMOTE_PROB,
                                 ev_budget=budgets, device=DEV)


def check_budget_rows(res, cut, what):
    """Rows with a budget of their own stop there (an overflow); the
    budget-0 row runs no event."""
    if not bool(res.overflow[cut].all()) or int(res.makespan[0]) != -1 \
            or int(res.n_events[0]) != 0:
        raise AssertionError(f"{what}: per-row budgets not honoured")


def divisible_cases(stats):
    for p in P_LIST:
        for base in case_topologies(p):
            for strategy in STRATEGIES:
                topo = base.with_strategy(strategy, REMOTE_PROB)
                for mwt in (False, True):
                    cfg = dv.EngineConfig(topology=topo, mwt=mwt,
                                          max_events=1 << 20)
                    scn = case_scenario(topo)
                    what = f"{topo.name} p={p} strategy={strategy} mwt={mwt}"
                    res, _ = hold_against_plain(cfg, scn, what)
                    if bool(res.overflow.any()):
                        raise AssertionError(f"unexpected overflow on {what}")
                    stats.add("ws_sim_divisible", scn)
                    if p == 16:
                        # first and last row: (W, theta) = (1000, (0, 0)) and
                        # (5000, (3, 1)). Not at p = 4: there the ring has
                        # clusters of one processor, and LOCAL_FIRST with no
                        # local candidate picks victim 0 in the engine but
                        # (i + 1) % p in the numpy oracle (both reference
                        # behaviours, kept by the port).
                        stats.oracle += hold_against_oracle(
                            cfg, scn, res, (0, int(scn.W.shape[0]) - 1),
                            what, REMOTE_PROB)
    # the trace ring, and rows that stop at their own event budget
    topo = case_topologies(16)[0].with_strategy(T.LOCAL_FIRST, REMOTE_PROB)
    cfg = dv.EngineConfig(topology=topo, mwt=True, max_events=1 << 20,
                          log_trace=True, max_trace=256)
    scn = case_scenario(topo)
    res, _ = hold_against_plain(cfg, scn, "divisible log_trace")
    if int(res.n_trace.max()) != 256 or not bool(res.trace.any()):
        raise AssertionError("trace ring was not filled")
    stats.add("ws_sim_divisible", scn)
    n = len(W_LIST) * len(THETAS) * N_SEEDS
    budgets = np.where(np.arange(n) % 3 == 0, np.arange(n) * 5, 2**31 - 1)
    cfg = dv.EngineConfig(topology=topo, mwt=False, max_events=1 << 20)
    scn = case_scenario(topo, budgets=budgets)
    res, _ = hold_against_plain(cfg, scn, "divisible per-row budgets")
    cut = torch.as_tensor(np.arange(n) % 3 == 0, device=DEV)
    check_budget_rows(res, cut, "divisible")
    if bool(res.overflow[~cut].any()):
        raise AssertionError("divisible per-row budgets: wrong rows "
                             "overflowed")
    stats.oracle += hold_against_oracle(cfg, scn, res, (0, 3, 4),
                                        "divisible per-row budgets",
                                        REMOTE_PROB)
    stats.add("ws_sim_divisible", scn)


def dag_cases(stats):
    k = 0
    for p in P_LIST:
        for base in case_topologies(p):
            for strategy in STRATEGIES:
                topo = base.with_strategy(strategy, REMOTE_PROB)
                for mwt in (False, True):
                    dagf = CASE_DAGS[k % len(CASE_DAGS)]()
                    lifo = (strategy % 2 == 0) != mwt
                    k += 1
                    cfg = dg.DagEngineConfig(topology=topo, dag=dagf, mwt=mwt,
                                             owner_lifo=lifo,
                                             max_events=1 << 20)
                    scn = case_scenario(topo, W_list=(0,),
                                        thetas=DAG_THETAS, n_seeds=8)
                    what = (f"{topo.name} p={p} strategy={strategy} "
                            f"mwt={mwt} {dagf.name} lifo={lifo}")
                    res, _ = hold_against_plain(cfg, scn, what)
                    if bool(res.overflow.any()) or \
                            bool((res.n_completed != dagf.n).any()):
                        raise AssertionError(f"unexpected overflow on {what}")
                    stats.add("ws_sim_dag", scn)
                    if p == 16:
                        stats.oracle += hold_against_oracle(
                            cfg, scn, res, (0, int(scn.W.shape[0]) - 1),
                            what, REMOTE_PROB)
    # a FIFO deque whose positions reach a small cap: rows halt (overflow);
    # with the trace ring and per-row budgets
    topo = case_topologies(16)[1].with_strategy(T.UNIFORM, REMOTE_PROB)
    dagf = gen.random_layered(8, 12, 0.3, seed=3)
    n = 16
    budgets = np.where(np.arange(n) % 3 == 0, np.arange(n) * 5, 2**31 - 1)
    cfg = dg.DagEngineConfig(topology=topo, dag=dagf, owner_lifo=False,
                             deque_cap=12, max_events=1 << 20,
                             log_trace=True, max_trace=64)
    scn = case_scenario(topo, W_list=(0,), thetas=DAG_THETAS, n_seeds=8,
                        budgets=budgets)
    res, _ = hold_against_plain(cfg, scn, "dag deque_cap halt, trace, budgets")
    cut = torch.as_tensor(np.arange(n) % 3 == 0, device=DEV)
    check_budget_rows(res, cut, "dag")
    halted = res.overflow & ~cut
    if not bool(halted.any()) or int(res.n_trace.max()) != 64:
        raise AssertionError("dag: no row halted at the deque cap, or the "
                             "trace ring was not filled")
    stats.add("ws_sim_dag", scn)
    stats.halted_rows += int(halted.sum())


def adaptive_cases(stats):
    for p in P_LIST:
        for base in case_topologies(p):
            for strategy in STRATEGIES:
                topo = base.with_strategy(strategy, REMOTE_PROB)
                for mwt in (False, True):
                    beta = (strategy + mwt) % 2
                    cfg = ad.AdaptiveEngineConfig(
                        topology=topo, mwt=mwt, merge_alpha=2,
                        merge_beta_num=beta, max_events=1 << 20)
                    scn = case_scenario(topo, W_list=(AD_W,),
                                        thetas=AD_THETAS, n_seeds=8)
                    what = (f"{topo.name} p={p} strategy={strategy} "
                            f"mwt={mwt} beta_num={beta}")
                    res, _ = hold_against_plain(cfg, scn, what)
                    if bool(res.overflow.any()):
                        raise AssertionError(f"unexpected overflow on {what}")
                    stats.add("ws_sim_adaptive", scn)
                    if p == 16:
                        stats.oracle += hold_against_oracle(
                            cfg, scn, res, (0, int(scn.W.shape[0]) - 1),
                            what, REMOTE_PROB)
    # a pool that fills (splits are refused, no overflow), a one-slot deque
    # (never halts: a readied merge is popped in the event that pushed it),
    # the trace ring and per-row budgets
    topo = case_topologies(16)[0].with_strategy(T.LOCAL_FIRST, REMOTE_PROB)
    n = 16
    budgets = np.where(np.arange(n) % 3 == 0, np.arange(n) * 5, 2**31 - 1)
    cfg = ad.AdaptiveEngineConfig(topology=topo, pool_cap=9, deque_cap=1,
                                  merge_beta_num=1, max_events=1 << 20,
                                  log_trace=True, max_trace=64)
    scn = case_scenario(topo, W_list=(AD_W,), thetas=AD_THETAS, n_seeds=8,
                        budgets=budgets)
    res, _ = hold_against_plain(cfg, scn, "adaptive pool_cap, trace, budgets")
    cut = torch.as_tensor(np.arange(n) % 3 == 0, device=DEV)
    check_budget_rows(res, cut, "adaptive")
    if bool(res.overflow[~cut].any()) or \
            bool((res.n_created[~cut] != 9).any()) or \
            int(res.n_trace.max()) != 64:
        raise AssertionError("adaptive: the pool did not fill as expected, "
                             "a row overflowed, or the trace ring was short")
    stats.add("ws_sim_adaptive", scn)


#: p at each slot-count boundary of the simulator kernel (K = 1, 2, 4, 8,
#: 16, 32 processors a lane), up to ws.MAX_P
BOUNDARY_P = (2, 31, 32, 33, 63, 64, 65, 128, 129, 256, 257, 512, 513, 1024)


def boundary_case(body: str, p: int) -> tuple:
    """The case of ``body`` at p of BOUNDARY_P, as (config, scenario): one
    cluster, two even clusters or two uneven ones in turn; every strategy
    at every size across the three bodies; SWT or MWT in turn; trace on;
    four rows, the second cut by a budget of 3 events of its own; a DAG
    whose FIFO deque cap halts rows, and an adaptive pool that fills, on
    every other case. Small work keeps the plain loop's steps (one per
    event of the longest row) few. ``tests/test_torch_gpu.py`` runs the
    same cases."""
    n, b = BOUNDARY_P.index(p), BODIES.index(body)
    if n % 3 == 0:
        topo = T.one_cluster(p, 3)
    else:                          # even, then uneven, clusters
        topo = T.two_clusters(p, 20, lam_local=3, split=p // (1 + n % 3))
    topo = topo.with_strategy(STRATEGIES[(n + b) % 4], REMOTE_PROB)
    # above p = 33 a model budget of 800 events keeps the plain loop short;
    # at p <= 33 every row ends on its own, and the main paths run p = 32,
    # 64, 256 to their ends
    common = dict(topology=topo, mwt=bool((n + p) % 2), log_trace=True,
                  max_trace=32, max_events=1 << 16 if p <= 33 else 800)
    if body == "ws_sim_divisible":
        cfg = dv.EngineConfig(**common)
    elif body == "ws_sim_dag":
        halt = n % 2 == 1
        cfg = dg.DagEngineConfig(
            dag=gen.random_layered(6, 8, 0.4, seed=5), owner_lifo=not halt,
            deque_cap=6 if halt else None, **common)
    else:
        cfg = ad.AdaptiveEngineConfig(pool_cap=15 if n % 2 else 4096,
                                      merge_alpha=2, merge_beta_num=1,
                                      **common)
    W = 0 if body == "ws_sim_dag" else 4 * p
    scn = sw.scenario_from_rows(
        sw.grid_rows([W], [(3, 7)], 4, theta=[(1, 1)], seed0=p),
        remote_prob=REMOTE_PROB, ev_budget=np.asarray(
            [2**31 - 1, 3, 2**31 - 1, 2**31 - 1]), device=DEV)
    return cfg, scn


def boundary_cases(stats):
    """Every body at every p of BOUNDARY_P (:func:`boundary_case`) on the
    variant ``ws.variant`` routes it to, held against the plain loop; each
    launch must count under its variant."""
    for body in BODIES:
        for p in BOUNDARY_P:
            cfg, scn = boundary_case(body, p)
            name, k = ws.variant(p)
            before = dict(ws.ws_sim_cuda.launches_by_variant)
            res, _ = hold_against_plain(cfg, scn, f"{body} p={p} "
                                        f"{cfg.topology.name} ({name}, K={k})")
            if ws.ws_sim_cuda.launches_by_variant[name] != before[name] + 1:
                raise AssertionError(f"{body} p={p}: the launch did not count "
                                     f"under variant {name}")
            if not bool(res.overflow[1]) or int(res.n_events[1]) != 3:
                raise AssertionError(f"{body} p={p}: the row budget of 3 "
                                     "events was not honoured")
            stats.add(body, scn)
            stats.variants[name] += 1


@dataclasses.dataclass
class CaseStats:
    cases: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        BODIES, 0))
    rows: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        BODIES, 0))
    oracle: int = 0
    halted_rows: int = 0
    variants: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        ws.VARIANTS, 0))

    def add(self, body, scn):
        self.cases[body] += 1
        self.rows[body] += int(scn.W.shape[0])


def phase_kernels_and_oracle():
    t0 = time.perf_counter()
    stats = CaseStats()
    seconds = {}
    for body, run in (("ws_sim_divisible", divisible_cases),
                      ("ws_sim_dag", dag_cases),
                      ("ws_sim_adaptive", adaptive_cases),
                      ("slot_boundaries", boundary_cases)):
        t1 = time.perf_counter()
        run(stats)
        seconds[body] = round(time.perf_counter() - t1, 3)
    say("kernels", kernels=list(BODIES), models=stats.cases, rows=stats.rows,
        dag_rows_halted_at_deque_cap=stats.halted_rows, bit_exact=True,
        boundary_p=BOUNDARY_P, boundary_cases_by_variant=stats.variants,
        max_abs_err=WORST, seconds=seconds,
        total_seconds=round(time.perf_counter() - t0, 3))
    say("oracle", rows=stats.oracle, bit_exact=True)


# ---------------------------------------------------------------------------
# Phase 4: the main paths.
# ---------------------------------------------------------------------------

# configs/ws_paper.py of the JAX package, paper §4.1.1: one cluster, the
# largest platform p = 256, W = 10^6 unit tasks, latencies across the range;
# then a two-cluster platform under the LOCAL_FIRST strategy.
MAIN_W = 10**6
MAIN_REPS = 256
CHUNK = 256
# benchmarks/run.py of the JAX package, its DAG bench: merge sort of 20000
# elements, leaves of 64, on one cluster of 32.
MAIN_DAG = gen.merge_sort(20_000, 64)


def check_divisible(g: sw.GridResult, name: str, model):
    if g.overflow.any():
        raise AssertionError(f"{name}: {int(g.overflow.sum())} rows overflowed")
    if not np.array_equal(g.extras["executed"].sum(1), g.W):
        raise AssertionError(f"{name}: executed work does not sum to W")
    if (g.makespan < -(-g.W // g.p)).any():
        raise AssertionError(f"{name}: a makespan below ceil(W/p)")


def check_dag(g: sw.GridResult, name: str, model):
    dagf = model.cfg.dag
    T1, D = dagf.total_work, dagf.critical_path()
    if g.overflow.any() or (g.extras["n_completed"] != dagf.n).any():
        raise AssertionError(f"{name}: rows overflowed or left tasks undone")
    if (g.extras["executed"].sum(1) != T1).any() or \
            (g.extras["tasks_run"].sum(1) != dagf.n).any():
        raise AssertionError(f"{name}: executed work != T1 or tasks != n")
    if (g.makespan < max(-(-T1 // g.p), D)).any():
        raise AssertionError(f"{name}: a makespan below max(ceil(T1/p), D)")


def check_adaptive(g: sw.GridResult, name: str, model):
    x = g.extras
    if g.overflow.any():
        raise AssertionError(f"{name}: {int(g.overflow.sum())} rows overflowed")
    if not np.array_equal(x["executed"].sum(1),
                          g.W + x["total_merge_work"]):
        raise AssertionError(f"{name}: executed != W + merge work")
    if not np.array_equal(x["n_completed"], x["n_created"]) or \
            (x["n_created"] > model.cfg.pool_cap).any():
        raise AssertionError(f"{name}: created != completed, or > pool_cap")
    if (g.makespan < -(-g.W // g.p)).any():
        raise AssertionError(f"{name}: a makespan below ceil(W/p)")


def check_common(g: sw.GridResult, name: str):
    if not np.array_equal(g.n_requests, g.n_success + g.n_fail):
        raise AssertionError(f"{name}: n_requests != n_success + n_fail")
    if g.makespan.shape != (len(g),) or g.extras["executed"].shape != \
            (len(g), g.p) or g.makespan.dtype != np.int32:
        raise AssertionError(f"{name}: wrong shapes or types")


#: each path: the body it must launch and its sweeps; a sweep names its
#: topology, its ``sweep`` arguments, its invariants, the rows held against
#: the numpy twin and the chunk whose plain version is timed
MAIN_PATHS = {
    "divisible": dict(body="ws_sim_divisible", sweeps=(
        dict(name="one_cluster_p256",
             topo=lambda: T.one_cluster(256, 1),
             kw=dict(W_list=[MAIN_W], lam_list=[2, 62, 262, 482],
                     reps=MAIN_REPS, chunk_size=CHUNK),
             check=check_divisible,
             oracle_rows=(3 * MAIN_REPS + 5, 4 * MAIN_REPS - 1),
             plain_chunk=3),
        dict(name="two_clusters_p64_local_first",
             topo=lambda: T.two_clusters(64, 100).with_strategy(
                 T.LOCAL_FIRST),
             kw=dict(W_list=[MAIN_W], lam_list=[(1, 100)], reps=MAIN_REPS,
                     chunk_size=CHUNK),
             check=check_divisible,
             oracle_rows=(0, MAIN_REPS - 1),
             plain_chunk=0),
    )),
    "dag": dict(body="ws_sim_dag", sweeps=(
        dict(name="dag_merge_sort_p32",
             topo=lambda: T.one_cluster(32, 1),
             kw=dict(task_model="dag", dag=MAIN_DAG, max_events=1 << 20,
                     lam_list=[2, 10, 62], reps=MAIN_REPS, chunk_size=CHUNK),
             check=check_dag,
             oracle_rows=(2 * MAIN_REPS + 5, 3 * MAIN_REPS - 1),
             plain_chunk=2),
    )),
    "adaptive": dict(body="ws_sim_adaptive", sweeps=(
        dict(name="adaptive_p256",
             topo=lambda: T.one_cluster(256, 1),
             kw=dict(task_model="adaptive", W_list=[MAIN_W], pool_cap=1 << 13,
                     lam_list=[2, 62, 262, 482], reps=MAIN_REPS,
                     chunk_size=CHUNK),
             check=check_adaptive,
             oracle_rows=(2 * MAIN_REPS + 5, 4 * MAIN_REPS - 1),
             plain_chunk=3),
    )),
}


def sweep_model(s) -> "sw.eng.TaskModel":
    """The model ``SimulationService.sweep`` resolves for a sweep."""
    kw = dict(s["kw"])
    for k in ("reps", "chunk_size"):
        kw.pop(k)
    lam = [l for e in kw.pop("lam_list") for l in sw.lam_pair(e)]
    return sw.resolve_model(s["topo"](), lam_list=lam, backend="cuda", **kw)


def grid_against_twin(g: sw.GridResult, model, rows, name: str):
    """Sampled rows of a sweep against the serial numpy twin, every field
    the twin returns (a grid column or an ``extras`` column)."""
    for k in rows:
        row = dict(W=g.W[k], seed=g.seed[k], lam_local=g.extras["lam_local"][k],
                   lam_remote=g.lam[k], theta_static=g.theta_static[k],
                   theta_comm=g.theta_comm[k])
        want = twin(model, row, model.topology.remote_prob,
                    int(model.max_events))
        if not twin_may_answer(model, want):
            raise AssertionError(f"{name} row {k}: a cap could bind")
        for f, v in want.items():
            got = g.extras[f][k] if f in g.extras else getattr(g, f)[k]
            if not np.array_equal(np.asarray(v), got):
                raise AssertionError(f"{name} row {k}: sweep {f}={got} != "
                                     f"oracle {v}")


def drive_path(store_root: Path, path: str) -> dict:
    spec = MAIN_PATHS[path]
    body = spec["body"]
    cuda_be = bk.get_backend("cuda")
    svc = SimulationService(root=store_root)       # device=None: the card
    # ---- the run that is counted: every count at 0 just before ------------
    ws.reset_counts()
    runs_before = cuda_be.n_run_rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = [sweep_model(s) for s in spec["sweeps"]]
    grids, sweeps = [], []
    for s, m in zip(spec["sweeps"], models):
        t1 = time.perf_counter()
        with obs.trace_to(None) as tracer:         # spans: where the wall goes
            g = svc.sweep(s["topo"](), backend="cuda", **s["kw"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        events = int(g.extras["n_events"].astype(np.int64).sum())
        # backend.run_rows = scenario upload + launch + wait + copy to the
        # host; store.put = npz compression + two atomic writes; store.get =
        # the misses
        sweeps.append(dict(
            name=s["name"], rows=len(g), events=events, wall_seconds=wall,
            events_per_second=events / wall,
            max_row_events=int(g.extras["n_events"].max()),
            span_ms={n: round(sum(ms), 3)
                     for n, ms in tracer.durations_ms().items()},
            mean_makespan=float(g.makespan.mean())))
        if isinstance(m, ad.AdaptiveModel):
            # rows whose pool filled: no room for a further split (splits
            # are then refused, which is not an overflow)
            sweeps[-1]["rows_pool_full"] = int(
                (g.extras["n_created"] + 2 > m.cfg.pool_cap).sum())
        grids.append(g)
    wall = time.perf_counter() - t0
    launches = dict(ws.ws_sim_cuda.launches_by_body)   # read just after
    by_variant = dict(ws.ws_sim_cuda.launches_by_variant)
    total = ws.ws_sim_cuda.launches
    n_chunks = sum(math.ceil(len(g) / s["kw"]["chunk_size"])
                   for s, g in zip(spec["sweeps"], grids))
    if launches[body] < 1 or launches[body] != n_chunks or total != n_chunks:
        raise AssertionError(f"{path} path made {launches} kernel launches, "
                             f"expected one of {body} per chunk = {n_chunks}")
    if by_variant != {"registers": n_chunks}:
        raise AssertionError(f"{path}: launches by variant {by_variant}, "
                             f"expected all {n_chunks} on the register "
                             "variant")
    if cuda_be.n_run_rows - runs_before != n_chunks:
        raise AssertionError(f"{path}: the cuda backend's n_run_rows did not "
                             "rise by one per chunk")
    for s, g, m in zip(spec["sweeps"], grids, models):
        s["check"](g, s["name"], m)
        check_common(g, s["name"])
    # ---- the same question again: answered from the store -----------------
    puts = svc.store.puts
    again = [svc.sweep(s["topo"](), backend="cuda", **s["kw"])
             for s in spec["sweeps"]]
    if ws.ws_sim_cuda.launches != total or svc.store.puts != puts:
        raise AssertionError(f"{path}: the repeated sweep launched a kernel "
                             "or wrote the store")
    fresh = SimulationService(root=store_root)     # empty memory tier: disk
    disk = [fresh.sweep(s["topo"](), backend="cuda", **s["kw"])
            for s in spec["sweeps"]]
    if ws.ws_sim_cuda.launches != total or fresh.store.hits_disk != n_chunks:
        raise AssertionError(f"{path}: a fresh service did not answer from "
                             "disk")
    for g, a, d in zip(grids, again, disk):
        for f in ("makespan", "n_requests", "total_idle", "seed"):
            if not (np.array_equal(getattr(g, f), getattr(a, f))
                    and np.array_equal(getattr(g, f), getattr(d, f))):
                raise AssertionError(f"{path}: stored answer differs in {f}")
        for k in g.extras:
            if not (np.array_equal(g.extras[k], a.extras[k])
                    and np.array_equal(g.extras[k], d.extras[k])):
                raise AssertionError(f"{path}: stored answer differs in {k}")
    # ---- sampled rows against the serial numpy twin -----------------------
    t1 = time.perf_counter()
    n_oracle = 0
    for s, g, m in zip(spec["sweeps"], grids, models):
        grid_against_twin(g, m, s["oracle_rows"], s["name"])
        n_oracle += len(s["oracle_rows"])
    out = dict(path=path, body=body, rows=sum(len(g) for g in grids),
               chunks=n_chunks, launches=launches[body],
               launches_by_body=launches, launches_by_variant=by_variant,
               wall_seconds=wall,
               total_events=sum(s["events"] for s in sweeps),
               events_per_second=sum(s["events"] for s in sweeps) / wall,
               sweeps=sweeps, repeat_from_store=True, oracle_rows=n_oracle,
               oracle_seconds=round(time.perf_counter() - t1, 3),
               card=card_line())
    say("main_path", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 4b: the query path — estimator, coalescing broker, self-healing
# dispatch, sanitizer — and the planner that drives it, on the ws_sim kernel.
# ---------------------------------------------------------------------------

# sched/planner.py's fleet: 4 pods of 256 chips, one group per 8 chips
# (tpu_fleet(4, 32): p = 128, ICI 1, DCN 40), 4096 units a group (W = 524288)
PLANNER = dict(n_pods=4, chips_per_pod=256, dcn_delay=40, work_per_group=4096,
               reps=64)
# benchmarks/run.py::service_throughput's four threshold queries
PARITY = dict(p=32, W=200_000, lams=(2, 10, 30, 50), reps=16, seed0=11,
              thetas=((0, 0), (0, 2), (8, 0), (16, 2)))


@contextmanager
def pinned_zip_clock():
    """An npz is a zip, and a zip member carries its time of writing: pin
    the clock zipfile reads, so that two writes of the same arrays are the
    same bytes whenever they happen."""
    fixed = time.mktime((2020, 1, 1, 0, 0, 0, 0, 0, -1))
    real = zipfile.time
    zipfile.time = types.SimpleNamespace(time=lambda: fixed,
                                         localtime=time.localtime)
    try:
        yield
    finally:
        zipfile.time = real


class KernelClock:
    """Device time of every ``ws_sim`` launch made inside the block: a CUDA
    event pair recorded on the launch's stream right before and after the
    kernel launcher's call (the wrapper's host work and uploads stay
    outside). Also the host time of the sanitizer's oracle replays, which
    run inside the dispatches."""

    def __enter__(self):
        self.pairs, self.replay_s = [], 0.0
        self._lib, self._replay = ws._lib, san._replay
        clock = self

        class Timed:
            def __init__(self, lib):
                self._l = lib

            def __getattr__(self, name):
                fn = getattr(self._l, name)
                if not name.endswith("_launch"):
                    return fn

                def launch(*args):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    err = fn(*args)
                    b.record()
                    clock.pairs.append((a, b))
                    return err
                return launch

        def replay(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self._replay(*args, **kw)
            finally:
                clock.replay_s += time.perf_counter() - t0

        ws._lib = lambda defines=(): Timed(self._lib(defines))
        san._replay = replay
        return self

    def __exit__(self, *exc):
        ws._lib, san._replay = self._lib, self._replay
        torch.cuda.synchronize()
        self.kernel_ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        return False


def query_step(svc, run) -> tuple:
    """Run ``run()`` with every count at 0 just before: its result and the
    step's numbers (dispatches and their rows, launches by body and
    variant, wall, summed kernel ms, store writes, the oracle replays, the
    device idle share)."""
    d0, log0 = svc.n_dispatches, len(svc.broker.dispatch_log)
    ws.reset_counts()
    torch.cuda.synchronize()
    with KernelClock() as kc, obs.trace_to(None) as tracer:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {n: sum(ms) for n, ms in tracer.durations_ms().items()}
    log = list(svc.broker.dispatch_log)[log0:]
    launches = dict(ws.ws_sim_cuda.launches_by_body)
    if ws.ws_sim_cuda.launches != len(kc.pairs):
        raise AssertionError("the kernel clock missed a launch")
    if any(e["backend"] != "cuda" for e in log):
        raise AssertionError(f"a dispatch left the cuda backend: {log}")
    host_wall = wall - kc.replay_s
    return out, dict(
        n_dispatches=svc.n_dispatches - d0,
        rows_per_dispatch=[e["n_rows"] for e in log],
        padded_rows_per_dispatch=[e["n_padded"] for e in log],
        queries_per_dispatch=[e["n_queries"] for e in log],
        relaxed_dispatches=sum(bool(e["relaxed"]) for e in log),
        degraded_dispatches=sum(bool(e["degraded"]) for e in log),
        launches=ws.ws_sim_cuda.launches, launches_by_body=launches,
        launches_by_variant=dict(ws.ws_sim_cuda.launches_by_variant),
        wall_seconds=wall, wall_seconds_without_replay=host_wall,
        kernel_ms=kc.kernel_ms,
        store_put_ms=spans.get("store.put", 0.0),
        sanitizer_replay_seconds=kc.replay_s,
        device_idle=1.0 - kc.kernel_ms / 1e3 / wall,
        device_idle_without_replay=1.0 - kc.kernel_ms / 1e3 / host_wall)


def stored_sweep(root: Path, path: str) -> sw.GridResult:
    """The answer of ``drive_path``'s sweep of ``path`` (held there against
    the plain version and the serial twin), read back from its store with
    no launch."""
    (s,) = MAIN_PATHS[path]["sweeps"]
    n = ws.ws_sim_cuda.launches
    g = SimulationService(root=root / path).sweep(s["topo"](), backend="cuda",
                                                  **s["kw"])
    if ws.ws_sim_cuda.launches != n:
        raise AssertionError(f"the stored {path} sweep launched a kernel")
    return g


def query_rows_against(g: sw.GridResult, model, sweep: sw.GridResult,
                       name: str) -> dict:
    """Every row of a query's grid against a reference: the sweep's row of
    the same W, latencies, thresholds and seed, every column byte for byte;
    a row the sweep does not hold, against the serial numpy twin. Fails on
    a row that neither can answer."""
    def ident(gr, k):
        return tuple(int(x[k]) for x in (
            gr.W, gr.lam, gr.extras["lam_local"], gr.theta_static,
            gr.theta_comm, gr.seed))
    index = {ident(sweep, k): k for k in range(len(sweep))}
    if set(g.extras) != set(sweep.extras):
        raise AssertionError(f"{name}: extras {sorted(g.extras)} != the "
                             f"sweep's {sorted(sweep.extras)}")
    cols = [f.name for f in dataclasses.fields(sw.GridResult)
            if f.name not in ("p", "extras")]
    n_sweep, n_twin = 0, 0
    for k in range(len(g)):
        j = index.get(ident(g, k))
        if j is None:
            grid_against_twin(g, model, [k], name)
            n_twin += 1
            continue
        for f, a, b in [(c, getattr(g, c), getattr(sweep, c)) for c in cols] \
                + [(x, g.extras[x], sweep.extras[x]) for x in g.extras]:
            if a.dtype != b.dtype or not np.array_equal(a[k], b[j]):
                raise AssertionError(f"{name} row {k}: {f}={a[k]} != the "
                                     f"sweep's row {j} {b[j]}")
        n_sweep += 1
    return dict(rows=len(g), rows_equal_to_the_sweep=n_sweep,
                rows_equal_to_the_twin=n_twin)


def npz_bytes(root: Path, keys) -> dict:
    return {k: ((root / f"{k}.npz").read_bytes(),
                (root / f"{k}.json").read_bytes()) for k in keys}


def same_cells(a, b, what: str):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=True):
                raise AssertionError(f"{what}: CellTable {f.name} differs")
        elif x != y:
            raise AssertionError(f"{what}: CellTable {f.name} differs")


def phase_query_main_path(root: Path, sweeps: Path) -> dict:
    """The query path's steps, each counted on its own, under the sanitizer
    (every dispatch replays two rows on the numpy oracle, on the host: a
    check, never the answer). Fails on any sanitizer violation. ``sweeps``
    holds the stores of ``drive_path``'s sweeps."""
    t_phase = time.perf_counter()
    san.install(replay_denom=1, replay_rows=2)
    san.reset()
    try:
        with pinned_zip_clock():
            out = query_steps(root, sweeps)
        s = san.summary()
    finally:
        san.uninstall()
    if s["violations_total"] or not s["n_replayed_rows"]:
        raise AssertionError(f"sanitizer: {s['violations_by_rule']} "
                             f"({s['n_replayed_rows']} rows replayed)")
    say("query_main_path", step="sanitizer",
        **{k: v for k, v in s.items() if k != "recent"})
    out["seconds"] = time.perf_counter() - t_phase
    say("query_main_path", step="done", seconds=out["seconds"])
    return out


def query_steps(root: Path, sweeps: Path) -> dict:
    launches = dict.fromkeys(BODIES, 0)

    def count(step):
        for b, n in step["launches_by_body"].items():
            launches[b] += n
        if step["launches_by_variant"] != {"registers": step["launches"]}:
            raise AssertionError(f"launches off the register variant: "
                                 f"{step['launches_by_variant']}")

    # 1. the planner: one query_many of the strategy x MWT x rp grid (the
    # theta variants of a combination coalesce), then the paired rematch
    svc = SimulationService(root=root / "planner",
                            metrics=obs.MetricsRegistry())
    asked = []
    query_many = svc.query_many

    def recording(qs):
        asked.append(list(qs))
        return query_many(qs)

    svc.query_many = recording
    dec, step = query_step(svc, lambda: plan_for_mesh(
        **PLANNER, service=svc, backend="cuda"))
    if dec.n_dispatches != step["n_dispatches"] or step["launches"] != \
            step["n_dispatches"] or step["launches_by_body"][
                "ws_sim_divisible"] != step["launches"]:
        raise AssertionError(f"planner: {dec.n_dispatches} dispatches, "
                             f"launches {step['launches_by_body']}")
    if step["queries_per_dispatch"][:10] != [1] * 10 or \
            step["rows_per_dispatch"][:10] != [3 * PLANNER["reps"]] * 10:
        raise AssertionError("planner: the first round is not one dispatch "
                             "of three thresholds per combination")
    count(step)
    decision = dict(strategy=dec.strategy_name, remote_prob=dec.remote_prob,
                    theta=(dec.theta_static, dec.theta_comm), mwt=dec.mwt,
                    expected_makespan=dec.expected_makespan,
                    baseline_makespan=dec.baseline_makespan,
                    delta_mean=dec.delta_mean,
                    delta_half_width=dec.delta_half_width,
                    significant=dec.significant,
                    n_paired_reps=dec.n_paired_reps)
    topo = T.tpu_fleet(PLANNER["n_pods"], PLANNER["chips_per_pod"] // 8,
                       dcn_delay=PLANNER["dcn_delay"])
    say("query_main_path", step="planner", p=topo.p,
        W=PLANNER["work_per_group"] * topo.p, decision=decision,
        table_rows=len(dec.table), card=card_line(), **step)
    again, step_r = query_step(svc, lambda: plan_for_mesh(
        **PLANNER, service=svc, backend="cuda"))
    if again.n_dispatches or step_r["n_dispatches"] or step_r["launches"]:
        raise AssertionError("the replanned fleet dispatched or launched")
    if dataclasses.replace(again, n_dispatches=dec.n_dispatches) != dec:
        raise AssertionError("the replanned fleet gave another decision")
    say("query_main_path", step="replan", **step_r)

    # 2. an adaptive CI query at the paper's largest platform
    svc2 = SimulationService(root=root / "adaptive_ci",
                             metrics=obs.MetricsRegistry())
    lams = [2, 62, 262, 482]
    r, step = query_step(svc2, lambda: svc2.query(
        T.one_cluster(256, 1), W_list=[MAIN_W], lam_list=lams, ci=0.01,
        ci_relative=True, batch_reps=64, max_reps=1024, backend="cuda"))
    cells = r.cells
    met = cells.half_width <= 0.01 * np.abs(cells.mean)
    if not (met | (cells.n >= 1024)).all() or step["launches"] != r.n_rounds:
        raise AssertionError(f"adaptive CI query: target missed "
                             f"({cells.half_width}) or launches != rounds")
    fixed = [fixed_reps_for_width(float(cells.std[c]),
                                  0.01 * float(cells.mean[c]))
             for c in range(len(cells))]
    count(step)
    say("query_main_path", step="adaptive_ci", p=256, W=MAIN_W, lams=lams,
        rounds=r.n_rounds, reps_per_cell=cells.n.tolist(),
        reps_spent=int(cells.n.sum()),
        fixed_reps_for_width_per_cell=fixed,
        fixed_reps_uniform=max(fixed) * len(cells),
        half_width_over_mean=(cells.half_width / cells.mean).tolist(),
        card=card_line(), **step)

    # 3. query_many over the other two bodies, the sweep paths' shapes
    svc3 = SimulationService(root=root / "bodies",
                             metrics=obs.MetricsRegistry())
    dag_q = svc3.make_query(T.one_cluster(32, 1), task_model="dag",
                            dag=MAIN_DAG, max_events=1 << 20,
                            lam_list=[2, 10, 62], reps=64, backend="cuda")
    ad_q = svc3.make_query(T.one_cluster(256, 1), task_model="adaptive",
                           W_list=[MAIN_W], pool_cap=1 << 13,
                           lam_list=lams, reps=16, backend="cuda")
    held = {"dag": stored_sweep(sweeps, "dag"),
            "adaptive": stored_sweep(sweeps, "adaptive")}
    (rd, ra), step = query_step(svc3, lambda: svc3.query_many([dag_q, ad_q]))
    check_dag(rd.grid, "query dag", dag_q.model)
    check_adaptive(ra.grid, "query adaptive", ad_q.model)
    for g in (rd.grid, ra.grid):
        check_common(g, "query bodies")
    if step["launches_by_body"] != {"ws_sim_divisible": 0, "ws_sim_dag": 1,
                                    "ws_sim_adaptive": 1}:
        raise AssertionError(f"bodies: launches {step['launches_by_body']}")
    count(step)
    # the padded, straggler-sorted launches against a reference, every row
    t1 = time.perf_counter()
    against = {"dag": query_rows_against(rd.grid, dag_q.model, held["dag"],
                                         "query dag"),
               "adaptive": query_rows_against(ra.grid, ad_q.model,
                                              held["adaptive"],
                                              "query adaptive")}
    say("query_main_path", step="dag_and_adaptive",
        mean_makespan={"dag": rd.cells.mean.tolist(),
                       "adaptive": ra.cells.mean.tolist()},
        rows_against_a_reference=against,
        reference_seconds=time.perf_counter() - t1,
        card=card_line(), **step)

    # 4. step 1's query_many again, into a fresh store, under faults: one
    # poisoned row at backend.run_rows (it fails three times, then heals)
    # and one transient failure of the first broker.dispatch
    first = asked[0]
    seeds = {int(x) for q in first for x in sw.grid_rows(
        q.W_list, q.lam_list, q.reps, q.theta, seed0=q.seed0).seed} | {1}
    poison = next(rz.FaultPlan(rng_seed=k) for k in range(100_000)
                  if sum(rz.FaultPlan(rng_seed=k).row_poisoned(
                      rz.Prob(1 / len(seeds)), x) for x in seeds) == 1)
    plan = rz.FaultPlan(rng_seed=poison.rng_seed, sites={
        "backend.run_rows": rz.Prob(1 / len(seeds), per_row=True,
                                    max_faults=3, match={"backend": "cuda"}),
        "broker.dispatch": rz.At(0)})
    svc4 = SimulationService(root=root / "faults",
                             metrics=obs.MetricsRegistry())
    others = {n: bk.get_backend(n).n_run_rows for n in ("torch", "oracle")}
    replays = san.summary()["n_replayed_dispatches"]
    with rz.fault_plan(plan):
        res4, step = query_step(svc4, lambda: svc4.query_many(first))
    deg = svc4.stats()["degraded"]
    if bk.get_backend("torch").n_run_rows != others["torch"] or \
            bk.get_backend("oracle").n_run_rows - others["oracle"] != \
            san.summary()["n_replayed_dispatches"] - replays:
        raise AssertionError("a faulted dispatch ran off the cuda backend")
    if not deg["salvaged_rows"] > 0 or not step["degraded_dispatches"] or \
            plan.n_fired.get("backend.run_rows") != 3 or \
            plan.n_fired.get("broker.dispatch") != 1:
        raise AssertionError(f"faults: {deg}, fired {plan.n_fired}")
    keys = [q.key() for q in first]
    if npz_bytes(root / "faults", keys) != npz_bytes(root / "planner", keys):
        raise AssertionError("the faulted answers' bytes differ")
    count(step)
    say("query_main_path", step="faults", plan=json.loads(plan.to_json()),
        fired=plan.n_fired, chain=rz.fallback_chain("cuda", first[0].model),
        degraded={k: deg[k] for k in ("retries", "salvaged_rows",
                                      "dispatch_failures", "fallbacks")},
        same_bytes=len(keys), **step)

    # 5. cuda against the plain loop on the card, byte for byte; then the
    # same queries cold and warm
    def thetas(svc, backend):
        return [svc.make_query(T.one_cluster(PARITY["p"], 1),
                               W_list=[PARITY["W"]],
                               lam_list=list(PARITY["lams"]), theta=(th,),
                               reps=PARITY["reps"], seed0=PARITY["seed0"],
                               backend=backend)
                for th in PARITY["thetas"]]

    cold = SimulationService(root=root / "parity_cuda",
                             metrics=obs.MetricsRegistry())
    rc, step = query_step(cold, lambda: cold.query_many(thetas(cold, "cuda")))
    plain = SimulationService(root=root / "parity_torch",
                              metrics=obs.MetricsRegistry())
    t0 = time.perf_counter()
    rt = plain.query_many(thetas(plain, "torch"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if plain.broker.dispatch_log[0]["backend"] != "torch":
        raise AssertionError("the plain loop's dispatch was not on torch")
    keys = [r.key for r in rc]
    if keys != [r.key for r in rt] or npz_bytes(
            root / "parity_cuda", keys) != npz_bytes(root / "parity_torch",
                                                     keys):
        raise AssertionError("cuda and the plain loop differ in keys or "
                             "bytes")
    for a, b in zip(rc, rt):
        same_cells(a.cells, b.cells, "cuda vs torch")
    warm, step_w = query_step(cold, lambda: cold.query_many(
        thetas(cold, "cuda")))
    disk = SimulationService(root=root / "parity_cuda",
                             metrics=obs.MetricsRegistry())
    from_disk, step_d = query_step(disk, lambda: disk.query_many(
        thetas(disk, "cuda")))
    if step_w["launches"] or step_d["launches"] or not all(
            r.from_cache for r in warm + from_disk):
        raise AssertionError("a warm query launched a kernel")
    count(step)
    n = len(PARITY["thetas"])
    say("query_main_path", step="parity_and_rate", **{
        k: v for k, v in PARITY.items() if k != "thetas"},
        same_keys_and_bytes=len(keys), plain_loop_seconds=plain_s,
        queries_per_second={"cold": n / step["wall_seconds"],
                            "warm_memory": n / step_w["wall_seconds"],
                            "warm_disk": n / step_d["wall_seconds"],
                            "plain_loop_on_the_card": n / plain_s},
        # what a user sees: the sanitizer is off unless asked for
        queries_per_second_without_replay={
            "cold": n / step["wall_seconds_without_replay"],
            "warm_memory": n / step_w["wall_seconds_without_replay"],
            "warm_disk": n / step_d["wall_seconds_without_replay"]},
        card=card_line(), **step)
    if not all(launches.values()):
        raise AssertionError(f"a body was not launched: {launches}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# Phase 5: each body's time, its plain version's, and its bound.
# ---------------------------------------------------------------------------

# int32 operations the *function* needs per event, whatever the implementation:
# counted from the handlers of ``repro_torch.core.divisible`` / ``dag`` /
# ``adaptive`` / ``engine`` with the next event kept in a tournament tree over
# the p event times (an update costs one compare and one select per level) and
# the remaining work (divisible) kept as a running sum, so that no event needs
# a pass over the p processors.
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
# the DAG and adaptive handlers
OPS_TASK_IDLE = 4       # load cur_task, test, finished test, deque-empty test
OPS_ENTER_IDLE = 2      # active_count, idle_since
OPS_DAG_COMPLETE = 6    # n_completed, load dur, executed, tasks_run, CSR bounds
OPS_EDGE = 7            # per child: load child, load pred, decrement, store,
#                         ready test, push store, tail
OPS_DAG_POP = 6         # position, load buf, load dur, end time, two stores
OPS_DAG_REQUEST = 14    # qlen (3), threshold, channel, ok, head (2), load buf,
#                         busy_until, answer (3), counts (2)
OPS_TASK_ANSWER_OK = 10  # task >= 0, load length, end, state/ev_time/stolen/
#                         cur_task, active_count and startup, idle time
OPS_AD_COMPLETE = 9     # n_completed, load mpar, test, load tpred, decrement,
#                         store, ready test, push (2)
OPS_AD_POP = 8          # position, load buf, load tdur, end, stores, executed
OPS_AD_REQUEST = 22     # queue test (3), running-work test with is_merge (4),
#                         w_v, threshold, amt, room, split test (8), answer (4),
#                         counts (3)
OPS_SPLIT = 16          # merge duration (3), ten pool and victim stores,
#                         counters (3)


def kernel_bound_ms(model, scn, res) -> tuple:
    """The least time the card could take for this launch: the larger of
    (bytes that must move) / (memory rate) and (int32 operations this run's
    data needs) / (int32 rate). Returns (ms, "bytes" | "operations", detail).

    The operations are those of the function, not of this kernel: per event
    the handler's scalar arithmetic (the ``OPS_*`` counts above, times how
    often this run's data took each handler, plus per child edge of a DAG
    completion and per adaptive split) and an O(log p) update of the
    next-event structure per changed event time; per row one pass over the
    p processors for the terminal idle time. Bytes: each input read once
    (scenario, topology, a DAG's CSR arrays), each result leaf written once.
    """
    G, p = int(scn.W.shape[0]), model.p
    size = lambda xs: sum(x.numel() * x.element_size() for x in xs)
    bytes_in = size(scn) + 4 * p + 4 * p * p      # cluster ids and hops, once
    if isinstance(model, dg.DagModel):
        bytes_in += size(model.static_arrays("cpu"))
    bytes_out = size(res)
    total = lambda x: int(x.to(torch.int64).sum())
    events, n_req = total(res.n_events), total(res.n_requests)
    n_ok, n_fail = total(res.n_success), total(res.n_fail)
    # an event is an idle, a request or an answer; answers follow requests
    idle_events = max(events - 2 * n_req, 0)
    # steals started by an idle event (the others follow a failed answer)
    idle_steals = max(n_req - n_fail, 0)
    levels = math.ceil(math.log2(p))
    strategy = model.topology.strategy
    steal = OPS_VICTIM[strategy] + OPS_DIST + 1   # + the request's arrival time
    if strategy == T.INV_DISTANCE:
        steal += levels                           # binary search of the sums
    detail = dict(events=events, idle_events=idle_events, requests=n_req)
    finish = G * 2 * p                            # idle_now and its sum
    if isinstance(model, dv.DivisibleModel):
        # event times that change: the thief's on every event, the victim's
        # on a successful request
        tree = 2 * levels * (events + n_ok)
        ops = (events * OPS_DISPATCH + tree
               + idle_events * (OPS_IDLE + steal)
               + n_req * (OPS_REQUEST + OPS_DIST)
               + n_ok * OPS_ANSWER_OK + n_fail * (OPS_ANSWER_FAIL + steal)
               + finish)
    elif isinstance(model, dg.DagModel):
        dagf = model.cfg.dag
        done = res.n_completed.to(torch.int64)
        completions = int(done.sum())
        # a completed row visited every edge once; a cut row, in proportion
        n_edges = int(dagf.child_idx.shape[0])
        edges = int((done * n_edges // max(dagf.n, 1)).sum())
        pops = max(idle_events - idle_steals - G, 0)
        tree = 2 * levels * events                # the thief's time only
        ops = (events * OPS_DISPATCH + tree
               + idle_events * OPS_TASK_IDLE
               + completions * OPS_DAG_COMPLETE + edges * OPS_EDGE
               + pops * OPS_DAG_POP
               + idle_steals * (OPS_ENTER_IDLE + steal)
               + n_req * (OPS_DAG_REQUEST + OPS_DIST)
               + n_ok * OPS_TASK_ANSWER_OK
               + n_fail * (OPS_ANSWER_FAIL + steal) + finish)
        detail.update(completions=completions, edges=edges, pops=pops)
    else:
        completions = total(res.n_completed)
        splits = total(res.n_splits)
        pops = max(idle_events - idle_steals - G, 0)
        tree = 2 * levels * (events + splits)     # + the victim's on a split
        ops = (events * OPS_DISPATCH + tree
               + idle_events * OPS_TASK_IDLE
               + completions * OPS_AD_COMPLETE + pops * OPS_AD_POP
               + idle_steals * (OPS_ENTER_IDLE + steal)
               + n_req * (OPS_AD_REQUEST + OPS_DIST) + splits * OPS_SPLIT
               + n_ok * OPS_TASK_ANSWER_OK
               + n_fail * (OPS_ANSWER_FAIL + steal) + finish)
        detail.update(completions=completions, splits=splits, pops=pops)
    bytes_ms = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    detail.update(bytes=bytes_in + bytes_out, int32_ops=ops,
                  ops_per_event=ops / max(events, 1), bytes_ms=bytes_ms,
                  ops_ms=ops_ms)
    return max(bytes_ms, ops_ms), by, detail


#: each timed chunk's kernel ms before the redesign of the event loop (the
#: shared-memory kernel, this script's phase timing then, kept in PERF.md's
#: kernel table; NVIDIA H100 80GB HBM3, 700.00 W), by (sweep, lambda)
WS_MS_BEFORE = {
    ("one_cluster_p256", 2): 18.675801086425782,
    ("one_cluster_p256", 62): 11.257772827148438,
    ("one_cluster_p256", 262): 9.935667419433594,
    ("one_cluster_p256", 482): 8.646329498291015,
    ("two_clusters_p64_local_first", 100): 4.686617660522461,
    ("dag_merge_sort_p32", 2): 133.44782511393228,
    ("dag_merge_sort_p32", 10): 29.2301025390625,
    ("dag_merge_sort_p32", 62): 6.8158823649088545,
    ("adaptive_p256", 2): 200.28875732421875,
    ("adaptive_p256", 62): 13.372416178385416,
    ("adaptive_p256", 262): 10.319936116536459,
    ("adaptive_p256", 482): 8.615456263224283,
}


def time_kernel_ms(model, scn, reps: int) -> float:
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


def time_body(path: str, main: dict, reps: int) -> dict:
    """One body: the kernel alone on every chunk its main path launches,
    then — on the chunk of each sweep whose plain version is timed (the
    chunk with the fewest steps, so that the plain version, which takes one
    step of every row per event, ends in time) — the kernel beside its
    plain version. The first sweep's timed chunk is the shape the
    ``kernels`` line reports, with its bound."""
    spec = MAIN_PATHS[path]
    body = spec["body"]
    per_chunk, shapes = [], []
    for s in spec["sweeps"]:
        topo, kw = s["topo"](), s["kw"]
        model = sweep_model(s)
        rows = sw.grid_rows(kw.get("W_list", (0,)), kw["lam_list"], kw["reps"])
        for ci, lo in enumerate(range(0, len(rows), kw["chunk_size"])):
            c = rows.slice(lo, lo + kw["chunk_size"])
            scn = sw.scenario_from_rows(c, remote_prob=topo.remote_prob,
                                        device=DEV)
            ms = time_kernel_ms(model, scn, reps)
            res = ws.ws_sim_cuda(model, scn)
            ev = int(res.n_events.to(torch.int64).sum())
            longest = int(res.n_events.max())
            variant, slots = ws.variant(topo.p)
            lam = int(c.lam_remote[0])
            per_chunk.append(dict(
                sweep=s["name"], lam=lam, rows=len(c), p=topo.p,
                variant=variant, slots=slots, events=ev,
                max_row_events=longest, ms=ms,
                ns_per_event_longest_row=ms * 1e6 / longest,
                events_per_second=ev / ms * 1e3,
                ms_before=WS_MS_BEFORE.get((s["name"], lam))))
            if ci == s["plain_chunk"]:
                shapes.append((s, model, scn, per_chunk[-1]))
    for s, model, scn, chunk in shapes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ws_sim_ref(model, scn)
        torch.cuda.synchronize()
        chunk["plain_ms"] = (time.perf_counter() - t0) * 1e3
        got = ws.ws_sim_cuda(model, scn)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        WORST[body] = max(WORST[body], err)
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"kernel != plain version at the main-path "
                                 f"shape of {s['name']}")
    s, model, scn, chunk = shapes[0]
    bound_ms, bound_by, detail = kernel_bound_ms(
        model, scn, ws.ws_sim_cuda(model, scn))
    # the kernels of the whole main path: one launch per chunk
    path_ms = sum(c["ms"] for c in per_chunk)
    before = [c["ms_before"] for c in per_chunk]
    path_ms_before = sum(before) if None not in before else None
    entry = {
        "name": body, "route": "cuda", "source": ws.KERNEL_SOURCE,
        "replaces": REPLACES, "body": MODEL_SOURCE[body],
        "launches": main["launches"],
        "launches_by_variant": main["launches_by_variant"],
        "variant": chunk["variant"], "slots": chunk["slots"],
        "max_abs_err": WORST[body],
        "ms": chunk["ms"], "plain_ms": chunk["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": {"sweep": s["name"], "rows": chunk["rows"], "p": chunk["p"],
                  "lam": chunk["lam"], "events": chunk["events"],
                  "max_row_events": chunk["max_row_events"]},
        "ns_per_event_longest_row": chunk["ns_per_event_longest_row"],
        "main_path_kernel_ms": path_ms,
        "bound_detail": detail,
        # numbers of this run only; the times before stay in the timing line
        "per_chunk": [{k: v for k, v in c.items() if k != "ms_before"}
                      for c in per_chunk],
    }
    say("timing", kernel=body, ms=chunk["ms"], plain_ms=chunk["plain_ms"],
        bound_ms=bound_ms, bound_by=bound_by, variant=chunk["variant"],
        ns_per_event_longest_row=chunk["ns_per_event_longest_row"],
        ms_before=chunk["ms_before"], main_path_kernel_ms=path_ms,
        main_path_kernel_ms_before=path_ms_before, per_chunk=per_chunk,
        card=card_line())
    return entry


# ---------------------------------------------------------------------------
# Phase paper: the paper's §4 experiments through the kernel, the log engine
# on a traced launch, the segmented loop, and serve's command line.
# ---------------------------------------------------------------------------

#: the figure benches at --full (benchmarks/paper_torch.py): 100 reps,
#: W=10^8 for Fig 12
FULL_REPS = 100


class Cells:
    """``on_cell`` of a figure bench: keeps each cell's (config, scenario,
    result) on the card for the oracle rows held after the run."""

    def __init__(self):
        self.cells = []

    def __call__(self, cfg, scn, res):
        self.cells.append((cfg, scn, res))

    def events(self) -> int:
        return int(sum(int(r.n_events.sum(dtype=torch.int64))
                       for _, _, r in self.cells))

    def hold(self, picks, what: str) -> float:
        """Row ``k`` of cell ``c`` for each (c, k) of ``picks`` against the
        serial numpy twin, every field (each row's values fit in int32, where
        the twin's Python ints and the kernel's int32 agree). Returns the
        host seconds it took."""
        t0 = time.perf_counter()
        for c, k in picks:
            cfg, scn, res = self.cells[c]
            model = sw.as_model(cfg)
            if int(res.total_idle[k]) < 0 or int(res.makespan[k]) < 0:
                raise AssertionError(f"{what} cell {c} row {k}: int32 wrap")
            hold_against_oracle(model, scn, res, [k], f"{what} cell {c}",
                                model.topology.remote_prob)
        return time.perf_counter() - t0


def counted(fn):
    """``fn()`` with every launch count at 0 just before and read just
    after, its kernel time (CUDA events around each launch) and its wall.
    Returns (value, launches by body, kernel ms, wall s)."""
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with KernelClock() as clk:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(ws.ws_sim_cuda.launches_by_body), clk.kernel_ms, wall


def quiet(fn):
    """``fn()`` with its printing captured; returns (value, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def phase_paper() -> dict:
    """The paper's §4 experiments on the card (module docstring, phase
    ``paper``). Returns the ``ws_sim`` launches of the phase's counted runs
    by body."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(BODIES, 0)

    def add(launches):
        for b, n in launches.items():
            total[b] += n

    # 1. Fig 10 on the paper's own grid: 96 cells x 1000 reps
    grid = ws_paper.grid(full=True)
    cells = Cells()
    (rows, csv), launches, kms, wall = counted(lambda: quiet(
        lambda: pt.fig10_overhead_ratio(grid.reps, grid, on_cell=cells)))
    n_rows = len(cells.cells) * grid.reps
    if len(rows) != 96 or n_rows != 96_000 or \
            launches != {**dict.fromkeys(BODIES, 0), BODIES[0]: 96}:
        raise AssertionError(f"fig10 full grid: {len(rows)} rows, {n_rows} "
                             f"simulations, launches {launches}")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("ratio_med", "fit_med")):
            raise AssertionError(f"fig10 row not finite: {r}")
    add(launches)
    events = cells.events()
    # one row of every cell, a different seed in each
    oracle_s = cells.hold([(c, c % grid.reps) for c in range(96)], "fig10")
    say("paper", step="fig10_full_grid", cells=96, reps=grid.reps,
        rows=n_rows, launches=launches, kernel_ms=kms, wall_seconds=wall,
        events=events, events_per_second_of_wall=events / wall,
        rows_per_second_of_wall=n_rows / wall,
        median_ratio=float(np.median([r["ratio_med"] for r in rows])),
        paper_ratio="4-5.5",
        median_fitted_constant=float(np.median([r["fit_med"]
                                                for r in rows])),
        paper_fitted_constant=3.8, oracle_rows_equal=96,
        oracle_seconds=oracle_s, csv=csv.strip(), card=card_line())
    del cells

    # 2. the other figure benches at --full, a few rows of each held
    benches = (
        ("fig11_accept_latency",
         lambda c: pt.fig11_accept_latency(FULL_REPS, on_cell=c)),
        ("fig12_mwt_swt",
         lambda c: pt.fig12_mwt_swt(FULL_REPS, True, on_cell=c)),
        ("steal_threshold",
         lambda c: pt.steal_threshold(FULL_REPS, on_cell=c)),
        ("multicluster", lambda c: pt.multicluster(FULL_REPS, on_cell=c)))
    for name, bench in benches:
        cells = Cells()
        (rows, csv), launches, kms, wall = counted(
            lambda: quiet(lambda: bench(cells)))
        n = len(cells.cells)
        if not rows or launches[BODIES[0]] != n or sum(launches.values()) \
                != n:
            raise AssertionError(f"{name}: {n} cells, launches {launches}")
        add(launches)
        picks = [(0, 0), (n // 2, FULL_REPS // 2), (n - 1, FULL_REPS - 1)]
        oracle_s = cells.hold(picks, name)
        say("paper", step=name, reps=FULL_REPS, cells=n,
            rows=n * FULL_REPS, launches=launches, kernel_ms=kms,
            wall_seconds=wall, events=cells.events(),
            oracle_rows_equal=len(picks), oracle_seconds=oracle_s,
            csv=csv.strip(), card=card_line())
        del cells

    # 3. the quickstart: its traced run through the kernel and the log
    # engine, then the sweep, the two-cluster strategies and the DAG
    ((res, dec), text), launches, kms, wall = counted(
        lambda: quiet(lambda: qs.single_run()))
    if launches != {**dict.fromkeys(BODIES, 0), BODIES[0]: 1}:
        raise AssertionError(f"quickstart traced run launched {launches}")
    add(launches)
    cfg = dv.EngineConfig(topology=T.one_cluster(8, 10), log_trace=True,
                          max_trace=8192, max_events=1 << 18)
    scn = dv.batch_scenarios(5000, np.array([42], np.uint32), lam=10,
                             device=DEV)
    plain = ws_sim_ref(dv.DivisibleModel(cfg), scn)
    for f in res._fields:
        if not torch.equal(getattr(res, f), getattr(plain, f)[0]):
            raise AssertionError(f"traced launch != plain loop: {f}")
    makespan = int(res.makespan)
    executed = res.executed.cpu().numpy()
    for proc, runs in dec["runs"].items():
        busy = sum(t1 - t0 for t0, t1 in runs)
        if not all(0 <= t0 <= t1 <= makespan for t0, t1 in runs) or \
                busy != executed[proc]:
            raise AssertionError(f"Gantt of P{proc}: {runs} against "
                                 f"makespan {makespan}, executed "
                                 f"{executed[proc]}")
    gantt_lines = gantt.ascii_gantt(dec["runs"], makespan, width=64)
    paje = gantt.to_paje(dec["runs"], makespan)
    rest, rest_launches, rest_kms, rest_wall = counted(lambda: quiet(
        lambda: (qs.sweep(), qs.two_cluster_strategies(),
                 qs.dag_application())))
    if rest_launches != {BODIES[0]: 4, BODIES[1]: 1, BODIES[2]: 0}:
        raise AssertionError(f"quickstart's sweep, strategies and DAG "
                             f"launched {rest_launches}")
    add(rest_launches)
    say("paper", step="quickstart", makespan=makespan,
        n_trace=int(res.n_trace), n_events=int(res.n_events),
        trace_equals_plain_loop=True,
        run_intervals=sum(len(v) for v in dec["runs"].values()),
        steal_arrows=len(dec["arrows"]),
        ascii_gantt_lines=len(gantt_lines.splitlines()),
        paje_lines=len(paje.splitlines()), launches=launches,
        kernel_ms=kms, wall_seconds=wall,
        sweep_strategies_dag_launches=rest_launches,
        sweep_strategies_dag_wall_seconds=rest_wall,
        dag_makespan=int(rest[0][2].makespan), card=card_line())

    # 4. the paper sweep's all_task_models and execution_backends
    (grids, _), launches, kms, wall = counted(
        lambda: quiet(lambda: ps.all_task_models()))
    if launches != dict.fromkeys(BODIES, 1):
        raise AssertionError(f"all_task_models launched {launches}")
    add(launches)
    (parity, _), be_launches, _, be_wall = counted(
        lambda: quiet(lambda: ps.execution_backends()))
    if parity != {"oracle": True, "torch": True, "cuda": True} or \
            be_launches != {**dict.fromkeys(BODIES, 0), BODIES[0]: 1}:
        raise AssertionError(f"execution_backends: parity {parity}, "
                             f"launches {be_launches}")
    add(be_launches)
    say("paper", step="paper_sweep", all_task_models_launches=launches,
        all_task_models_kernel_ms=kms, all_task_models_wall_seconds=wall,
        cells={k: len(g) for k, g in zip(("divisible", "dag", "adaptive"),
                                          grids)},
        execution_backends_parity=parity,
        execution_backends_launches=be_launches,
        execution_backends_wall_seconds=be_wall)

    # 5. the segmented loop: backend_matrix (oracle, torch segmented on the
    # card, cuda), torch == cuda byte for byte, one run under the sanitizer
    (doc, csv), launches, kms, wall = counted(
        lambda: quiet(lambda: pt.backend_matrix(16)))
    by = {r["backend"]: r for r in doc["backends"]}
    if not all(by[b].get("parity_vs_oracle") for b in
               ("oracle", "torch", "cuda")) or \
            launches != {**dict.fromkeys(BODIES, 0), BODIES[0]: 2}:
        raise AssertionError(f"backend_matrix: {doc}, launches {launches}")
    add(launches)
    g = doc["grid"]
    model = sw.resolve_model(T.one_cluster(g["p"], 1), "divisible",
                             W_list=[g["W"]], lam_list=g["lams"],
                             pow2_max_events=True)
    rows = sw.grid_rows([g["W"]], g["lams"], g["reps"])
    tg = sw.run_rows(model, rows, backend="torch")
    seg = bk.get_backend("torch").last_stats
    cg = sw.run_rows(model, rows, backend="cuda")
    if seg is None or not pt.grids_equal(tg, cg):
        raise AssertionError("segmented torch on the card != cuda")
    os.environ[san.ENV] = "1"
    san.reset()
    try:
        sane = sw.run_rows(model, rows, backend="torch")
        s = san.summary()
    finally:
        del os.environ[san.ENV]
    if s["violations_total"] or s["n_probes"] < 2 or \
            not pt.grids_equal(sane, cg):
        raise AssertionError(f"sanitized segmented run: {s}")
    say("paper", step="segmented", grid=g, launches=launches,
        rows_per_second={b: by[b]["rows_per_s"] for b in by
                         if by[b].get("available")},
        parity_vs_oracle={b: by[b]["parity_vs_oracle"] for b in by},
        torch_equals_cuda_bytes=True,
        segment_stats=by["torch"]["segment_stats"],
        wasted_frac_convoy=by["torch"]["wasted_frac_convoy"],
        wasted_frac_actual=by["torch"]["wasted_frac_actual"],
        sanitizer_violations=s["violations_total"],
        sanitizer_probes=s["n_probes"], csv=csv.strip().splitlines()[-1],
        card=card_line())

    # 6. serve's command line at full width: plan, schedule, decode
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run, text = quiet(lambda: serve.main(["--no-reduced"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    planner_launches = dict(ws.ws_sim_cuda.launches_by_body)
    L = get_lm_config(LM_ARCH).n_layers
    steps = SERVE_PROMPT + SERVE_NEW
    lm_counts, lm_variants = lm_counts_since_reset(
        {"rms_norm": {"row_in_registers": steps * (4 * L + 1)},
         "flash_decode": {"single": steps * L}},
        rms_norm=steps * (4 * L + 1), flash_decode=steps * L,
        **planner_launches)
    st = run.stats
    if st.completed != SERVE_REQUESTS or \
            run.tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or \
            sum(planner_launches.values()) != run.decision.n_dispatches:
        raise AssertionError(f"serve.main: {st}, tokens "
                             f"{run.tokens.shape}, planner launches "
                             f"{planner_launches} for "
                             f"{run.decision.n_dispatches} dispatches")
    add(planner_launches)
    d = run.decision
    say("paper", step="serve_main", argv=["--no-reduced"], arch=LM_ARCH,
        decision=dict(strategy=d.strategy_name, remote_prob=d.remote_prob,
                      theta_static=d.theta_static, theta_comm=d.theta_comm,
                      mwt=d.mwt, expected_makespan=d.expected_makespan,
                      baseline_makespan=d.baseline_makespan,
                      significant=d.significant,
                      n_dispatches=d.n_dispatches),
        planner_launches=planner_launches,
        scheduler=dict(n_requests=st.n_requests, n_success=st.n_success,
                       n_fail=st.n_fail,
                       n_cross_cluster_steals=st.n_cross_cluster_steals,
                       completed=st.completed, makespan=st.makespan,
                       idle_time=st.idle_time,
                       per_group_busy=st.per_group_busy.tolist()),
        decode_seconds=run.seconds,
        tokens_per_second=SERVE_REQUESTS * SERVE_NEW / run.seconds,
        launches=lm_counts, launches_by_variant=lm_variants,
        wall_seconds=wall, printed=text.strip().splitlines(),
        card=card_line())
    for body in BODIES:
        if not total[body]:
            raise AssertionError(f"phase paper launched no {body}")
    seconds = time.perf_counter() - t_phase
    say("paper", step="done", launches=total, seconds=seconds)
    return total


# ---------------------------------------------------------------------------
# Phase daemon: the simulation daemon on the card — client processes over a
# unix socket, the daemon's rounds and sweep chunks, the client's library
# mode, a daemon killed mid-round and restarted, and the daemon bench.
# ---------------------------------------------------------------------------

#: the platform of steps 1, 3 and 5 (the paper's largest) and step 1's
#: question, asked by three client processes at once
DAEMON_P = 256
DAEMON_Q = dict(W_list=[10**6, 10**7], lam_list=[2], reps=1000)

#: A client process of the phase: connects, waits for the go file, asks its
#: question (``query`` or ``sweep``) with ``fallback=False`` and prints one
#: JSON line: the answer's summary, its seconds and the wire bytes it sent
#: and received (frames counted at the framing functions).
_DAEMON_CLIENT = """
import json, os, sys, time
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["src"])
from repro_torch.core import one_cluster
from repro_torch.service import DaemonClient, wire
nbytes = {"sent": 0, "received": 0}
send, recv = wire.send_frame, wire._recv_exact
def counted_send(sock, obj):
    nbytes["sent"] += 4 + len(json.dumps(obj, separators=(",", ":")).encode())
    return send(sock, obj)
def counted_recv(sock, n):
    got = recv(sock, n)
    nbytes["received"] += len(got or b"")
    return got
wire.send_frame, wire._recv_exact = counted_send, counted_recv
c = DaemonClient(root=cfg["root"], fallback=False)
assert c.alive()
nbytes.update(sent=0, received=0)
print("READY", flush=True)
while not os.path.exists(cfg["go"]):
    time.sleep(0.001)
t0 = time.perf_counter()
topo = one_cluster(cfg["p"], 1)
if cfg["op"] == "query":
    r = c.query(topo, **cfg["kw"])
    out = dict(key=r.key, from_cache=r.from_cache,
               mean=[float(m) for m in r.cells.mean])
else:
    g = c.sweep(topo, **cfg["kw"])
    out = dict(rows=len(g), makespan_sum=int(g.makespan.sum()),
               events=int(g.extras["n_events"].astype("int64").sum()))
out.update(seconds=time.perf_counter() - t0, fallbacks=c.n_fallbacks,
           answers=c.n_daemon_answers, local=c._local is not None, **nbytes)
print(json.dumps(out), flush=True)
"""


def daemon_clients(root: Path, go: Path, cfgs) -> tuple:
    """One client process per cfg (``_DAEMON_CLIENT``), released together
    once all have connected. Returns (each one's JSON line, the seconds from
    the release to the last answer)."""
    src = str(Path(__file__).resolve().parent / "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DAEMON_CLIENT,
         json.dumps(dict(c, src=src, root=str(root), go=str(go)))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cfgs]
    try:
        for p in procs:
            if p.stdout.readline().strip() != "READY":
                raise AssertionError(f"a daemon client did not connect: "
                                     f"{p.communicate(timeout=60)[1][-2000:]}")
        t0 = time.perf_counter()
        go.touch()
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"a daemon client failed:\n"
                                     f"{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [o for o in outs if o["fallbacks"] or o["local"]]
    if bad:
        raise AssertionError(f"a daemon client fell back: {bad}")
    return outs, wall


def daemon_step(d, run) -> tuple:
    """``run()`` with every count at 0 just before: its result and the
    step's numbers (launches by body read just after, kernel ms, wall, the
    daemon's dispatches, rounds and RPCs in the step, and the summed ms of
    each obs span the smoke's process recorded — the daemon's threads
    included: ``daemon.rpc`` per op, ``daemon.round``, ``store.put``,
    ``backend.run_rows``)."""
    d0, r0, rpc0 = d.service.n_dispatches, d.n_rounds, d.n_rpcs
    reset_all_counts()
    torch.cuda.synchronize()
    with KernelClock() as kc, obs.trace_to(None) as tracer:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ws.ws_sim_cuda.launches_by_body)
    if ws.ws_sim_cuda.launches != len(kc.pairs):
        raise AssertionError("the kernel clock missed a launch")
    return out, dict(launches=launches, kernel_ms=kc.kernel_ms,
                     wall_seconds=wall,
                     n_dispatches=d.service.n_dispatches - d0,
                     n_rounds=d.n_rounds - r0, n_rpcs=d.n_rpcs - rpc0,
                     span_ms={n: sum(ms) for n, ms in
                              tracer.durations_ms().items()})


def same_stored_bytes(a: Path, b: Path, keys, what: str) -> int:
    """The npz of each key under two store roots, byte for byte (the zip
    clock pinned by the caller)."""
    for k in keys:
        if (a / f"{k}.npz").read_bytes() != (b / f"{k}.npz").read_bytes():
            raise AssertionError(f"{what}: stored npz of {k} differs from "
                                 "library mode's")
    return len(keys)


def daemon_cli(root: Path, fault_plan=None) -> subprocess.Popen:
    """``python -m repro_torch.service.daemon --root ROOT`` on the card,
    ``REPRO_WS_FAULT_PLAN`` set in its environment only; returns once it
    printed READY. A thread reaps it the moment it exits, so its pid stops
    answering and the store locks of a daemon that died are broken at once
    (a zombie's pid still looks alive)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    env.pop(rz.FAULT_PLAN_ENV, None)
    if fault_plan is not None:
        env[rz.FAULT_PLAN_ENV] = json.dumps(fault_plan)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service.daemon", "--root",
         str(root), "--coalesce-window-s", "0.01"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("READY"):
        proc.kill()
        raise AssertionError(f"the daemon did not start: "
                             f"{proc.communicate(timeout=60)[1][-2000:]}")
    threading.Thread(target=proc.wait, daemon=True).start()
    return proc


def phase_daemon(tmp: Path) -> dict:
    """The simulation daemon on the card (module docstring, phase
    ``daemon``). Returns the ``ws_sim`` launches of the phase's counted
    steps by body."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(BODIES, 0)

    def add(launches):
        for b, n in launches.items():
            total[b] += n

    store = tmp / "store"
    d = SimulationDaemon(root=store, coalesce_window_s=0.25).start()
    try:
        with pinned_zip_clock():
            daemon_steps(d, tmp, add)
    finally:
        d.stop()
    with pinned_zip_clock():
        killed_mid_round(tmp / "killed", add)

    # 6. the daemon bench: a warm shared daemon against cold processes
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc, text = quiet(lambda: dt.daemon_throughput())
    wall = time.perf_counter() - t0
    launches = dict(ws.ws_sim_cuda.launches_by_body)
    if launches[BODIES[0]] < 1 or launches[BODIES[0]] != \
            sum(launches.values()) or doc["daemon"]["n_dispatches"] < 1 or \
            doc["library"]["n_dispatches"] != dt.N_CLIENTS * dt.N_QUERIES:
        raise AssertionError(f"daemon bench: {doc}, launches {launches}")
    add(launches)
    say("daemon", step="daemon_throughput", workload=doc["workload"],
        daemon=doc["daemon"], library=doc["library"],
        speedup_vs_library=doc["speedup_vs_library"], launches=launches,
        wall_seconds=wall, csv=text.strip().splitlines()[0],
        card=card_line())
    for body in BODIES:
        if not total[body]:
            raise AssertionError(f"phase daemon launched no {body}")
    seconds = time.perf_counter() - t_phase
    say("daemon", step="done", launches=total, seconds=seconds)
    return total


def daemon_steps(d, tmp: Path, add) -> None:
    """Steps 1-4 of phase ``daemon`` against the in-process daemon ``d``."""
    store = d.store.root
    none = dict.fromkeys(BODIES, 0)

    # 1. three client processes, one question, one dispatch
    topo = T.one_cluster(DAEMON_P, 1)
    outs, st = daemon_step(d, lambda: daemon_clients(
        store, tmp / "go1", [dict(op="query", p=DAEMON_P, kw=DAEMON_Q)] * 3))
    outs, wall = outs
    keys = {o["key"] for o in outs}
    # RPCs: a ping, a submit and a flush a client
    if len(keys) != 1 or st["n_dispatches"] != 1 or st["n_rpcs"] != 9 or \
            st["launches"] != {**none, BODIES[0]: 1}:
        raise AssertionError(f"three clients: keys {keys}, {st}")
    (key,) = keys
    lib = SimulationService(root=tmp / "lib1").query(topo, **DAEMON_Q)
    if lib.key != key or lib.from_cache:
        raise AssertionError("library mode asked another question")
    same_stored_bytes(store, tmp / "lib1", [key], "three clients")
    if [o["mean"] for o in outs] != [lib.cells.mean.tolist()] * 3:
        raise AssertionError("a client's cell means differ from library "
                             "mode's")
    add(st["launches"])
    say("daemon", step="three_clients_one_dispatch", clients=3, p=DAEMON_P,
        question=DAEMON_Q, rows=2 * DAEMON_Q["reps"], **st,
        release_to_last_answer_seconds=wall,
        client_seconds=[o["seconds"] for o in outs],
        from_cache=[o["from_cache"] for o in outs],
        wire_bytes_received=sum(o["received"] for o in outs),
        wire_bytes_sent=sum(o["sent"] for o in outs),
        npz_equal_to_library_mode=True, card=card_line())

    # 2. the paper's grid through sweep_chunk: one client process a p
    grid = ws_paper.grid(full=True)
    kw = dict(W_list=list(grid.W_list), lam_list=list(grid.lam_list),
              reps=grid.reps, chunk_size=1000)
    n_chunks = len(grid.W_list) * len(grid.lam_list) * grid.reps // 1000
    (outs, wall), st = daemon_step(d, lambda: daemon_clients(
        store, tmp / "go2",
        [dict(op="sweep", p=p, kw=kw) for p in grid.p_list]))
    rows = sum(o["rows"] for o in outs)
    events = sum(o["events"] for o in outs)
    # RPCs: a ping and one sweep_chunk a chunk, a client
    if rows != 96_000 or st["launches"] != {**none, BODIES[0]: 96} or \
            st["n_rpcs"] != len(grid.p_list) * (n_chunks + 1):
        raise AssertionError(f"paper grid: {rows} rows, {st}")
    add(st["launches"])
    lib_root = tmp / "lib2"
    svc = SimulationService(root=lib_root)
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = {p: svc.sweep(T.one_cluster(p, 1), **kw) for p in grid.p_list}
    torch.cuda.synchronize()
    lib_wall = time.perf_counter() - t0
    lib_launches = dict(ws.ws_sim_cuda.launches_by_body)
    for o, p in zip(outs, grid.p_list):
        if (o["rows"], o["makespan_sum"]) != (len(lib[p]),
                                              int(lib[p].makespan.sum())):
            raise AssertionError(f"paper grid p={p}: the client's answer "
                                 "differs from library mode's")
    chunk_keys = sorted(f.stem for f in lib_root.glob("*.npz"))
    if len(chunk_keys) != 96:
        raise AssertionError(f"library mode stored {len(chunk_keys)} chunks")
    same_stored_bytes(store, lib_root, chunk_keys, "paper grid")
    t0 = time.perf_counter()
    for i, p in enumerate(grid.p_list):
        model = sw.resolve_model(T.one_cluster(p, 1), "divisible",
                                 W_list=kw["W_list"],
                                 lam_list=kw["lam_list"])
        k = 18_000 + 37 * i          # chunk 18: W=10^8, λ=2, the longest
        from_daemon = d.store.get(sw_chunk_key(model, kw, k // 1000))
        grid_against_twin(from_daemon, model, [k % 1000],
                          f"paper grid p={p}")
    oracle_s = time.perf_counter() - t0
    wire_bytes = sum(o["received"] + o["sent"] for o in outs)
    say("daemon", step="paper_grid_through_daemon", clients=len(outs),
        p=list(grid.p_list), rows=rows, chunks=len(grid.p_list) * n_chunks,
        events=events,
        **st, release_to_last_answer_seconds=wall,
        rows_per_second_of_wall=rows / wall,
        events_per_second_of_wall=events / wall,
        library_mode=dict(wall_seconds=lib_wall,
                          rows_per_second=rows / lib_wall,
                          events_per_second=events / lib_wall,
                          launches=lib_launches),
        wire_bytes=wire_bytes, wire_bytes_per_row=wire_bytes / rows,
        chunk_keys_equal=len(chunk_keys), npz_equal_to_library_mode=True,
        oracle_rows_equal=len(grid.p_list), oracle_seconds=oracle_s,
        card=card_line())

    # 3. an adaptive question and a paired comparison through the rounds
    c = DaemonClient(root=store, fallback=False)
    ad_q = dict(task_model="adaptive", W_list=[MAIN_W], lam_list=[2, 62],
                pool_cap=1 << 13, reps=64)
    ptopo = T.one_cluster(64, 1)
    pair = dict(W_list=[MAIN_W], lam_list=[62], reps=64)

    def ask():
        r = c.query(topo, **ad_q)
        pr = c.query_pair(c.make_query(ptopo, **pair),
                          c.make_query(ptopo, mwt=True, **pair))
        return r, pr
    (r, pr), st = daemon_step(d, ask)
    if st["launches"][BODIES[2]] < 1 or c.n_fallbacks or \
            c.n_daemon_answers != 2 or st["n_rounds"] < 2:
        raise AssertionError(f"adaptive and pair: {st}, fallbacks "
                             f"{c.n_fallbacks}")
    add(st["launches"])
    svc = SimulationService(root=tmp / "lib3")
    rl = svc.query(topo, **ad_q)
    prl = svc.query_pair(svc.make_query(ptopo, **pair),
                         svc.make_query(ptopo, mwt=True, **pair))
    if rl.key != r.key or prl.key != pr.key or \
            not pt.grids_equal(r.grid, rl.grid) or \
            not pt.grids_equal(pr.grid_a, prl.grid_a) or \
            not pt.grids_equal(pr.grid_b, prl.grid_b) or \
            not np.array_equal(pr.paired.delta_mean, prl.paired.delta_mean):
        raise AssertionError("adaptive and pair: the daemon's answers differ "
                             "from library mode's")
    same_stored_bytes(store, tmp / "lib3", [r.key], "adaptive")
    say("daemon", step="adaptive_and_pair", adaptive=dict(p=DAEMON_P, **ad_q),
        pair=dict(p=64, arms=["swt", "mwt"], **pair), **st,
        adaptive_mean=r.cells.mean.tolist(),
        delta_mean=np.asarray(pr.paired.delta_mean).tolist(),
        n_fallbacks=c.n_fallbacks, equal_to_library_mode=True,
        card=card_line())

    # 4. a DAG cannot cross the wire: the client answers it on the card
    c = DaemonClient(root=store)
    dag_q = dict(task_model="dag", dag=MAIN_DAG, max_events=1 << 20,
                 lam_list=[2], reps=64)
    r, st = daemon_step(d, lambda: c.query(T.one_cluster(32, 1), **dag_q))
    if c.n_fallbacks != 1 or st["n_rpcs"] or st["n_dispatches"] or \
            st["launches"][BODIES[1]] < 1 or \
            c.local.device.type != torch.device(DEV).type:
        raise AssertionError(f"DAG in library mode: {st}, fallbacks "
                             f"{c.n_fallbacks}")
    add(st["launches"])
    model = c.local.make_query(T.one_cluster(32, 1), **dag_q).model
    grid_against_twin(r.grid, model, [0, 63], "DAG in library mode")
    say("daemon", step="dag_in_library_mode", dag=MAIN_DAG.name,
        rows=len(r.grid), **st, n_fallbacks=c.n_fallbacks,
        library_dispatches=c.local.n_dispatches, oracle_rows_equal=2,
        card=card_line())


def sw_chunk_key(model, kw: dict, chunk: int) -> str:
    """The store key of one chunk of a sweep (``SimulationService.sweep``'s
    and the daemon's ``sweep_chunk``'s)."""
    grid = sw.canonical_grid(kw["W_list"], kw["lam_list"], kw["reps"])
    return store_mod.chunk_key(model, grid, kw["chunk_size"], chunk)


def killed_mid_round(root: Path, add) -> None:
    """Step 5 of phase ``daemon``: a daemon process that exits (code 17) at
    its first dispatch; two client threads fall back to library mode on the
    card; a restarted daemon serves the question from the store, and after a
    graceful stop a new daemon loads the straggler history it saved."""
    topo = T.one_cluster(DAEMON_P, 1)
    proc = daemon_cli(root, {"sites": {"broker.dispatch": {"kind": "exit"}}})
    try:
        results, errors = [], []

        def ask(i):
            try:
                c = DaemonClient(root=root, rpc_timeout_s=60.0)
                r = c.query(topo, W_list=[MAIN_W + 10**5 * i], lam_list=[2],
                            reps=256)
                results.append((i, r, c.n_fallbacks, c.local.device.type))
            except Exception as e:         # noqa: BLE001 — the check
                errors.append((i, repr(e)))

        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ws.ws_sim_cuda.launches_by_body)
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if errors or len(results) != 2 or code != 17 or \
            any(nf < 1 or dev != torch.device(DEV).type or
                not np.isfinite(r.cells.mean).all()
                for _, r, nf, dev in results) or launches[BODIES[0]] < 1:
        raise AssertionError(f"killed mid-round: errors {errors}, exit "
                             f"{code}, results {[x[2:] for x in results]}, "
                             f"launches {launches}")
    add(launches)
    first = min(results, key=lambda x: x[0])[1]

    proc = daemon_cli(root)
    try:
        c = DaemonClient(root=root, fallback=False)
        again = c.query(topo, W_list=[MAIN_W], lam_list=[2], reps=256)
        if not again.from_cache or again.key != first.key or \
                not pt.grids_equal(again.grid, first.grid):
            raise AssertionError("the restarted daemon did not serve the "
                                 "question from the store")
        c.query(topo, W_list=[MAIN_W + 10**6], lam_list=[2], reps=256)
        if not c.shutdown():
            raise AssertionError("the restarted daemon refused to stop")
        code2 = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    d3 = SimulationDaemon(root=root)
    loaded = d3.metrics.gauge("daemon.history_loaded").value
    if code2 != 0 or loaded <= 0 or len(d3.service.broker.history) != loaded:
        raise AssertionError(f"restart: exit {code2}, history loaded "
                             f"{loaded}")
    say("daemon", step="killed_mid_round", client_threads=2,
        client_exceptions=len(errors), daemon_exit_code=code,
        fallbacks=[nf for _, _, nf, _ in sorted(results, key=lambda x: x[0])],
        fallback_device=results[0][3], launches=launches, wall_seconds=wall,
        restart_from_cache=True, graceful_exit_code=code2,
        history_loaded=loaded, card=card_line())


# ---------------------------------------------------------------------------
# Language-model serving path: qwen3-1.7b at full width through the kernels
# rms_norm, flash_attention and flash_decode.
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-1.7b"
LM_SEED = 0
# serve.py's defaults: 24 requests, prompt 16, 8 new tokens
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 24, 16, 8
# production prefill (build_prefill_step): 4 prompts of 2048 tokens
PREFILL_B, PREFILL_S = 4, 2048
# the parity check of tests/test_models_smoke.py (decode vs forward)
PARITY_B, PARITY_S = 2, 32
# Tolerances of the JAX package's kernel tests (tests/test_kernels.py), as
# assert_allclose's atol = rtol: attention 2e-5 in float32 and 2e-2 in
# bfloat16; RMSNorm 1e-6 in float32 and 2e-2 in bfloat16.
LM_TOL = {("attention", torch.float32): 2e-5,
          ("attention", torch.bfloat16): 2e-2,
          ("rms_norm", torch.float32): 1e-6,
          ("rms_norm", torch.bfloat16): 2e-2}
LM_KERNELS = ("rms_norm", "flash_attention", "flash_decode")
LM_SOURCES = {"rms_norm": rn.KERNEL_SOURCE,
              "flash_attention": fa.KERNEL_SOURCE,
              "flash_decode": fd.KERNEL_SOURCE}
LM_REPLACES = {"rms_norm": "src/repro/kernels/rmsnorm.py:36",
               "flash_attention": "src/repro/kernels/flash_attention.py:98",
               "flash_decode": "src/repro/kernels/decode_attention.py:85"}
#: the attention kernel each dtype is routed to (kernels/flash_attention.py)
ATTN_VARIANT = {torch.bfloat16: "tc_bf16", torch.float32: "simt_f32"}
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): the operations of a
# function bound it at the peak for its operands' type — bf16 on the tensor
# cores, float32 outside them (TF32 would change the numbers).
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: the worst |kernel - plain| per kernel over every comparison of this run
LM_WORST = dict.fromkeys(LM_KERNELS, 0.0)

#: each kernel's device time at the same shapes before its redesign (this
#: script's phase lm_timing then, kept in PERF.md's kernel table; NVIDIA H100
#: 80GB HBM3, 700.00 W), keyed by kernel and shape
EARLIER_MS = {("rms_norm", (8192, 2048)): 0.09501952171325684,
              ("rms_norm", (131072, 128)): 0.03481791973114014,
              ("rms_norm", (24, 2048)): 0.007502400279045105,
              ("flash_attention", (4, 2048)): 5.592787170410157,
              ("flash_decode", (24, 24)): 0.0036075198650360107,
              ("flash_decode", (24, 2048)): 0.1580076789855957,
              # the first kernel at the reference's decode_32k length, timed
              # by benchmarks/flash_decode_bench.py run in the tree before
              # its redesign (NVIDIA H100 80GB HBM3, 700.00 W)
              ("flash_decode", (1, 32768)): 2.169217987060547}


def lm_compare(kernel: str, got, want, tol: float, what: str) -> dict:
    """``got`` against ``want`` as ``assert_allclose(atol=tol, rtol=tol)``;
    returns the case's line (max abs error, the worst share of the allowed
    error) or raises."""
    g, w = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{kernel} {what}: {tuple(got.shape)} "
                             f"{got.dtype} vs {tuple(want.shape)} "
                             f"{want.dtype}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{kernel} {what}: non-finite output")
    err = (g - w).abs()
    share = float((err / (tol + tol * w.abs())).max())
    max_err = float(err.max())
    LM_WORST[kernel] = max(LM_WORST[kernel], max_err)
    if share > 1.0:
        raise AssertionError(f"{kernel} {what}: max abs error {max_err} "
                             f"exceeds the tolerance {tol} (x{share:.3f})")
    return dict(case=what, max_abs_err=max_err, tol=tol,
                share_of_tol=share)


def lm_within_a_bf16_step(kernel: str, got, want, what: str) -> dict:
    """A bfloat16 output held to its own scale: the kernel and the plain
    version round float32 values that agree to float32's tolerance, so they
    differ by one bfloat16 step at most, and no step below the output's
    largest value M exceeds 2**-7 M. Limit: (2**-7 + 2e-5) M. Unlike an
    absolute 2e-2, it shrinks with the output (flash decode over a long
    cache averages thousands of rows to about 0.01), so it catches a merge
    that drops or mis-weights a split. Returns the case's numbers or
    raises."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    limit = (2.0 ** -7 + LM_TOL[("attention", torch.float32)]) * scale
    err = float((g - w).abs().max())
    if not err <= limit:
        raise AssertionError(f"{kernel} {what}: max abs error {err} exceeds "
                             f"one bfloat16 step of max|want| = {scale} "
                             f"({limit})")
    return dict(max_abs_want=scale, scaled_limit=limit,
                share_of_scaled_limit=err / limit if limit else 0.0)


def lm_randn(gen, shape, dtype, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def lm_rms_cases(gen, dtype):
    """(rows, D) of the serving path — decode: norm1/norm2/final (24, 2048),
    q_norm (24 x 16, 128), k_norm (24 x 8, 128); prefill: (8192, 2048),
    (8192 x 16, 128), (8192 x 8, 128) — tests/test_kernels.py's shapes
    (100 rows: a ragged block), a width of the generic kernel (100); and
    every width of the register kernel at one row, 24 rows and more row
    groups than the card holds at once (its grid-stride loop)."""
    shapes = ((24, 2048), (384, 128), (192, 128), (8192, 2048),
              (131072, 128), (65536, 128), (64, 256), (100, 512),
              (128, 1024), (1, 128), (7, 100))
    shapes += tuple((R, D) for D in rn.REG_WIDTHS for R in (1, 24, 17000))
    tol = LM_TOL[("rms_norm", dtype)]
    out = []
    for R, D in shapes:
        x = lm_randn(gen, (R, D), dtype, 3.0)
        s = lm_randn(gen, (D,), dtype)
        got = ops.rms_norm(x, s, 1e-6)
        torch.cuda.synchronize()
        out.append(lm_compare("rms_norm", got, rn.rms_norm_ref(x, s, 1e-6),
                              tol, f"{dtype} ({R}, {D})"))
    return out


def lm_attention_cases(gen, dtype):
    """(B, Sq, Skv, H, KV, hd, causal, window, q_offset): the prefill shape,
    tests/test_kernels.py's shapes (Sq = 100 and 192: ragged q and kv
    tiles; windows; non-causal), a q_offset, a window at hd 128; then
    ragged Sq / Skv of 33, 100 and 2047 (partial tiles of the tensor-core
    kernel's 128 rows), q_offsets with Skv > Sq, windows, non-causal, G =
    H / KV of 1, 2 and 4, at every head dim."""
    cases = ((PREFILL_B, PREFILL_S, PREFILL_S, 16, 8, 128, True, 0, 0),
             (2, 128, 128, 4, 2, 64, True, 0, 0),
             (1, 256, 256, 4, 4, 32, True, 64, 0),
             (2, 100, 100, 2, 1, 16, True, 0, 0),
             (1, 64, 64, 8, 2, 128, False, 0, 0),
             (1, 192, 192, 6, 3, 32, True, 32, 0),
             (2, 50, 80, 4, 2, 128, True, 0, 30),
             (2, 33, 33, 16, 8, 128, True, 7, 0),
             (1, 33, 33, 4, 4, 128, True, 0, 0),
             (2, 100, 100, 4, 2, 64, True, 0, 0),
             (1, 2047, 2047, 4, 1, 128, True, 0, 0),
             (1, 2047, 2047, 2, 2, 32, False, 0, 0),
             (2, 100, 333, 8, 2, 16, True, 0, 233),
             (1, 256, 700, 4, 2, 128, True, 0, 444),
             (1, 300, 300, 4, 1, 64, True, 100, 0),
             (2, 513, 513, 2, 1, 32, True, 7, 0),
             (1, 200, 600, 4, 2, 16, True, 150, 400),
             (1, 100, 257, 8, 4, 64, False, 0, 0),
             (1, 128, 128, 4, 2, 128, False, 50, 0),
             (2, 1, 40, 4, 2, 128, True, 0, 39))
    tol = LM_TOL[("attention", dtype)]
    out = []
    for B, Sq, Skv, H, KV, hd, causal, win, qo in cases:
        q = lm_randn(gen, (B, Sq, H, hd), dtype)
        k = lm_randn(gen, (B, Skv, KV, hd), dtype)
        v = lm_randn(gen, (B, Skv, KV, hd), dtype)
        kw = dict(causal=causal, window=win, q_offset=qo)
        before = dict(ops.flash_attention.launches_by_variant)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = {k_: n - before[k_] for k_, n in
               ops.flash_attention.launches_by_variant.items()}
        if ran != {**dict.fromkeys(ran, 0), ATTN_VARIANT[dtype]: 1}:
            raise AssertionError(f"flash_attention {dtype}: ran {ran}, the "
                                 f"route is {ATTN_VARIANT[dtype]}")
        out.append(lm_compare(
            "flash_attention", got, fa.flash_attention_ref(q, k, v, **kw),
            tol, f"{dtype} q{(B, Sq, H, hd)} kv{(Skv, KV)} causal={causal} "
                 f"window={win} q_offset={qo}"))
    return out


def lm_decode_cases(gen, dtype):
    """(B, Smax, kv_len, H, KV, hd, window): every kv_len of the serving
    path (Smax = 24), a long cache, tests/test_kernels.py's shapes
    (kv_len < Smax, a window), kv_len = 1; each with q of the cache's type
    and with a float32 q (the prefill default: bf16 cache, f32 q), kv_len
    as an int. Then kv_len as an int32 on the device (as the serving path
    passes it): the serving shape, the split path at (1, 32768) (the
    reference's decode_32k) and at (2, 4096) with windows that leave most
    splits empty. Each launch's variant (one split or several) is checked
    against ``num_splits``; a bfloat16 output is also held to one bfloat16
    step of its largest value (``lm_within_a_bf16_step``)."""
    cases = [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, 16, 8, 128, 0,
              False) for n in range(1, SERVE_PROMPT + SERVE_NEW + 1)]
    cases += [(SERVE_REQUESTS, 2048, 2048, 16, 8, 128, 0, False),
              (2, 256, 200, 4, 2, 64, 0, False),
              (1, 512, 512, 8, 8, 32, 0, False),
              (2, 256, 100, 4, 1, 64, 64, False),
              (1, 384, 300, 4, 2, 128, 0, False),
              (3, 40, 1, 4, 2, 16, 0, False), (3, 40, 39, 4, 2, 16, 5, False)]
    cases += [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, 16, 8, 128, 0,
               True) for n in (1, 13, SERVE_PROMPT + SERVE_NEW)]
    cases += [(1, 32768, 32768, 16, 8, 128, 0, True),
              (1, 32768, 20001, 16, 8, 128, 0, True),
              (1, 32768, 32768, 16, 8, 128, 1000, True),
              (2, 4096, 3000, 16, 8, 128, 300, True),
              (2, 4096, 4096, 8, 1, 64, 700, True),
              (2, 4096, 1, 16, 8, 128, 0, True)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for B, Smax, kvl, H, KV, hd, win, on_device in cases:
        kc = lm_randn(gen, (B, Smax, KV, hd), dtype)
        vc = lm_randn(gen, (B, Smax, KV, hd), dtype)
        arg = (torch.tensor(kvl, dtype=torch.int32, device=DEV) if on_device
               else kvl)
        variant = fd.VARIANTS[fd.num_splits(B, H, KV, Smax, sms)[0] > 1]
        for qdt in dict.fromkeys((dtype, torch.float32)):
            q = lm_randn(gen, (B, 1, H, hd), qdt)
            before = ops.flash_decode.launches_by_variant[variant]
            got = ops.flash_decode(q, kc, vc, arg, window=win)
            torch.cuda.synchronize()
            if ops.flash_decode.launches_by_variant[variant] != before + 1:
                raise AssertionError(f"flash_decode (B={B}, Smax={Smax}) "
                                     f"did not run variant {variant}")
            want = fd.decode_attention_ref(q, kc, vc, kvl, window=win)
            what = (f"q {qdt} cache {dtype} (B={B}, Smax={Smax}, kv_len={kvl}"
                    f"{' on the device' if on_device else ''}, H={H}, "
                    f"KV={KV}, hd={hd}) window={win} {variant}")
            line = lm_compare("flash_decode", got, want,
                              LM_TOL[("attention", qdt)], what)
            if qdt == torch.bfloat16:
                line.update(lm_within_a_bf16_step("flash_decode", got, want,
                                                  what))
            out.append(line)
    return out


def phase_lm_kernels():
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED)
    lines = {}
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, cases in (("rms_norm", lm_rms_cases),
                              ("flash_attention", lm_attention_cases),
                              ("flash_decode", lm_decode_cases)):
            lines.setdefault(kernel, []).extend(cases(gen, dtype))
    for kernel, cases in lines.items():
        worst = max(cases, key=lambda c: c["share_of_tol"])
        scaled = [c for c in cases if "scaled_limit" in c]
        say("lm_kernels", kernel=kernel, cases=len(cases),
            max_abs_err=LM_WORST[kernel], worst_case=worst,
            worst_scaled_case=max(
                scaled, key=lambda c: c["share_of_scaled_limit"])
            if scaled else None,
            every_case=[(c["case"], c["max_abs_err"], c["tol"],
                         c.get("scaled_limit")) for c in cases])
    say("lm_kernels_done", seconds=round(time.perf_counter() - t0, 3))


def tree_to(tree, dtype):
    return {k: tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def reset_all_counts() -> None:
    """Set the launch count of every kernel of the port to 0."""
    ops.reset_counts()
    ws.reset_counts()


def lm_counts_since_reset(variants: dict, **want) -> tuple:
    """Every kernel's launches since ``reset_all_counts()``: those of
    ``want`` must be as given, every other kernel's 0; and the launches of
    each wrapper's variants, which must be ``variants`` where it names the
    wrapper (every variant it leaves out at 0). Returns the counts of the
    three kernels and their variants."""
    counts = {**ops.launch_counts(), **ws.ws_sim_cuda.launches_by_body}
    expect = {k: want.get(k, 0) for k in counts}
    if counts != expect:
        raise AssertionError(f"launched {counts}, the config implies "
                             f"{expect}")
    by_variant = ops.variant_counts()
    for fn, got in by_variant.items():
        if fn in variants and got != {**dict.fromkeys(got, 0),
                                      **variants[fn]}:
            raise AssertionError(f"{fn} ran {got}, expected {variants[fn]}")
    return {k: counts[k] for k in LM_KERNELS}, by_variant


def eager_serve(model, params, reqs) -> tuple:
    """decode_batch's greedy loop without its graph: ``Model.prefill`` and
    ``Model.decode_step`` with Python-int positions, every launch from
    Python. Returns (tokens (B, new) int32, wall seconds)."""
    S, new = len(reqs[0].prompt), max(r.max_new for r in reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              dtype=torch.int64, device=DEV)
    cache, logits = model.prefill(params, {"tokens": prompts},
                                  max_seq=S + new)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    outs = []
    for i in range(new):
        outs.append(tok[:, 0])
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    out = torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
    return out, time.perf_counter() - t0


def phase_lm_main_path() -> dict:
    """(a) serving: decode_batch at serve.py's defaults; (b) production
    prefill: build_prefill_step on 4 x 2048 tokens; each counted on its own;
    then the full-width float32 parity of forward and sequential prefill."""
    cfg = get_lm_config(LM_ARCH)
    model = build_lm_model(cfg)                       # device=None: the card
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(LM_SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               SERVE_PROMPT).astype(np.int32),
                    max_new=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    decode_batch(model, params, reqs)                       # warm (cuBLAS)
    # ---- (a) the run that is counted: every count at 0 just before --------
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = decode_batch(model, params, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    graph = decode_batch.last_graph
    steps = SERVE_PROMPT + SERVE_NEW
    L = cfg.n_layers
    # read just after: per step and layer norm1, q_norm, k_norm, norm2 and
    # one decode attention; per step the final norm; the step's first run
    # is eager, the other steps - 1 replay its graph, each counted once
    # every width of the serving path (2048, 128) has a register kernel,
    # and a cache of 24 rows is one split
    serve_counts, serve_variants = lm_counts_since_reset(
        {"rms_norm": {"row_in_registers": steps * (4 * L + 1)},
         "flash_decode": {"single": steps * L}},
        rms_norm=steps * (4 * L + 1), flash_decode=steps * L)
    if graph is None or graph["replays"] != steps - 1:
        raise AssertionError(f"decode_batch replayed {graph} on the card, "
                             f"expected {steps - 1} replays")
    if tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or tokens.dtype != \
            np.int32 or tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
        raise AssertionError(f"decode_batch returned {tokens.shape} "
                             f"{tokens.dtype} in [{tokens.min()}, "
                             f"{tokens.max()}]")
    # the same requests through an eager loop driven here: Model.prefill
    # and decode_step with int positions, every launch from Python
    eager_tokens, eager_s = eager_serve(model, params, reqs)
    if not np.array_equal(tokens, eager_tokens):
        raise AssertionError(f"decode_batch's tokens differ from the eager "
                             f"loop's in {int((tokens != eager_tokens).sum())}"
                             f" places")
    replayed_s = serve_s - graph["warmup_seconds"] - graph["capture_seconds"]
    serve = dict(requests=SERVE_REQUESTS, prompt=SERVE_PROMPT,
                 new_tokens=SERVE_NEW, decode_steps=steps,
                 wall_seconds=serve_s,
                 tokens_per_second=SERVE_REQUESTS * SERVE_NEW / serve_s,
                 prompt_and_new_tokens_per_second=(
                     SERVE_REQUESTS * steps / serve_s),
                 warmup_seconds=graph["warmup_seconds"],
                 capture_seconds=graph["capture_seconds"],
                 replays=graph["replays"],
                 ms_per_replayed_step=replayed_s / graph["replays"] * 1e3,
                 eager_loop_wall_seconds=eager_s,
                 eager_loop_ms_per_step=eager_s / steps * 1e3,
                 tokens_equal_the_eager_loop=True,
                 launches=serve_counts, launches_by_variant=serve_variants,
                 launches_per_replay=graph["launches_per_replay"][0],
                 sample=tokens[0].tolist())
    say("lm_main_path", path="serve.decode_batch", arch=LM_ARCH,
        params=model.param_count(), param_dtype=cfg.param_dtype,
        init_seconds=init_s, card=card_line(), **serve)
    # ---- (b) production prefill -------------------------------------------
    step = build_prefill_step(model)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)),
        dtype=torch.int64, device=DEV)}
    step(params, batch)                                     # warm
    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    # bf16 prefill: every attention launch on the tensor cores
    prefill_counts, prefill_variants = lm_counts_since_reset(
        {"rms_norm": {"row_in_registers": 4 * L + 1},
         "flash_attention": {"tc_bf16": L}},
        rms_norm=4 * L + 1, flash_attention=L)
    if logits.shape != (PREFILL_B, 1, cfg.padded_vocab) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype} or not finite")
    prefill = dict(batch=PREFILL_B, seq=PREFILL_S, wall_seconds=prefill_s,
                   tokens_per_second=PREFILL_B * PREFILL_S / prefill_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=prefill_counts,
                   launches_by_variant=prefill_variants)
    say("lm_main_path", path="steps.build_prefill_step", arch=LM_ARCH,
        card=card_line(), **prefill)
    # ---- float32 parity at full width (tests/test_models_smoke.py) --------
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    model32 = build_lm_model(cfg32)
    params32 = tree_to(params, torch.float32)               # exact
    del params
    tk = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PARITY_B, PARITY_S)),
                         dtype=torch.int64, device=DEV)
    fwd = model32.forward(params32, {"tokens": tk})[:, -1]
    _cache, dec = model32.prefill(params32, {"tokens": tk}, max_seq=PARITY_S,
                                  dtype=torch.float32)
    diff = float((fwd - dec[:, 0]).abs().max())
    tol = 1e-3 * float(fwd.abs().max()) + 1e-3
    if not diff < tol or not bool(torch.isfinite(fwd).all()):
        raise AssertionError(f"full-width float32 forward and sequential "
                             f"prefill differ by {diff} (tolerance {tol})")
    say("lm_parity", arch=LM_ARCH, param_dtype="float32", batch=PARITY_B,
        seq=PARITY_S, max_abs_diff=diff, tol=tol,
        max_abs_logit=float(fwd.abs().max()))
    del params32
    return dict(serve=serve, prefill=prefill)


def eager_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` calls launched from Python: for a small
    kernel this is the rate at which the host launches calls, not the
    kernel's time."""
    fn()                                                    # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    the graph replayed between two CUDA events, so that no host work
    (Python, checks, ctypes) sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                           # warm
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds of one call (checks, allocation, ctypes, for the
    tensor-core attention its three tensor-map encodes, the launch), over
    ``reps`` calls issued without a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def lm_times(kernel, plain, library, reps: int, plain_reps: int) -> dict:
    """The kernel, its plain version and the library call, each as device
    time (``graph_ms``); the kernel also as launched from Python, and its
    host cost a call."""
    return dict(ms=graph_ms(kernel, reps),
                ms_launched_from_python=eager_ms(kernel, reps),
                host_us_per_call=host_us(kernel, min(reps, 20)),
                plain_ms=graph_ms(plain, plain_reps),
                library_ms=graph_ms(library, reps))


def lm_bound(bytes_moved: int, flops: int, dtype) -> tuple:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FLOPS_PER_S[dtype] * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(bytes_ms, ops_ms), by, dict(bytes=bytes_moved, flops=flops,
                                           bytes_ms=bytes_ms, ops_ms=ops_ms)


def lm_rates(row: dict, kernel: str, key: tuple, variant: str) -> dict:
    """What a timed row adds: the rate the kernel reached (TFLOP/s where
    operations bound it, GB/s where bytes do), its share of the bound, the
    variant that ran and its time at the same shape before the redesign."""
    d, ms = row["bound_detail"], row["ms"]
    rate = ({"tflop_per_s": d["flops"] / ms / 1e9}
            if row["bound_by"] == "operations"
            else {"gb_per_s": d["bytes"] / ms / 1e6})
    return dict(**rate, share_of_bound=row["bound_ms"] / ms, variant=variant,
                earlier_ms=EARLIER_MS.get((kernel, key)))


def lm_time_rms(gen, R: int, D: int, reps: int) -> dict:
    dt = torch.bfloat16
    x, s = lm_randn(gen, (R, D), dt, 3.0), lm_randn(gen, (D,), dt)
    # read x and scale, write out; square, add, two multiplies per element
    bound, by, detail = lm_bound((2 * R * D + D) * 2, 4 * R * D, dt)
    row = dict(shape=dict(rows=R, D=D, dtype="bfloat16"),
               **lm_times(lambda: ops.rms_norm(x, s, 1e-6),
                          lambda: rn.rms_norm_ref(x, s, 1e-6),
                          lambda: torch.nn.functional.rms_norm(
                              x, (D,), s, 1e-6), reps, reps),
               bound_ms=bound, bound_by=by, bound_detail=detail)
    tpr = rn.threads_per_row(R, D, dt)
    variant = (f"row_in_registers, {tpr} threads a row" if tpr
               else "generic")
    return {**row, **lm_rates(row, "rms_norm", (R, D), variant)}


def lm_time_attention(gen, B: int, S: int, reps: int) -> dict:
    dt, H, KV, hd = torch.bfloat16, 16, 8, 128
    q = lm_randn(gen, (B, S, H, hd), dt)
    k, v = lm_randn(gen, (B, S, KV, hd), dt), lm_randn(gen, (B, S, KV, hd), dt)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (S + 1) // 2                       # causal (q, k) pairs
    bound, by, detail = lm_bound(2 * (2 * q.numel() + 2 * k.numel()),
                                 B * H * pairs * 4 * hd, dt)
    row = dict(shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype="bfloat16",
                          causal=True),
               **lm_times(
                   lambda: ops.flash_attention(q, k, v),
                   lambda: fa.flash_attention_ref(q, k, v),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                   reps, 2),
               bound_ms=bound, bound_by=by, bound_detail=detail)
    return {**row, **lm_rates(row, "flash_attention", (B, S),
                              ATTN_VARIANT[dt])}


def lm_time_decode(gen, B: int, Smax: int, kv_len: int, reps: int) -> dict:
    """The kernel with kv_len on the device, as the serving path passes
    it."""
    dt, H, KV, hd = torch.bfloat16, 16, 8, 128
    q = lm_randn(gen, (B, 1, H, hd), dt)
    kc, vc = (lm_randn(gen, (B, Smax, KV, hd), dt) for _ in range(2))
    kv = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (c[:, :kv_len].transpose(1, 2).contiguous() for c in (kc, vc))
    # q in, the kv_len valid rows of both caches, out
    bound, by, detail = lm_bound(2 * (2 * q.numel() + 2 * B * kv_len * KV * hd),
                                 B * H * kv_len * 4 * hd, dt)
    splits, rows = fd.num_splits(B, H, KV, Smax, torch.cuda.
                                 get_device_properties(0).multi_processor_count)
    row = dict(shape=dict(B=B, Smax=Smax, kv_len=kv_len, H=H, KV=KV, hd=hd,
                          dtype="bfloat16", kv_len_on_device=True,
                          splits=splits, rows_per_split=rows),
               **lm_times(
                   lambda: ops.flash_decode(q, kc, vc, kv),
                   lambda: fd.decode_attention_ref(q, kc, vc, kv_len),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, enable_gqa=True), reps, reps),
               bound_ms=bound, bound_by=by, bound_detail=detail)
    return {**row, **lm_rates(row, "flash_decode", (B, Smax),
                              fd.VARIANTS[splits > 1])}


PROFILE_STEPS = 8      # decode steps in each profiled window
#: host calls that start device work (kernels, graphs, copies, fills)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|MemcpyAsync|"
                         r"MemsetAsync|LaunchKernelExC)")
#: the traced device kernel that each wrapper's launch runs once (a split
#: flash decode also runs its merge kernel, which is not counted here)
TRACED_KERNEL = {"rms_norm": re.compile(r"rmsnorm_(regs|generic)_kernel"),
                 "flash_attention": re.compile(
                     r"(fa_tc|flash_attention)_kernel"),
                 "flash_decode": re.compile(r"decode_split_kernel")}


def profile_window(run_steps) -> dict:
    """torch.profiler over one window of PROFILE_STEPS serving-path decode
    steps (``run_steps(first_pos, n)``): device time by kernel against the
    window's own wall time, the device operations and the host's launch
    calls a step. The profiler adds host time of its own, so the window's
    unprofiled twin (the next PROFILE_STEPS steps) is timed beside it.

    The launches that the wrappers counted in the window must be the
    kernels the trace saw run, wrapper by wrapper (``TRACED_KERNEL``): for
    a replayed graph the counts are the capture's times the replays, and
    the trace shows that every replay ran them."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = (ops.launch_counts(), ops.variant_counts())
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits = run_steps(3, PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = ops.counts_since(before)[0]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 decode step: non-finite logits")
    events = prof.key_averages()
    # device-side events only (kernels, copies): an operator's own row
    # would count its kernels' time a second time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    traced = {fn: sum(c for key, _ms, c in rows if pat.search(key))
              for fn, pat in TRACED_KERNEL.items()}
    if traced != counted:
        raise AssertionError(f"the trace ran {traced} kernel launches, the "
                             f"wrappers counted {counted}")
    device_ms = sum(r[1] for r in rows)
    host_calls = {e.key: e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and HOST_LAUNCH.match(e.key)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(3 + PROFILE_STEPS, PROFILE_STEPS)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    n = PROFILE_STEPS
    return dict(steps=n, wall_ms_per_step_profiled=wall_ms / n,
                wall_ms_per_step=plain_wall_ms / n,
                device_ms_per_step=device_ms / n if rows else "not measured",
                # one window: its traced device time over its own wall time
                device_idle_share=(1 - device_ms / wall_ms) if rows
                else "not measured",
                device_idle_share_unprofiled=(1 - device_ms / plain_wall_ms)
                if rows else "not measured",
                kernel_launches_per_step=sum(r[2] for r in rows) / n,
                traced_wrapper_launches_equal_the_counts=traced,
                host_launch_calls_per_step=sum(host_calls.values()) / n,
                host_launch_calls=host_calls,
                top=[dict(name=n_[:80], ms_per_step=ms / n, count=c)
                     for n_, ms, c in rows[:12]])


def lm_profile_decode_steps() -> dict:
    """Where a decode step's time goes (full width, bf16, the batch of
    phase lm_main_path): a window of eager steps, every launch from Python,
    and a window of replays of the step's CUDA graph, as decode_batch runs
    them."""
    cfg = get_lm_config(LM_ARCH)
    model = build_lm_model(cfg)
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    B, S = SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW
    tok = torch.zeros((B, 1), dtype=torch.int64, device=DEV)
    out = {}
    for name, make in (("eager", lambda: model.decode_step),
                       ("graph_replay", lambda: GraphedDecodeStep(model))):
        cache = model.init_cache(B, S)
        step = make()
        for pos in range(3):          # warm (the graph: captured at pos 0)
            step(params, cache, tok, pos)

        def run_steps(first, n, step=step, cache=cache):
            for pos in range(first, first + n):
                logits, _ = step(params, cache, tok, pos)
            return logits
        out[name] = profile_window(run_steps)
        del step, cache
    del params
    return out


def phase_lm_timing(main: dict) -> list:
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 1)
    serve_kv = SERVE_PROMPT + SERVE_NEW
    shapes = {
        "rms_norm": [lm_time_rms(gen, PREFILL_B * PREFILL_S, 2048, 50),
                     lm_time_rms(gen, PREFILL_B * PREFILL_S * 16, 128, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 2048, 200)],
        "flash_attention": [lm_time_attention(gen, PREFILL_B, PREFILL_S, 10)],
        "flash_decode": [lm_time_decode(gen, SERVE_REQUESTS, serve_kv,
                                        serve_kv, 200),
                         lm_time_decode(gen, SERVE_REQUESTS, 2048, 2048, 50),
                         lm_time_decode(gen, 1, 32768, 32768, 50)],
    }
    for kernel, rows in shapes.items():
        for r in rows:
            say("lm_timing", kernel=kernel, card=card_line(), **r)
    # the fixed cost of one launch inside a replayed graph: a kernel that
    # writes one element
    one = torch.zeros(1, device=DEV)
    say("lm_timing", kernel="one-element fill (Tensor.fill_)",
        ms=graph_ms(lambda: one.fill_(1.0), 200), card=card_line())
    for window, profile in lm_profile_decode_steps().items():
        say("lm_profile", what=f"decode steps, serving path, {window}",
            card=card_line(), **profile)
    launches = {k: main["serve"]["launches"][k] + main["prefill"]["launches"][k]
                for k in LM_KERNELS}
    entries = []
    for kernel, rows in shapes.items():
        head = rows[0]          # the main path's shape (prefill; decode: a)
        entries.append({
            "name": kernel, "route": "cuda", "source": LM_SOURCES[kernel],
            "replaces": LM_REPLACES[kernel], "launches": launches[kernel],
            "launches_by_path": {
                "serve.decode_batch": main["serve"]["launches"][kernel],
                "steps.build_prefill_step":
                    main["prefill"]["launches"][kernel]},
            "launches_by_variant": {
                path: main[key]["launches_by_variant"].get(kernel)
                for key, path in (("serve", "serve.decode_batch"),
                                  ("prefill", "steps.build_prefill_step"))},
            "max_abs_err": LM_WORST[kernel], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            # numbers of this run only; the earlier times stay in lm_timing
            "other_shapes": [{k: v for k, v in r.items() if k != "earlier_ms"}
                             for r in rows[1:]]})
    return entries


def hgmma_counts() -> dict:
    """The count of HGMMA (wgmma) instructions in each built library's SASS,
    by ``cuobjdump -sass``; the tensor-core attention must have some."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    counts = {}
    for name in _build.sources():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[name] = sass.count("HGMMA")
    if not counts.get("flash_attention_tc"):
        raise AssertionError(f"no HGMMA in the tensor-core attention: "
                             f"{counts}")
    return counts


def register_variant_resources() -> dict:
    """Registers, stack and local memory of each instantiation of the
    ws_sim kernel, read by ``cuobjdump -res-usage`` from the
    library this run loaded (built now or found built). A spill goes to the
    stack frame in local memory, so any stack or local memory there fails
    the run, as does a missing instantiation."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-res-usage",
                           str(_build._target("ws_sim"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = {}
    for m in re.finditer(r"Function (\S+?):?\s(.*?)(?=Function |\Z)", text,
                         re.S):
        if "ws_sim_reg_kernel" not in m.group(1):
            continue
        res = {k.lower(): int(v) for k, v in
               re.findall(r"\b(REG|STACK|LOCAL):(\d+)", m.group(2))}
        if set(res) != {"reg", "stack", "local"}:
            raise AssertionError(f"cuobjdump -res-usage: no REG, STACK and "
                                 f"LOCAL for {m.group(1)}: {m.group(2)!r}")
        out[m.group(1)] = res
    bad = {k: v for k, v in out.items() if v["stack"] or v["local"]}
    if bad:
        raise AssertionError(f"register variant spills: {bad}")
    if len(out) != 3 * len(ws.REG_SLOTS):
        raise AssertionError(f"expected {3 * len(ws.REG_SLOTS)} register "
                             f"variant instantiations, cuobjdump listed "
                             f"{len(out)}:\n{text}")
    return out


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
        ptxas={name: [l.strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l]
               for name, log in _build.build_logs.items()},
        hgmma=hgmma_counts(),
        ws_sim_register_variant=register_variant_resources())
    # 2, 3. each body against its plain version and the oracle
    phase_kernels_and_oracle()
    # 4. the main paths, each counted on its own
    with tempfile.TemporaryDirectory(prefix="ws_store_") as tmp:
        main_out = {path: drive_path(Path(tmp) / path, path)
                    for path in MAIN_PATHS}
        # 4b. the query path and the planner, under the sanitizer
        query = phase_query_main_path(Path(tmp) / "query", Path(tmp))
    # 4c. the paper's experiments, the log engine, the segmented loop and
    # serve's command line
    paper = phase_paper()
    # 4d. the simulation daemon: client processes, sweep chunks, library
    # mode, a daemon killed mid-round, the daemon bench
    with tempfile.TemporaryDirectory(prefix="ws_daemon_") as tmp:
        daemon = phase_daemon(Path(tmp))
    # 5. times at a main-path shape
    entries = [time_body(path, main_out[path],
                         reps=5 if path == "divisible" else 3)
               for path in MAIN_PATHS]
    for e in entries:
        e["launches_query_path"] = query["launches"][e["name"]]
        e["launches_paper_path"] = paper[e["name"]]
        e["launches_daemon_path"] = daemon[e["name"]]
    # 6-8. the language-model serving path: its kernels against their plain
    # versions, its two main paths counted, the kernels' times
    phase_lm_kernels()
    lm_main = phase_lm_main_path()
    entries += phase_lm_timing(lm_main)
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
