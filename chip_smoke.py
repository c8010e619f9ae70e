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
of forward and sequential prefill. Then ``mixtral-8x7b`` at full width with
its depth cut to 4 of 32 layers: serving and prefill through the MoE layer
with its work-stealing overflow rebalance, the float32 parity, and one MoE
layer on the card against the CPU's plain path. Then the recurrent mixers
and head dim 96: ``xlstm-350m`` (mLSTM and sLSTM), ``jamba-v0.1-52b`` (Mamba
beside attention and MoE, one period of 8 of its 32 layers) and
``phi3-mini-3.8b`` (32 heads of 96), each served and prefilled at full
width. Then the encoder-decoder and the vision prefix: ``whisper-large-v3``
whole (its encoder over 1500 frames, a cross-attention in each decoder
layer, learned positions) and ``internvl2-76b`` (a prefix of 256 patch
embeddings, 8 of its 80 layers), each served and prefilled at full width.
Then training: ``qwen3-1.7b`` trained at full width through the port's
training entry points, its checkpoint, the float32 parity of a train step,
and ``examples/train_lm_torch.py``'s command line. Then the mesh: the
mesh-sharded sweep, context-parallel decode and the sharded prefill and
train steps of qwen3-1.7b, of mixtral-8x7b (its experts split over the
mesh) and of jamba-v0.1-52b and xlstm-350m (the recurrent mixers) on a
world of one NCCL rank and on four gloo ranks sharing the card.

Phases, one JSON line each (and after each a ``phase_seconds`` line with
its wall seconds): ``build`` (seconds, ptxas's registers and spills,
the count of ``HGMMA`` instructions in each library's SASS, and the
resources of every instantiation of the simulator kernel, where a spill
fails the run), ``kernels`` (bit-exact against the plain loop, run on the
host from the same inputs — a main path's chunk on the card —, the
simulator at every slot-count boundary; its six case groups run at once,
each in a worker process of its own on the card: ``python3 chip_smoke.py
--kernel-group NAME``), ``oracle`` (bit-exact
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
``lint`` (the dispatch lint on the card with no finding — the reduced
decode step reads nothing on the host and copies nothing back, one event-loop
step reads once — then ``python -m repro_torch.check`` over its three passes,
exit 0; and ``ws_sim_cuda(grid_chunk=128)`` on 300 rows of each body: 3
launches, every leaf equal to the unchunked launch's), ``benches`` (one line
per bench of ``benchmarks/run_torch.py`` at ``run.py``'s reps, each counted
on its own — launches by body, kernel ms, wall, the bench's own numbers:
``sim_throughput`` at 32 rows and again at 8192, ``model_throughput``, a few
rows of each held to the numpy oracle; ``sched_planner``;
``service_throughput`` with 0 warm dispatches; ``paired_comparison``;
``obs_overhead``; ``sanitizer_overhead`` with 0 violations and a replayed
dispatch; ``fault_recovery`` with 0 client errors at every rate),
``timing`` (one line per body: the kernel
per chunk with ns per event on its longest row and its time before the
redesign, the path's summed kernel time, its plain version and its bound),
``lm_kernels`` (one line
per language-model kernel: every case's max error beside its tolerance;
then ``lm_grad``, one line a kernel: the gradient through its wrapper
against the plain version's),
``lm_main_path`` (one line per path: tokens per second, launch counts;
for ``decode_batch`` also the graph's warm-up and capture seconds and ms
per replayed step, beside the eager loop's wall), ``lm_parity``,
``lm_moe`` (mixtral-8x7b at full width, 4 layers: ``decode_batch`` with the
same checks and the step's byte bound, the prefill at 4 x 2048, the
profile of a decode step, the float32 parity at 2 layers, one MoE layer at
T = 64 against the CPU: routing equal, ``stolen`` > 0, near-ties
reported), ``lm_recurrent`` (xlstm-350m, jamba-v0.1-52b at one period and
phi3-mini-3.8b: ``decode_batch`` with its tokens equal to the eager loop's
and exact launch counts, ms a replayed step against the step's byte bound
— every weight once and the recurrent state read and written once — the
prefill at 4 x 2048 with its peak memory, one sLSTM layer's prefill time,
the profile of a decode step of xlstm and jamba, the float32 parity of
forward and sequential prefill for xlstm whole and jamba's first five
slots),
``lm_encdec`` (whisper-large-v3 whole and internvl2-76b at 8 of 80
layers, random frames or patch embeddings from the seed: the prefill and
greedy steps, each step after the first of its kind a replay of a CUDA
graph — InternVL's 256 prefix steps on a second graph, on embeddings —
with its tokens equal to the eager loop's and exact launch counts, encoder
included, ms a replayed step against its byte bound — the decoder's
weights without the cross wk/wv, the whole cross caches, the K and V rows
— the prefill at 4 x 2048 behind the same inputs, the profile of a
replayed step, the float32 parity of forward and sequential prefill for
Whisper whole and InternVL's first two layers),
``lm_train`` (qwen3-1.7b at full width, bf16, 2 x 2048 tokens a step:
10 steps through ``train.build_state_and_step`` and ``fault.run_training``
with ms a steady step, tokens/s, peak GiB, exact launches a step — 113
``rms_norm``, 28 ``flash_attention``, none in the backward —, a falling
loss and the step's operation bound; run_training's final checkpoint of
≈ 24 GB, saved and restored onto the card bit for bit, with its seconds; a
steady step under torch.profiler, grouped by kind of kernel, and its parts
timed alone; the float32 parity of a train step against the CPU at 2
layers, ``microbatches=2`` against 1; ``examples/train_lm_torch.py``'s
command line — 200 steps, one restart — and a reduced ``--compress`` run),
``lm_timing`` (one line per kernel and shape: the kernel, its
plain version and one PyTorch call as a yardstick, each as device time from
a replayed CUDA graph, its bound, the rate it reached and its share of the
bound, the variant that ran and its time before its redesign; and the cost
of a one-element fill in a replayed graph, the fixed cost of a launch there), ``lm_profile`` (where a decode
step's time goes, over a window of eight steps: eager, then replayed from
the step's graph; device idle share and the host's launch calls a step)
and, last, ``mesh`` (each rank a process of its own, ``python3 chip_smoke.py
--mesh-rank RANK WORLD INIT DIR``: a world of one NCCL rank — the service's
sharded p=256 sweep with main_path's keys and npz bytes, each path's first
sweep less 3 rows through ``run_rows(mesh=)`` equal to ``run_rows()``,
qwen3-1.7b's context-parallel decode replayed from a CUDA graph with the
merge's all-reduces in it, beside the step without it (whose tokens are
lm_main_path's) and beside the step without a mesh whose attention is
the partials' float64 arithmetic on one shard, which must give the
context-parallel logits and tokens bit for bit; then four gloo ranks on a
2 x 2 mesh — the same sweeps equal to world 1's, one launch a sweep a
rank, the decode with the batch over "data" and the sequence over
"model", its teacher-forced logits and its greedy tokens equal to world
1's bit for bit, one layer's attention at (1, 32768, 16 / 8, 128) split
four ways equal to one shard's and against flash_decode; in each world the
sharded prefill of qwen3-1.7b, then step ``train``: world 1 trains it
whole for three steps through ``run_training(state_shardings=)``, each
step bit-equal to the step without a mesh and its collectives PERF.md's
formula, its checkpoint saved; world 4 trains it at 2 of 28 layers in bf16
and float32, within 1e-4 · max|leaf| of the step without a mesh, and its
checkpoint resumes on a world of one; last, step ``moe``: mixtral-8x7b at
full width through ``plan_cell``'s plans, its experts split on "data" and
their d_ff on "model" — world 1 prefills 4 x 2048 at 4 layers (bf16) and 2
(float32) and trains 3 steps at 1 layer, each bit-equal to the step
without a mesh; world 4, with 4 dispatch groups and the G <-> E
all-to-all, prefills at 2 layers and trains 2 steps a dtype at 1 layer,
within tolerance of the steps without a mesh with the same groups, and
one MoE layer's dropped and stolen fractions equal to theirs; then step
``recurrent``: jamba-v0.1-52b and xlstm-350m at full width through
``plan_cell``'s plans (SP off) — world 1 prefills jamba's period in bf16
and its first two slots in float32, trains its first slot and prefills and
trains xlstm at 2 layers, each bit-equal to the step without a mesh;
world 4 prefills jamba's first two slots (bf16) and first slot (float32)
and trains its first slot, and prefills and trains xlstm, in both dtypes,
float32 within tolerance of the steps without a mesh; every sharded step's collectives PERF.md's formula, its launches
exact).
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
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import zipfile
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
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
                                     build_prefill_step, build_train_step,
                                     loss_and_grads)
from repro_torch.models import build_model as build_lm_model  # noqa: E402
from repro_torch.models.layers import logits_f32, softmax_xent  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault import (TrainLoopConfig,  # noqa: E402
                                       run_training)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.check import dispatch_lint as dl  # noqa: E402
from repro_torch.check import run_pass as run_check_pass  # noqa: E402
from repro_torch.check import sanitizer as san  # noqa: E402
from repro_torch.sched import plan_for_mesh  # noqa: E402
from repro_torch.service import (DaemonClient, SimulationDaemon,  # noqa: E402
                                 SimulationService)
from repro_torch.service import resilience as rz  # noqa: E402
from repro_torch.service import store as store_mod  # noqa: E402
from repro_torch.service.estimator import fixed_reps_for_width  # noqa: E402
from benchmarks import daemon_torch as dt  # noqa: E402
from benchmarks import run_torch as rt  # noqa: E402
from benchmarks import paper_torch as pt  # noqa: E402
from examples import paper_sweep_torch as ps  # noqa: E402
from examples import quickstart_torch as qs  # noqa: E402
from examples import serve_lm_torch  # noqa: E402
from examples import train_lm_torch  # noqa: E402

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


def hold_against_plain(model, scn, what: str, plain_on: str = "cpu"
                       ) -> tuple:
    """Launch the kernel on the CUDA tensors ``scn`` and run the plain loop
    on the same values on ``plain_on``: the host for phase ``kernels``'
    cases (the plain loop is integer arithmetic, the same on either device,
    and on the host its many small steps do not queue behind the other
    workers' on the card), the card for a main path's chunk. Every leaf
    must be ``torch.equal``. Returns (kernel result, max |diff|)."""
    model = sw.as_model(model)
    got = ws.ws_sim_cuda(model, scn)
    torch.cuda.synchronize()
    want = ws_sim_ref(model, type(scn)(*(t.to(plain_on) for t in scn)))
    torch.cuda.synchronize()
    want = type(want)(*(t.to(DEV) for t in want))
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


#: processes answering the serial numpy twins when many rows are held at
#: once (:func:`twin_answers`)
TWIN_WORKERS = 6


def twin_answers(jobs: list) -> list:
    """``twin(*job)`` for each job, in order. Twelve jobs or more go to
    TWIN_WORKERS forked processes: a twin is serial numpy on the host and
    touches no card, and the rows it answers are independent. What this
    runs beside is a check, never a measurement."""
    if len(jobs) < 2 * TWIN_WORKERS:
        return [twin(*job) for job in jobs]
    with ProcessPoolExecutor(TWIN_WORKERS, mp_context=multiprocessing
                             .get_context("fork")) as pool:
        return list(pool.map(twin, *zip(*jobs)))


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
    return hold_many_against_oracle([(model, scn, res, rows, what,
                                      remote_prob)])


def hold_many_against_oracle(items) -> int:
    """:func:`hold_against_oracle` of each (model, scenario, result, rows,
    what, remote_prob) of ``items``, the twins answered together
    (:func:`twin_answers`). Returns the number of rows compared."""
    jobs, checks = [], []
    for model, scn, res, rows, what, remote_prob in items:
        model = sw.as_model(model)
        host = {f: getattr(res, f).cpu().numpy() for f in res._fields}
        s = {f: getattr(scn, f).cpu().numpy() for f in scn._fields}
        for k in rows:
            jobs.append((model, {f: s[f][k] for f in s}, remote_prob,
                         min(int(model.max_events), int(s["max_events"][k]))))
            checks.append((model, host, k, what))
    for (model, host, k, what), want in zip(checks, twin_answers(jobs)):
        if not twin_may_answer(model, want):
            raise AssertionError(f"{what} row {k}: a cap could bind; the "
                                 "twin cannot answer it")
        for f, v in want.items():
            if not np.array_equal(np.asarray(v), host[f][k]):
                raise AssertionError(f"kernel != oracle on {what} row {k}: "
                                     f"{f} {host[f][k]} vs {v}")
    return len(jobs)


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
    # the main path's later sweeps (two clusters, LOCAL_FIRST): the plain
    # chunk held here, beside the other groups; phase ``timing`` times the
    # first sweep's plain version alone
    for sw_ in MAIN_PATHS["divisible"]["sweeps"][1:]:
        scn = plain_chunk_scenario(sw_)
        hold_against_plain(sweep_model(sw_), scn,
                           f"the main-path chunk of {sw_['name']}",
                           plain_on=DEV)
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


def boundary_cases(stats, body: str):
    """``body`` at every p of BOUNDARY_P (:func:`boundary_case`) on the
    variant ``ws.variant`` routes it to, held against the plain loop; each
    launch must count under its variant."""
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


#: the case groups of phase ``kernels``; each runs in a worker process of
#: its own on the card (``python3 chip_smoke.py --kernel-group NAME``), all
#: at once: the kernel launches on the card, the plain loop it is held
#: against runs on the host, one event step at a time, one core a worker
#: (on the card such loops queue behind each other's small kernels, and
#: more workers made the phase slower, not faster)
KERNEL_GROUPS = {
    "ws_sim_divisible": divisible_cases,
    "ws_sim_dag": dag_cases,
    "ws_sim_adaptive": adaptive_cases,
    **{f"slot_boundaries {b}": (lambda stats, b=b: boundary_cases(stats, b))
       for b in BODIES},
}


def run_kernel_group(name: str) -> None:
    """A worker's whole run: one group of KERNEL_GROUPS on the card; its
    last line of output is the group's stats, worst errors and seconds."""
    t0 = time.perf_counter()
    stats = CaseStats()
    KERNEL_GROUPS[name](stats)
    print(json.dumps({"group": name, "stats": dataclasses.asdict(stats),
                      "worst": WORST,
                      "seconds": round(time.perf_counter() - t0, 3)}),
          flush=True)


def phase_kernels_and_oracle():
    """Every group of KERNEL_GROUPS in a worker process on the card, all
    started together (each process reaps its own; a failed or killed
    worker fails the phase with its output's tail); their stats and worst
    errors summed into this process's."""
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    stats, seconds = CaseStats(), {}
    with tempfile.TemporaryDirectory(prefix="ws_kernel_groups_") as tmp:
        logs = {name: Path(tmp) / f"{i}.log"
                for i, name in enumerate(KERNEL_GROUPS)}
        procs = {}
        try:
            for name, log in logs.items():
                with open(log, "w") as f:
                    procs[name] = subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--kernel-group", name], stdout=f,
                        stderr=subprocess.STDOUT, text=True, env=env)
            for p in procs.values():
                p.wait(timeout=900)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = {name: log.read_text() for name, log in logs.items()}
    for name, out in outs.items():
        if procs[name].returncode != 0:
            raise AssertionError(f"kernel group {name!r} exited "
                                 f"{procs[name].returncode}:\n{out[-4000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        for field in ("cases", "rows", "variants"):
            for k, v in line["stats"][field].items():
                getattr(stats, field)[k] += v
        stats.oracle += line["stats"]["oracle"]
        stats.halted_rows += line["stats"]["halted_rows"]
        for body, err_ in line["worst"].items():
            WORST[body] = max(WORST[body], err_)
        seconds[name] = line["seconds"]
    say("kernels", kernels=list(BODIES), models=stats.cases, rows=stats.rows,
        dag_rows_halted_at_deque_cap=stats.halted_rows, bit_exact=True,
        boundary_p=BOUNDARY_P, boundary_cases_by_variant=stats.variants,
        max_abs_err=WORST, worker_processes=len(procs),
        seconds_by_worker=seconds,
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
#: the numpy twin and the chunk held against the plain version (timed alone
#: for a path's first sweep, phase ``timing``; a later sweep's in phase
#: ``kernels``)
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


def plain_chunk_scenario(s) -> "sw.Scenario":
    """Sweep ``s``'s chunk ``plain_chunk`` as a scenario on the card."""
    topo, kw = s["topo"](), s["kw"]
    rows = sw.grid_rows(kw.get("W_list", (0,)), kw["lam_list"], kw["reps"])
    lo = s["plain_chunk"] * kw["chunk_size"]
    return sw.scenario_from_rows(rows.slice(lo, lo + kw["chunk_size"]),
                                 remote_prob=topo.remote_prob, device=DEV)


def grid_against_twin(g: sw.GridResult, model, rows, name: str):
    """Sampled rows of a sweep against the serial numpy twin, every field
    the twin returns (a grid column or an ``extras`` column); the twins
    answered together (:func:`twin_answers`)."""
    wants = twin_answers([(model, dict(
        W=g.W[k], seed=g.seed[k], lam_local=g.extras["lam_local"][k],
        lam_remote=g.lam[k], theta_static=g.theta_static[k],
        theta_comm=g.theta_comm[k]), model.topology.remote_prob,
        int(model.max_events)) for k in rows])
    for k, want in zip(rows, wants):
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
    n_sweep, twin_rows = 0, []
    for k in range(len(g)):
        j = index.get(ident(g, k))
        if j is None:
            twin_rows.append(k)
            continue
        for f, a, b in [(c, getattr(g, c), getattr(sweep, c)) for c in cols] \
                + [(x, g.extras[x], sweep.extras[x]) for x in g.extras]:
            if a.dtype != b.dtype or not np.array_equal(a[k], b[j]):
                raise AssertionError(f"{name} row {k}: {f}={a[k]} != the "
                                     f"sweep's row {j} {b[j]}")
        n_sweep += 1
    grid_against_twin(g, model, twin_rows, name)
    return dict(rows=len(g), rows_equal_to_the_sweep=n_sweep,
                rows_equal_to_the_twin=len(twin_rows))


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
    then — on the first sweep's ``plain_chunk`` (the chunk with the fewest
    steps, so that the plain version, which takes one step of every row per
    event, ends in time) — its plain version, alone on the card, and the
    kernel held to it bit for bit. That chunk is the shape the ``kernels``
    line reports, with its bound. (A later sweep's plain chunk is held in
    phase ``kernels``.)"""
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
            if s is spec["sweeps"][0] and ci == s["plain_chunk"]:
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
        rows = {}
        for c, k in picks:
            rows.setdefault(c, []).append(k)
        items = []
        for c, ks in rows.items():
            cfg, scn, res = self.cells[c]
            model = sw.as_model(cfg)
            for k in ks:
                if int(res.total_idle[k]) < 0 or int(res.makespan[k]) < 0:
                    raise AssertionError(f"{what} cell {c} row {k}: int32 "
                                         f"wrap")
            items.append((model, scn, res, ks, f"{what} cell {c}",
                          model.topology.remote_prob))
        hold_many_against_oracle(items)
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

    # 6. serve's command line at full width: plan, schedule, decode; then
    # the MoE example's command line (examples/serve_lm_torch.py) at reduced
    add(serve_main_step(["--no-reduced"], get_lm_config(LM_ARCH)))
    add(serve_main_step(serve_lm_torch.ARGV,
                        get_lm_config(MOE_ARCH).reduced()))
    for body in BODIES:
        if not total[body]:
            raise AssertionError(f"phase paper launched no {body}")
    seconds = time.perf_counter() - t_phase
    say("paper", step="done", launches=total, seconds=seconds)
    return total


def serve_main_step(argv: list, cfg) -> dict:
    """``serve.main(argv)`` counted on its own: the planner's launches equal
    its dispatches, and the decode's every step runs norm1 (+ q_norm and
    k_norm with qk-norm) and norm2 a layer and the final norm, and one flash
    decode a layer; the RMSNorm variant follows the width. Returns the
    planner's launches by body."""
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run, text = quiet(lambda: serve.main(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    planner_launches = dict(ws.ws_sim_cuda.launches_by_body)
    L = cfg.n_layers
    steps = SERVE_PROMPT + SERVE_NEW
    norms = steps * ((4 if cfg.qk_norm else 2) * L + 1)
    rms_variant = ("row_in_registers" if cfg.d_model in rn.REG_WIDTHS
                   else "generic")
    lm_counts, lm_variants = lm_counts_since_reset(
        {"rms_norm": {rms_variant: norms},
         "flash_decode": {"single": steps * L}},
        rms_norm=norms, flash_decode=steps * L, **planner_launches)
    st = run.stats
    if st.completed != SERVE_REQUESTS or \
            run.tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or \
            sum(planner_launches.values()) != run.decision.n_dispatches:
        raise AssertionError(f"serve.main: {st}, tokens "
                             f"{run.tokens.shape}, planner launches "
                             f"{planner_launches} for "
                             f"{run.decision.n_dispatches} dispatches")
    d = run.decision
    say("paper", step="serve_main", argv=argv, arch=cfg.name,
        d_model=cfg.d_model, n_layers=L,
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
    return planner_launches


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
# Phase lint: the port's checker suite on the card — the dispatch lint (the
# twin of the JAX package's jaxpr lint), the command line over every pass —
# and ws_sim_cuda(grid_chunk=) against the unchunked launch.
# ---------------------------------------------------------------------------

#: the JAX package's Pallas chunk, on a batch it does not divide
GRID_CHUNK, GRID_G = 128, 300


def grid_chunk_models() -> dict:
    """One model a body for the grid_chunk step: (model, W, λ)."""
    return {
        "ws_sim_divisible": (sw.make_model(
            "divisible", topology=T.one_cluster(64, 10),
            max_events=dv.default_max_events(100_000, 64, 10)), 100_000, 10),
        "ws_sim_dag": (sw.make_model(
            "dag", topology=T.one_cluster(32, 5),
            dag=gen.merge_sort(2000, 32), max_events=1 << 18), 0, 5),
        "ws_sim_adaptive": (sw.make_model(
            "adaptive", topology=T.one_cluster(32, 10), pool_cap=1 << 12,
            max_events=dv.default_max_events(100_000, 32, 10)), 100_000, 10),
    }


def _syncs(ops) -> int:
    return sum(op.name == dl.SYNC_OP for op in ops)


def _to_host(ops) -> int:
    return sum(op.to_host for op in ops)


def phase_lint(tmp: Path) -> None:
    """The checker suite and ``grid_chunk`` on the card (module docstring,
    phase ``lint``)."""
    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    # 1. the dispatch lint on the card: no finding; a step of the event loop
    # syncs once (its loop condition), the decode step never
    t0 = time.perf_counter()
    findings = run_check_pass("dispatch")
    if findings:
        raise AssertionError(f"dispatch lint on the card: {findings}")
    decs = {arch: dl.decode_step_ops(dev, arch) for arch in dl.DECODE_ARCHS}
    steps = {name: dl.step_ops(model, dl.SIGNATURE_WIDTHS[0], dev)[1]
             for name, model in dl.tiny_models()}
    for arch, dec in decs.items():
        if not dec or _syncs(dec) or _to_host(dec):
            raise AssertionError(f"{arch} decode_step on the card: "
                                 f"{_syncs(dec)} syncs, {_to_host(dec)} "
                                 f"device->host copies of {len(dec)} ops")
    for name, ops in steps.items():
        if _syncs(ops) != dl.STEP_SYNCS or _to_host(ops):
            raise AssertionError(f"one {name} step on the card: "
                                 f"{_syncs(ops)} syncs, {_to_host(ops)} "
                                 "device->host copies")
    say("lint", step="dispatch", findings=0,
        decode_step_ops={a: len(d) for a, d in decs.items()},
        decode_step_syncs={a: _syncs(d) for a, d in decs.items()},
        decode_step_device_to_host={a: 0 for a in decs},
        advance_ops={n: len(o) for n, o in steps.items()},
        advance_syncs={n: _syncs(o) for n, o in steps.items()},
        advance_device_to_host={n: _to_host(o) for n, o in steps.items()},
        seconds=time.perf_counter() - t0)
    # 2. python -m repro_torch.check: every pass, on the card
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    report = tmp / "findings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--json", str(report)],
        env=dict(os.environ, PYTHONPATH=str(root / "src")), cwd=root,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python -m repro_torch.check exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    doc = json.loads(report.read_text())
    if tuple(doc["passes"]) != ("dispatch", "protocol", "sanitizer") \
            or doc["findings"]:
        raise AssertionError(f"python -m repro_torch.check: {doc}")
    say("lint", step="cli", exit_code=0, passes=doc["passes"], findings=0,
        lines=[l for l in proc.stdout.splitlines() if l.startswith("check")],
        seconds=time.perf_counter() - t0)
    # 3. ws_sim_cuda(grid_chunk=128) on 300 rows: ceil(300 / 128) launches,
    # every leaf equal to the unchunked launch's
    want = -(-GRID_G // GRID_CHUNK)
    for body, (model, W, lam) in grid_chunk_models().items():
        scn = sw.eng.batch_scenarios(
            W, np.arange(GRID_G, dtype=np.uint32) + 1, lam=lam, device=DEV)
        whole = ws.ws_sim_cuda(model, scn)
        torch.cuda.synchronize()
        got, launches, kernel_ms, wall = counted(
            lambda: ws.ws_sim_cuda(model, scn, grid_chunk=GRID_CHUNK))
        if launches != {**dict.fromkeys(BODIES, 0), body: want}:
            raise AssertionError(f"grid_chunk {body}: launched {launches}, "
                                 f"expected {want} of {body}")
        bad = [f for f in whole._fields
               if not torch.equal(getattr(whole, f), getattr(got, f))]
        if bad:
            raise AssertionError(f"grid_chunk {body}: leaves {bad} differ "
                                 "from the unchunked launch")
        say("lint", step="grid_chunk", body=body, p=model.p, G=GRID_G,
            grid_chunk=GRID_CHUNK, launches=launches, bit_identical=True,
            max_abs_err=max_abs_diff(whole, got), kernel_ms=kernel_ms,
            wall_seconds=wall, hazards=ws.grid_shape_hazards(GRID_CHUNK))
    say("lint", step="done", seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase benches: the simulator benches of benchmarks/run.py on the card
# (benchmarks/run_torch.py), each counted on its own.
# ---------------------------------------------------------------------------

#: run.py's default reps (the throughput benches take at least 32)
BENCH_REPS = 16
#: a batch that fills the card: one warp a row, 62 rows a multiprocessor of
#: the H100's 132
FILL_ROWS = 8192


def oracle_picks(cells: Cells, per_cell: int) -> list:
    """(cell, row) pairs to hold against the serial twin: the first, middle
    and last rows of each cell, ``per_cell`` of them, skipping adaptive rows
    whose task pool filled (the twin models no ``pool_cap``)."""
    picks = []
    for c, (cfg, scn, res) in enumerate(cells.cells):
        model = sw.as_model(cfg)
        G = int(scn.W.shape[0])
        rows = [k for k in dict.fromkeys((0, G // 2, G - 1))
                if not isinstance(model, ad.AdaptiveModel)
                or int(res.n_created[k]) < model.cfg.pool_cap]
        if not rows:
            raise AssertionError(f"cell {c}: every picked row filled its "
                                 "task pool")
        picks += [(c, k) for k in rows[:per_cell]]
    return picks


def bench_steps(out: Path) -> tuple:
    """(name, fn(cells), rows a cell held to the oracle) a bench."""
    tput = max(BENCH_REPS, 32)
    return (
        ("sim_throughput", lambda c: rt.sim_throughput(
            tput, on_cell=c, out=out), 3),
        ("sim_throughput_fill", lambda c: rt.sim_throughput(
            FILL_ROWS, on_cell=c), 3),
        ("model_throughput", lambda c: rt.model_throughput(
            tput, on_cell=c, out=out), 2),
        ("sched_planner", lambda c: rt.sched_planner(BENCH_REPS, out=out), 0),
        ("service_throughput", lambda c: rt.service_throughput(
            BENCH_REPS, out=out), 0),
        ("paired_comparison", lambda c: rt.paired_comparison(
            BENCH_REPS, out=out), 0),
        ("obs_overhead", lambda c: rt.obs_overhead(BENCH_REPS, out=out), 0),
        ("sanitizer_overhead", lambda c: rt.sanitizer_overhead(
            BENCH_REPS, out=out), 0),
        ("fault_recovery", lambda c: rt.fault_recovery(BENCH_REPS, out=out),
         0),
    )


def check_bench(name: str, value, launches: dict) -> None:
    """What each bench must show on the card."""
    n = sum(launches.values())
    if name.startswith("sim_throughput"):
        ok = launches[BODIES[0]] == n == 2          # warm-up + timed
    elif name == "model_throughput":
        ok = launches == dict.fromkeys(BODIES, 2)
    elif name == "sched_planner":
        ok = n == launches[BODIES[0]] == value[0]["n_dispatches"] >= 1
    elif name == "service_throughput":
        ok = value[0]["dispatches_warm"] == 0 and n >= 1
    elif name == "sanitizer_overhead":
        ok = value["violations_total"] == 0 \
            and value["n_replayed_dispatches"] >= 1
    elif name == "fault_recovery":
        ok = all(r["client_errors"] == 0 for r in value["rates"].values()) \
            and n >= 1
    else:
        ok = n >= 1
    if not ok:
        raise AssertionError(f"bench {name}: {value}, launches {launches}")


def phase_benches(out: Path) -> dict:
    """``benchmarks/run_torch.py``'s benches on the card (module docstring,
    phase ``benches``). Returns the ``ws_sim`` launches of the phase by
    body."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(BODIES, 0)
    for name, fn, per_cell in bench_steps(out):
        cells = Cells()
        (value, text), launches, kernel_ms, wall = counted(
            lambda: quiet(lambda: fn(cells)))
        check_bench(name, value, launches)
        for b, k in launches.items():
            total[b] += k
        held, host_s = 0, 0.0
        if per_cell:
            picks = oracle_picks(cells, per_cell)
            host_s = cells.hold(picks, name)
            held = len(picks)
        say("benches", step=name, launches=launches, kernel_ms=kernel_ms,
            wall_seconds=wall, rows_held_to_oracle=held,
            oracle_host_seconds=host_s,
            csv=[l for l in text.splitlines() if not l.startswith("{")],
            result=value)
    for body in BODIES:
        if not total[body]:
            raise AssertionError(f"phase benches launched no {body}")
    say("benches", step="done", launches=total, card=card_line(),
        seconds=time.perf_counter() - t_phase)
    return total


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
#: 80GB HBM3, 700.00 W), keyed by kernel and shape: (rows, D) of RMSNorm,
#: (B, S or Smax, H, KV) of the attention kernels; width 3072 ran the
#: generic RMSNorm before its register kernel
EARLIER_MS = {("rms_norm", (8192, 2048)): 0.09501952171325684,
              ("rms_norm", (8192, 3072)): 0.14489151954650878,
              ("rms_norm", (131072, 128)): 0.03481791973114014,
              ("rms_norm", (24, 2048)): 0.007502400279045105,
              ("flash_attention", (4, 2048, 16, 8)): 5.592787170410157,
              ("flash_decode", (24, 24, 16, 8)): 0.0036075198650360107,
              ("flash_decode", (24, 2048, 16, 8)): 0.1580076789855957,
              # the first kernel at the reference's decode_32k length, timed
              # by benchmarks/flash_decode_bench.py run in the tree before
              # its redesign (NVIDIA H100 80GB HBM3, 700.00 W)
              ("flash_decode", (1, 32768, 16, 8)): 2.169217987060547}


def lm_compare(kernel: str, got, want, tol: float, what: str,
               kernel_output: bool = True) -> dict:
    """``got`` against ``want`` as ``assert_allclose(atol=tol, rtol=tol)``;
    returns the case's line (max abs error, the worst share of the allowed
    error) or raises. A kernel's output against its plain version's
    (``kernel_output``) also enters the kernel's worst error."""
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
    if kernel_output:
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
    groups than the card holds at once (its grid-stride loop); then the
    widths of the served models that are not powers of two — Whisper's
    1280, phi3-mini-3.8b's 3072, InternVL's 8192 — at a decode step's 24
    rows and a prefill's 8192, each of which must run the register
    kernel, as the main paths do."""
    shapes = ((24, 2048), (384, 128), (192, 128), (8192, 2048),
              (131072, 128), (65536, 128), (64, 256), (100, 512),
              (128, 1024), (1, 128), (7, 100))
    shapes += tuple((R, D) for D in rn.REG_WIDTHS for R in (1, 24, 17000))
    shapes += tuple((R, D) for D in (1280, 3072, 8192)
                    for R in (SERVE_REQUESTS, PREFILL_B * PREFILL_S))
    # lm_train's forwards: the full-width step (TRAIN_B x TRAIN_S rows), the
    # float32 parity (TRAIN_PARITY_B x TRAIN_PARITY_S), the reduced
    # example (TRAIN_EXAMPLE_B x TRAIN_EXAMPLE_S rows of 64, q/k norms of
    # 16: the generic kernel)
    for rows, D, hd, H, KV in ((TRAIN_B * TRAIN_S, 2048, 128, 16, 8),
                               (TRAIN_PARITY_B * TRAIN_PARITY_S, 2048, 128,
                                16, 8),
                               (TRAIN_EXAMPLE_B * TRAIN_EXAMPLE_S, 64, 16, 4,
                                2)):
        shapes += ((rows, D), (rows * H, hd), (rows * KV, hd))
    # phase mesh's sharded prefill and train step on the 2 x 2 mesh: norm1,
    # norm2 and the final norm on a rank's (B/2 x S/2) rows, the q and k
    # norms on its heads over the whole sequence
    for mesh_rows in (PREFILL_B // 2 * PREFILL_S, TRAIN_B // 2 * TRAIN_S):
        shapes += ((mesh_rows // 2, 2048), (mesh_rows * 8, 128),
                   (mesh_rows * 4, 128))
    # phase mesh's step moe (mixtral-8x7b, d_model 4096, no q/k norms):
    # world 1's prefill and train step on every row, a 2 x 2 rank's
    # (B/2 x S/2) rows
    for rows in (PREFILL_B * PREFILL_S, TRAIN_B * TRAIN_S):
        shapes += ((rows, 4096), (rows // 4, 4096))
    # phase mesh's step recurrent (SP off: a rank's B/2 x S rows):
    # xlstm-350m's width 1024 on world 1's rows and a 2 x 2 rank's over
    # MESH_REC_W4_XLSTM_S positions (jamba's 4096 on its rows is above)
    shapes += tuple((rows, 1024) for rows in (
        PREFILL_B * PREFILL_S, TRAIN_B * TRAIN_S,
        PREFILL_B // 2 * MESH_REC_W4_XLSTM_S,
        TRAIN_B // 2 * MESH_REC_W4_XLSTM_S))
    tol = LM_TOL[("rms_norm", dtype)]
    out = []
    for R, D in shapes:
        x = lm_randn(gen, (R, D), dtype, 3.0)
        s = lm_randn(gen, (D,), dtype)
        before = dict(ops.rms_norm.launches_by_variant)
        got = ops.rms_norm(x, s, 1e-6)
        torch.cuda.synchronize()
        variant = rn.VARIANTS[0] if D in rn.REG_WIDTHS else rn.VARIANTS[1]
        ran = {v: n - before[v]
               for v, n in ops.rms_norm.launches_by_variant.items()}
        if ran != {**dict.fromkeys(ran, 0), variant: 1}:
            raise AssertionError(f"rms_norm {dtype} ({R}, {D}) ran {ran}, "
                                 f"expected one {variant} launch")
        out.append(lm_compare("rms_norm", got, rn.rms_norm_ref(x, s, 1e-6),
                              tol, f"{dtype} ({R}, {D}) {variant}"))
    return out


def lm_attention_cases(gen, dtype):
    """(B, Sq, Skv, H, KV, hd, causal, window, q_offset): the prefill shapes
    of qwen3-1.7b and of mixtral-8x7b (H 32 / KV 8, window 4096), of
    Whisper's encoder (non-causal over 1500 frames, a ragged last tile) and
    cross-attention (Sq 2048 over Skv 1500), 20 heads of 64, and of
    InternVL's G = 8 (64 query heads on 8),
    tests/test_kernels.py's shapes (Sq = 100 and 192: ragged q and kv
    tiles; windows; non-causal), a q_offset, a window at hd 128; then
    ragged Sq / Skv of 33, 100 and 2047 (partial tiles of the tensor-core
    kernel's 128 rows), q_offsets with Skv > Sq, windows, non-causal, G =
    H / KV of 1, 2 and 4, at every head dim."""
    cases = ((PREFILL_B, PREFILL_S, PREFILL_S, 16, 8, 128, True, 0, 0),
             (PREFILL_B, PREFILL_S, PREFILL_S, 32, 8, 128, True, 4096, 0),
             # jamba-v0.1-52b's prefill (32 / 8 heads, no window): phase
             # lm_recurrent's and step recurrent's world 1
             (PREFILL_B, PREFILL_S, PREFILL_S, 32, 8, 128, True, 0, 0),
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
             (2, 1, 40, 4, 2, 128, True, 0, 39),
             # head dim 96: phi3-mini-3.8b's prefill (32 heads, MHA), a
             # window, ragged and non-causal tiles
             (PREFILL_B, PREFILL_S, PREFILL_S, *PHI3_HEADS, 96, True, 0, 0),
             (2, 700, 700, *PHI3_HEADS, 96, True, 300, 0),
             (1, 333, 333, 4, 2, 96, False, 0, 0),
             (2, 100, 257, 4, 4, 96, True, 0, 157),
             (PREFILL_B, WHISPER_FRAMES, WHISPER_FRAMES, *WHISPER_HEADS, 64,
              False, 0, 0),
             (PREFILL_B, PREFILL_S, WHISPER_FRAMES, *WHISPER_HEADS, 64, False,
              0, 0),
             (PREFILL_B, PREFILL_S, PREFILL_S, *INTERNVL_HEADS, 128, True, 0,
              0),
             # the prefill steps of lm_encdec: Whisper's decoder
             # self-attention, InternVL's patch rows and text in one
             # sequence
             (PREFILL_B, PREFILL_S, PREFILL_S, *WHISPER_HEADS, 64, True, 0,
              0),
             (PREFILL_B, internvl_prefill_rows(), internvl_prefill_rows(),
              *INTERNVL_HEADS, 128, True, 0, 0),
             # lm_train's forwards: the full-width step, the float32
             # parity, the reduced example (4 / 2 heads of 16)
             (TRAIN_B, TRAIN_S, TRAIN_S, 16, 8, 128, True, 0, 0),
             (TRAIN_PARITY_B, TRAIN_PARITY_S, TRAIN_PARITY_S, 16, 8, 128,
              True, 0, 0),
             (TRAIN_EXAMPLE_B, TRAIN_EXAMPLE_S, TRAIN_EXAMPLE_S, 4, 2, 16,
              True, 0, 0),
             # phase mesh's sharded prefill and train step on the 2 x 2
             # mesh: a rank's rows over "data", its heads over "model", the
             # whole sequence
             (PREFILL_B // 2, PREFILL_S, PREFILL_S, 16 // 2, 8 // 2, 128,
              True, 0, 0),
             (TRAIN_B // 2, TRAIN_S, TRAIN_S, 16 // 2, 8 // 2, 128, True, 0,
              0),
             # phase mesh's step moe (mixtral-8x7b, window 4096): world 1's
             # train step, and a 2 x 2 rank's prefill and train step (its
             # rows over "data", its heads over "model")
             (TRAIN_B, TRAIN_S, TRAIN_S, *MOE_HEADS, 128, True, 4096, 0),
             (PREFILL_B // 2, PREFILL_S, PREFILL_S, MOE_HEADS[0] // 2,
              MOE_HEADS[1] // 2, 128, True, 4096, 0),
             (TRAIN_B // 2, TRAIN_S, TRAIN_S, MOE_HEADS[0] // 2,
              MOE_HEADS[1] // 2, 128, True, 4096, 0))
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
    path (Smax = 24) at qwen3-1.7b's heads, and at mixtral-8x7b's with
    kv_len both as an int and on the device, a long cache, tests/test_kernels.py's shapes
    (kv_len < Smax, a window), kv_len = 1; each with q of the cache's type
    and with a float32 q (the prefill default: bf16 cache, f32 q), kv_len
    as an int. Then kv_len as an int32 on the device (as the serving path
    passes it): the serving shape, the split path at (1, 32768) (the
    reference's decode_32k) and at (2, 4096) with windows that leave most
    splits empty. Then lm_encdec's caches: Whisper's cross cache and its
    self-attention cache (hd 64, G = 1), InternVL's heads (G = 8) over 24
    rows and over the rows it serves from (``served_cache_rows``), every
    kv_len. Each launch's variant (one split or several) is checked
    against ``num_splits``; a bfloat16 output is also held to one bfloat16
    step of its largest value (``lm_within_a_bf16_step``)."""
    cases = [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, 16, 8, 128, 0,
              False) for n in range(1, SERVE_PROMPT + SERVE_NEW + 1)]
    # mixtral-8x7b's serving shapes (H 32 / KV 8: G = 4 at hd 128), kv_len
    # as an int and on the device
    cases += [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, *MOE_HEADS, 128,
               0, on_device) for on_device in (False, True)
              for n in range(1, SERVE_PROMPT + SERVE_NEW + 1)]
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
    # head dim 96 (phi3-mini-3.8b: 32 heads, G = 1; a row is 12 or 24
    # loads in lane groups of 16 or 32): every kv_len of its serving cache
    # with kv_len as an int and on the device, then the split path
    cases += [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, *PHI3_HEADS, 96,
               0, on_device) for on_device in (False, True)
              for n in range(1, SERVE_PROMPT + SERVE_NEW + 1)]
    cases += [(1, 32768, 32768, *PHI3_HEADS, 96, 0, True),
              (1, 32768, 20001, *PHI3_HEADS, 96, 1000, False),
              (2, 4096, 3000, *PHI3_HEADS, 96, 300, True),
              (3, 40, 39, 4, 2, 96, 5, False)]
    # Whisper's cross cache (every one of its 1500 rows, kv_len an int, as
    # the step passes it) and its self-attention cache at every kv_len on
    # the device (G = 1 at hd 64); InternVL's heads (G = 8: each KV row read
    # for two blocks of four heads) over a 24-row cache and over the cache
    # lm_encdec serves from (its patch rows, then the text), at every kv_len
    # on the device
    cases += [(SERVE_REQUESTS, WHISPER_FRAMES, WHISPER_FRAMES,
               *WHISPER_HEADS, 64, 0, False)]
    whisper_rows = served_cache_rows(WHISPER_ARCH)
    cases += [(SERVE_REQUESTS, whisper_rows, n, *WHISPER_HEADS, 64, 0, True)
              for n in range(1, whisper_rows + 1)]
    cases += [(SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW, n, *INTERNVL_HEADS,
               128, 0, True) for n in range(1, SERVE_PROMPT + SERVE_NEW + 1)]
    internvl_rows = served_cache_rows(INTERNVL_ARCH)
    cases += [(SERVE_REQUESTS, internvl_rows, n, *INTERNVL_HEADS, 128, 0,
               True) for n in range(1, internvl_rows + 1)]
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
    for line in lm_grad_cases(gen):
        say("lm_grad", **line)
    say("lm_kernels_done", seconds=round(time.perf_counter() - t0, 3))


def lm_grad_cases(gen) -> list:
    """The gradient through each wrapper on the card (grad mode on, float32
    inputs that require a gradient: ``_lm.KernelWithPlainBackward``): the
    forward launches the kernel once, and every input's gradient exists
    and equals the plain version's on the same tensors, at the kernel's
    float32 tolerance (attention 2e-5, RMSNorm 1e-6, decode 2e-5), and the
    forward's output equals the plain version's. The loss is the output
    weighed by a ramp, so the same gradient reaches both backwards."""
    f32 = torch.float32
    kv = torch.tensor([1500], dtype=torch.int32, device=DEV)
    cases = {
        "rms_norm": ([lm_randn(gen, (24, 4096), f32, 3.0),
                      lm_randn(gen, (4096,), f32)],
                     lambda x, s: ops.rms_norm(x, s, 1e-6),
                     lambda x, s: rn.rms_norm_ref(x, s, 1e-6),
                     LM_TOL[("rms_norm", f32)]),
        "flash_attention": ([lm_randn(gen, (1, 256, 32, 128), f32),
                             lm_randn(gen, (1, 256, 8, 128), f32),
                             lm_randn(gen, (1, 256, 8, 128), f32)],
                            lambda q, k, v: ops.flash_attention(
                                q, k, v, window=100),
                            lambda q, k, v: fa.flash_attention_ref(
                                q, k, v, window=100),
                            LM_TOL[("attention", f32)]),
        "flash_decode": ([lm_randn(gen, (24, 1, 32, 128), f32),
                          lm_randn(gen, (24, 2048, 8, 128), f32),
                          lm_randn(gen, (24, 2048, 8, 128), f32)],
                         lambda q, k, v: ops.flash_decode(q, k, v, kv),
                         lambda q, k, v: fd.decode_attention_ref(q, k, v,
                                                                 kv),
                         LM_TOL[("attention", f32)]),
    }
    lines = []
    for kernel, (ins, run, plain, tol) in cases.items():
        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            out = fn(*leaves)
            w = torch.linspace(-1, 1, out.numel(), device=DEV)
            (out * w.reshape(out.shape)).sum().backward()
            return out.detach(), [t.grad for t in leaves]
        before = ops.launch_counts()[kernel]
        out, got = grads(run)
        torch.cuda.synchronize()
        launched = ops.launch_counts()[kernel] - before
        want_out, want = grads(plain)
        if launched != 1 or any(g is None for g in got):
            raise AssertionError(f"{kernel} gradient: {launched} launches, "
                                 f"gradients {[g is None for g in got]}")
        errs = [lm_compare(kernel, out, want_out, tol, "grad forward")]
        errs += [lm_compare(kernel, g, w, tol, f"grad of input {i}",
                            kernel_output=False)
                 for i, (g, w) in enumerate(zip(got, want))]
        lines.append(dict(kernel=kernel, launches=launched, tol=tol,
                          shapes=[list(t.shape) for t in ins],
                          max_abs_err=[e["max_abs_err"] for e in errs],
                          worst_share_of_tol=max(e["share_of_tol"]
                                                 for e in errs),
                          gradients_none=0))
    return lines


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


def phase_lm_main_path() -> dict:
    """(a) serving: decode_batch at serve.py's defaults; (b) production
    prefill: build_prefill_step on 4 x 2048 tokens; each counted on its own
    (:func:`lm_serve_and_prefill`: per step and layer norm1, q_norm, k_norm,
    norm2 and one decode attention, per step the final norm; every width of
    the serving path, 2048 and 128, has a register kernel, and a cache of
    24 rows is one split); then the full-width float32 parity of forward
    and sequential prefill."""
    cfg = get_lm_config(LM_ARCH)
    model = build_lm_model(cfg)                       # device=None: the card
    params, init_s = init_weights(model, LM_SEED)
    rng = np.random.default_rng(LM_SEED)
    out = lm_serve_and_prefill("lm_main_path", LM_ARCH, model, params, rng,
                               rms_variant="row_in_registers",
                               extra=dict(init_seconds=init_s))
    # ---- float32 parity at full width (tests/test_models_smoke.py) --------
    params32 = tree_to(params, torch.float32)               # exact
    del params
    float32_parity("lm_parity", LM_ARCH, build_lm_model(
        dataclasses.replace(cfg, param_dtype="float32")), params32, rng)
    del params32
    return out


# ---------------------------------------------------------------------------
# Phase lm_moe: mixtral-8x7b at full width (depth cut to what one card holds)
# through the MoE layer with its work-stealing overflow rebalance.
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x7b"
MOE_SEED = 0
#: layers served at full width: 4 of 32 (bf16: 6.07 B parameters, 12.1 GB;
#: all 32 are 46.7 B, 93.4 GB, above the card's 80 GB)
MOE_REPEATS = 4
#: layers of the float32 parity check (3.16 B parameters, 12.7 GB)
MOE_PARITY_REPEATS = 2
#: tokens of the MoE layer held against the port's CPU plain path, and the
#: weight of a direction shared by every token (it skews the routing, so
#: that experts overflow and idle ones steal)
MOE_LAYER_T, MOE_SKEW = 64, 1.0
#: the routing groups held against the CPU, as (tokens, y compared too):
#: the decode step's (24 tokens, capacity 8), MOE_LAYER_T tokens (capacity
#: 20) and the production prefill's (4 x 2048 tokens, capacity 2560;
#: routing only, since the CPU's expert products at 2560 slots would take
#: minutes)
MOE_GROUPS = ((SERVE_REQUESTS, True), (MOE_LAYER_T, True),
              (PREFILL_B * PREFILL_S, False))
#: (query heads, KV heads) of mixtral-8x7b
MOE_HEADS = (32, 8)
#: (query heads, KV heads) of phi3-mini-3.8b, at head dim 96
PHI3_HEADS = (32, 32)
#: (query heads, KV heads) of whisper-large-v3 (head dim 64) and of
#: internvl2-76b (head dim 128), and Whisper's frames a request
WHISPER_HEADS, INTERNVL_HEADS, WHISPER_FRAMES = (20, 20), (64, 8), 1500


def served_cache_rows(arch: str) -> int:
    """The rows of the self-attention cache lm_encdec serves ``arch``
    from: its vision prefix, the prompt and the new tokens."""
    return get_lm_config(arch).vision_prefix_len + SERVE_PROMPT + SERVE_NEW


def internvl_mean_kv_len() -> int:
    """The mean kv_len of InternVL's replayed text steps in lm_encdec: the
    text steps run at kv_len P + 1 ... P + SERVE_PROMPT + SERVE_NEW, the
    first of them captured, not replayed."""
    P = get_lm_config(INTERNVL_ARCH).vision_prefix_len
    return P + (2 + SERVE_PROMPT + SERVE_NEW) // 2


def internvl_prefill_rows() -> int:
    """The sequence of InternVL's prefill step in lm_encdec: its patch
    rows, then PREFILL_S tokens."""
    return get_lm_config(INTERNVL_ARCH).vision_prefix_len + PREFILL_S


def moe_cfg(repeats: int, **over):
    return dataclasses.replace(get_lm_config(MOE_ARCH), repeats=repeats,
                               **over)


def step_weight_bytes(params, batch: int) -> int:
    """Bytes a decode step must read: every weight of the decoder once (the
    expert GEMMs run every expert's C slots, so all experts' weights are
    read), of an untied embedding table only the batch's rows, of a learned
    position table one row; not the encoder, which a step does not run, nor
    a cross-attention's wk and wv, whose products the cross cache holds."""
    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    def nbytes(t):
        return t.numel() * t.element_size()
    total = sum(nbytes(t) for t in leaves(params))
    total -= sum(nbytes(t) for t in leaves(params.get("encoder", {})))
    for slot in params["layers"].values():
        if "xattn" in slot:
            total -= nbytes(slot["xattn"]["wk"]) + nbytes(slot["xattn"]["wv"])
    if "pos_embed" in params:
        pe = params["pos_embed"]
        total -= nbytes(pe) - pe.shape[1] * pe.element_size()
    emb = params["tok_embed"]
    if "lm_head" in params:
        total -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    return total


def phase_lm_moe() -> dict:
    """mixtral-8x7b at full width, ``MOE_REPEATS`` layers, bf16 random
    weights from a seed on the card: (1) serving through decode_batch's
    graph, tokens equal to the eager loop's; (2) the production prefill;
    each counted on its own; (3) the float32 parity of forward and
    sequential prefill at ``MOE_PARITY_REPEATS`` layers; (4) one MoE layer
    on the card against the port's CPU plain path, routing equal; (5)
    where a decode step's time goes."""
    t_phase = time.perf_counter()
    cfg = moe_cfg(MOE_REPEATS)
    model = build_lm_model(cfg)                       # device=None: the card
    params, init_s = init_weights(model, MOE_SEED)
    rng = np.random.default_rng(MOE_SEED)
    # (1), (2): a step runs norm1 and norm2 a layer (no qk-norm) and the
    # final norm, one flash decode a layer; width 4096 has a register
    # kernel, 24 rows one split
    out = lm_serve_and_prefill(
        "lm_moe", MOE_ARCH, model, params, rng,
        rms_variant="row_in_registers",
        extra=dict(init_seconds=init_s, capacity_factor=cfg.capacity_factor,
                   ws_rebalance=cfg.ws_rebalance),
        prefill_extra=dict(capacity=moe_mod.capacity(
            PREFILL_B * PREFILL_S, cfg.experts_per_tok, cfg.capacity_factor,
            cfg.n_experts)))
    # ---- (5) where a decode step's time goes (the served weights) ----------
    profile_decode(model, params, rng, MOE_ARCH, repeats=cfg.repeats)
    layer0 = {k: v[0].float() for k, v in
              params["layers"]["slot0"]["ffn"].items()}
    parity_params = {k: (tree_to(_first(v, MOE_PARITY_REPEATS), torch.float32)
                         if k == "layers" else v.float())
                     for k, v in params.items()}
    del params, model
    torch.cuda.empty_cache()
    # ---- (3) float32 parity at full width ----------------------------------
    cfg32 = moe_cfg(MOE_PARITY_REPEATS, param_dtype="float32",
                    capacity_factor=64.0, ws_rebalance=False)
    model32 = build_lm_model(cfg32)
    float32_parity("lm_moe", MOE_ARCH, model32, parity_params, rng,
                   repeats=cfg32.n_layers,
                   capacity_factor=cfg32.capacity_factor, ws_rebalance=False)
    del parity_params, model32
    torch.cuda.empty_cache()
    # ---- (4) one MoE layer on the card against the CPU plain path ----------
    moe_layer_against_the_cpu(cfg, layer0, rng)
    say("lm_moe", path="done", seconds=time.perf_counter() - t_phase)
    return out


def _first(tree, n: int):
    """The first ``n`` layers of a tree stacked over repeats (views)."""
    return {k: _first(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def moe_layer_against_the_cpu(cfg, layer: dict, rng) -> None:
    """One full-width MoE layer (float32 weights, the config's capacity
    factor, the rebalance on) on the card against the port's CPU plain path
    (which the CPU tests hold to the JAX package), at each group of
    ``MOE_GROUPS``: the group the decode step routes, ``MOE_LAYER_T``
    skewed tokens (``stolen`` > 0), and the production prefill's."""
    cpu = {n: w.cpu() for n, w in layer.items()}
    for T, with_y in MOE_GROUPS:
        line, faults = moe_group_against_the_cpu(cfg, layer, cpu, T, with_y,
                                                 rng)
        say("lm_moe", **line)
        if T == MOE_LAYER_T and not line["stolen"] > 0:
            faults.append(f"stolen {line['stolen']}, expected > 0")
        if faults:
            raise AssertionError(f"MoE layer on the card, {T} tokens: "
                                 f"{'; '.join(faults)}")


def moe_group_against_the_cpu(cfg, layer: dict, cpu: dict, T: int,
                              with_y: bool, rng):
    """One routing group of ``T`` float32 tokens on the card and on the CPU.
    Returns (the case's line, its faults):

    * the top-k experts are equal on every token whose adjacent top-(k+1)
      router probabilities are at least 1e-6 apart; a token below that is a
      near-tie, where two float32 router products may order two experts
      differently: it is reported, and excused on that token alone;
    * the integer half of the routing (slots, keep masks, stolen masks,
      load: ``moe._slots``) on the card equals the CPU's run on the card's
      own choice of experts, exactly, and so do ``dropped`` and ``stolen``:
      no near-tie excuses a difference there;
    * with ``with_y``, the layer's y (``moe_apply``) within 1e-4 * max|y|
      (float32 products summed in other orders) on every token whose
      experts and keep masks are equal on both sides: all of them unless a
      near-tie moved one."""
    E, k, D = cfg.n_experts, cfg.experts_per_tok, cfg.d_model
    x = torch.as_tensor(rng.standard_normal((1, T, D))
                        + MOE_SKEW * rng.standard_normal(D),
                        dtype=torch.float32)
    C = moe_mod.capacity(T, k, cfg.capacity_factor, E)
    t0 = time.perf_counter()
    r_gpu = moe_mod._route(x[0].to(DEV), layer["router"], E, k, C, True)
    card_fractions = [float(v) for v in moe_mod._route_stats(r_gpu, E)[1:]]
    r_gpu = moe_mod._Route(*(t.cpu() for t in r_gpu))
    r_cpu = moe_mod._route(x[0], cpu["router"], E, k, C, True)
    on_card_choice = moe_mod._slots(r_gpu.expert_idx, E, C, True)
    probs = torch.softmax(x[0].double() @ cpu["router"].double(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
    gaps = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
    tie = gaps < 1e-6
    apart = (r_gpu.expert_idx != r_cpu.expert_idx).any(dim=-1)
    faults = []
    if bool((apart & ~tie).any()):
        faults.append(f"top-k experts differ on tokens "
                      f"{torch.nonzero(apart & ~tie)[:, 0].tolist()} with "
                      f"no near-tie")
    names = ("flat_e", "slot_c", "keep", "steal", "load")
    differ = [n for n, want in zip(names, on_card_choice)
              if not torch.equal(getattr(r_gpu, n), want)]
    keep, steal = on_card_choice[2], on_card_choice[3]
    if card_fractions != [float((~keep).float().mean()),
                          float(steal.float().mean())]:
        differ.append("dropped/stolen")
    if differ:
        faults.append(f"the integer routing on the card differs from the "
                      f"CPU's on the card's experts in {differ}")
    same = ((r_gpu.flat_e == r_cpu.flat_e) & (r_gpu.keep == r_cpu.keep)) \
        .reshape(T, k).all(dim=-1)
    if not bool(apart.any()) and not bool(same.all()):
        faults.append("assignments differ with the same top-k experts")
    dropped, stolen = card_fractions
    line = dict(path="moe_layer_vs_cpu", arch=MOE_ARCH, tokens=T, d_model=D,
                d_ff=cfg.expert_d_ff, experts=E, top_k=k, capacity=C,
                capacity_factor=cfg.capacity_factor, ws_rebalance=True,
                skew=MOE_SKEW, stolen=stolen, dropped=dropped,
                load=r_gpu.load.tolist(), integer_routing_differs_in=differ,
                tokens_with_other_experts=int(apart.sum()),
                smallest_top_gap=float(gaps.min()),
                tokens_with_a_gap_below_1e_6=int(tie.sum()),
                routing_equals_the_cpus=not differ and not bool(apart.any()),
                gates_max_abs_err=float(((r_gpu.gates - r_cpu.gates).abs()
                                         * same.repeat_interleave(k)).max()),
                route_seconds=time.perf_counter() - t0)
    if T <= 64:
        line["top_gap_by_token"] = [float(g) for g in gaps]
    if with_y:
        kw = dict(n_experts=E, top_k=k, capacity_factor=cfg.capacity_factor,
                  ws_rebalance=True)
        y_gpu, aux_gpu, _st = moe_mod.moe_apply(layer, x.to(DEV), **kw)
        y_gpu = y_gpu.cpu()
        y_cpu, aux_cpu, _st = moe_mod.moe_apply(cpu, x, **kw)
        y_err = float(((y_gpu - y_cpu)[0].abs() * same[:, None]).max())
        y_tol = 1e-4 * float(y_cpu.abs().max())
        line.update(y_max_abs_err=y_err, y_tol=y_tol,
                    y_tokens_compared=int(same.sum()),
                    aux_gpu=float(aux_gpu), aux_cpu=float(aux_cpu))
        if not y_err <= y_tol:
            faults.append(f"y error {y_err} (tolerance {y_tol})")
    return line, faults


# ---------------------------------------------------------------------------
# Phase lm_recurrent: the recurrent mixers (xlstm-350m's mLSTM and sLSTM,
# jamba-v0.1-52b's Mamba beside attention and MoE) and head dim 96
# (phi3-mini-3.8b), each served at full width.
# ---------------------------------------------------------------------------

REC_SEED = 0
XLSTM_ARCH, JAMBA_ARCH, PHI3_ARCH = ("xlstm-350m", "jamba-v0.1-52b",
                                     "phi3-mini-3.8b")
#: Jamba's depth served: one period of its pattern (8 of 32 layers: 7
#: Mamba, 1 attention, 4 MoE of 16 experts, 4 dense; 13.27 B parameters,
#: 26.5 GB in bf16; all 32 are 51.48 B, 103 GB, above the card's 80 GB)
JAMBA_REPEATS = 1
#: Jamba's float32 parity: the first five slots of its pattern (mamba/dense,
#: mamba/moe, mamba/dense, mamba/moe, attn/dense: every slot kind), one
#: repeat, 7.15 B parameters, 28.6 GB
JAMBA_PARITY_SLOTS = 5


def init_weights(model, seed: int) -> tuple:
    """(random weights of ``model`` from ``seed`` on the card, the seconds
    that took)."""
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def recurrent_state_bytes(cache: dict) -> int:
    """Bytes of the recurrent state in a decode cache (every leaf of a
    layer without a KV cache): a decode step reads it once and writes it
    once."""
    total = 0
    for slot in cache["layers"].values():
        if "k" not in slot:
            total += sum(t.numel() * t.element_size() for t in slot.values())
    return total


def kv_bytes_per_replayed_step(cache: dict, steps: int,
                               first: int = 0) -> float:
    """Mean bytes of K and V that a replayed step of a ``steps``-step
    decode at positions ``first`` ... ``first + steps - 1`` moves, the
    first step the graph's capture: at position p (the replays) each layer
    of attention reads its p cached rows of K and V and writes one, p + 1
    rows in all; their mean is first + (steps + 2) / 2. A layer's cross
    cache (xk, xv) is read whole every step."""
    rows = first + (steps + 2) / 2
    total = 0.0
    for slot in cache["layers"].values():
        for name, t in slot.items():
            nbytes = t.numel() * t.element_size()
            if name in ("k", "v"):
                total += nbytes / t.shape[2] * rows   # (R, B, Smax, KV, hd)
            elif name in ("xk", "xv"):
                total += nbytes
    return total


def counted_prefill(phase: str, arch: str, model, params, inputs: dict,
                    rng, variants: dict, *, rms_norm: int,
                    flash_attention: int, **extra) -> dict:
    """``build_prefill_step`` at PREFILL_B x PREFILL_S tokens drawn from
    ``rng``, behind ``inputs`` (frames or patch embeddings), warmed once,
    then counted on its own: every count at 0 just before, and just after
    ``rms_norm`` and ``flash_attention`` launches by ``variants``
    (:func:`lm_counts_since_reset`), finite float32 logits (B, 1, Vpad).
    Says and returns its line: wall seconds, prompt tokens/s, peak GiB."""
    cfg = model.cfg
    step = build_prefill_step(model)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)),
        dtype=torch.int64, device=DEV), **inputs}
    step(params, batch)                                     # warm
    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts, by_variant = lm_counts_since_reset(
        variants, rms_norm=rms_norm, flash_attention=flash_attention)
    if logits.shape != (PREFILL_B, 1, cfg.padded_vocab) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype} or not finite")
    prefill = dict(batch=PREFILL_B, seq=PREFILL_S, wall_seconds=prefill_s,
                   tokens_per_second=PREFILL_B * PREFILL_S / prefill_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   **extra, launches=counts, launches_by_variant=by_variant)
    say(phase, path="steps.build_prefill_step", arch=arch,
        repeats=cfg.repeats, card=card_line(), **prefill)
    return prefill


def lm_serve_and_prefill(phase: str, arch: str, model, params, rng, *,
                         rms_variant: str, extra: dict,
                         prefill_extra: dict = None) -> dict:
    """(1) ``decode_batch`` at serve.py's defaults (24 requests, prompt 16,
    8 new tokens), each step after the first a replay of one CUDA graph;
    its tokens equal to an eager loop's; (2) ``build_prefill_step`` at 4 x
    2048. Each run counted on its own, every count at 0 just before and
    exact just after: a step runs the norm before each mixer and FFN, a
    q-norm and a k-norm a layer of attention where the config has them, and
    the final norm (RMSNorm variant ``rms_variant``), and one flash decode
    a layer of attention; the prefill the same norms and one flash
    attention (``tc_bf16``) a layer of attention. The step's byte bound:
    every weight once (of an untied embedding the batch's rows), the
    recurrent state read and written once, and the K and V rows a replayed
    step moves (:func:`kv_bytes_per_replayed_step`). Returns
    dict(serve=..., prefill=..., tokens=..., prompts=...): the two runs'
    lines, the served tokens and the requests' prompts."""
    cfg = model.cfg
    attn = sum(m == "attn" for m, _f in cfg.pattern) * cfg.repeats
    norms = sum(1 if ffn == "none" else 2 for _m, ffn in cfg.pattern) \
        * cfg.repeats + 1 + (2 * attn if cfg.qk_norm else 0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               SERVE_PROMPT).astype(np.int32),
                    max_new=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    decode_batch(model, params, reqs)                       # warm (cuBLAS)
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = decode_batch(model, params, reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    graph = decode_batch.last_graph
    steps = SERVE_PROMPT + SERVE_NEW
    want = {"rms_norm": {rms_variant: steps * norms}}
    if attn:
        want["flash_decode"] = {"single": steps * attn}
    serve_counts, serve_variants = lm_counts_since_reset(
        want, rms_norm=steps * norms, flash_decode=steps * attn)
    if graph is None or graph["replays"] != steps - 1:
        raise AssertionError(f"{arch} decode_batch replayed {graph}, "
                             f"expected {steps - 1} replays")
    if tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or tokens.dtype != \
            np.int32 or tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
        raise AssertionError(f"{arch} decode_batch returned {tokens.shape} "
                             f"{tokens.dtype} in [{tokens.min()}, "
                             f"{tokens.max()}]")
    eager_tokens, eager_walls = serve_with_inputs(model, params, {
        "tokens": torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                  dtype=torch.int64, device=DEV)},
        model.decode_step)
    eager_s = sum(eager_walls)
    if not np.array_equal(tokens, eager_tokens):
        raise AssertionError(f"{arch} decode_batch's tokens differ from the "
                             f"eager loop's in "
                             f"{int((tokens != eager_tokens).sum())} places")
    replayed_s = serve_s - graph["warmup_seconds"] - graph["capture_seconds"]
    weight_bytes = step_weight_bytes(params, SERVE_REQUESTS)
    cache = model.init_cache(SERVE_REQUESTS, steps)
    state_bytes = 2 * recurrent_state_bytes(cache)
    kv_bytes = kv_bytes_per_replayed_step(cache, steps)
    del cache
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
                 step_weight_bytes=weight_bytes,
                 step_state_bytes_read_and_written=state_bytes,
                 step_kv_bytes=kv_bytes,
                 step_bound_ms=(weight_bytes + state_bytes + kv_bytes)
                 / HBM_BYTES_PER_S * 1e3,
                 step_bound_ms_weights_only=weight_bytes
                 / HBM_BYTES_PER_S * 1e3,
                 eager_loop_wall_seconds=eager_s,
                 eager_loop_ms_per_step=eager_s / steps * 1e3,
                 tokens_equal_the_eager_loop=True,
                 launches=serve_counts, launches_by_variant=serve_variants,
                 launches_per_replay=graph["launches_per_replay"][0],
                 sample=tokens[0].tolist())
    say(phase, path="serve.decode_batch", arch=arch, repeats=cfg.repeats,
        layers=cfg.n_layers, params=model.param_count(),
        param_dtype=cfg.param_dtype, card=card_line(), **extra, **serve)
    want = {"rms_norm": {rms_variant: norms}}
    if attn:
        want["flash_attention"] = {"tc_bf16": attn}
    prefill = counted_prefill(phase, arch, model, params, {}, rng, want,
                              rms_norm=norms, flash_attention=attn,
                              **(prefill_extra or {}))
    return dict(serve=serve, prefill=prefill, tokens=tokens,
                prompts=np.stack([r.prompt for r in reqs]))


def profile_decode(model, params, rng, arch: str, **extra) -> None:
    """``lm_profile``'s two windows (eager, graph replay) of the served
    model's decode step, at the serving batch, tokens drawn from ``rng``."""
    tok = torch.as_tensor(rng.integers(1, model.cfg.vocab_size,
                                       (SERVE_REQUESTS, 1)),
                          dtype=torch.int64, device=DEV)
    for window, prof in lm_profile_decode_steps(model, params, tok).items():
        say("lm_profile", what=f"decode steps, serving path, {window}",
            arch=arch, card=card_line(), **extra, **prof)


def float32_parity(phase: str, arch: str, model32, params32, rng,
                   inputs=None, **extra) -> None:
    """tests/test_models_smoke.py's parity at full width in float32: the
    last position's logits of ``forward`` against sequential prefill (one
    decode step a token, the recurrent state carried in a float32 cache),
    within 1e-3 max|logit| + 1e-3. ``inputs``: the batch's frames or
    patch embeddings (``model_inputs``), where the config takes them."""
    cfg = model32.cfg
    tk = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PARITY_B, PARITY_S)),
                         dtype=torch.int64, device=DEV)
    batch = {"tokens": tk, **(inputs or {})}
    fwd, aux = model32.forward(params32, batch)
    fwd = fwd[:, -1]
    prefix = batch["vis_embeds"].shape[1] if "vis_embeds" in batch else 0
    _cache, dec = model32.prefill(params32, batch, max_seq=prefix + PARITY_S,
                                  dtype=torch.float32)
    diff = float((fwd - dec[:, 0]).abs().max())
    tol = 1e-3 * float(fwd.abs().max()) + 1e-3
    if not diff < tol or not bool(torch.isfinite(fwd).all()):
        raise AssertionError(f"{arch} float32 forward and sequential prefill "
                             f"differ by {diff} (tolerance {tol})")
    say(phase, path="parity", arch=arch, layers=cfg.n_layers,
        params=model32.param_count(), param_dtype="float32", batch=PARITY_B,
        seq=PARITY_S, max_abs_diff=diff, tol=tol,
        max_abs_logit=float(fwd.abs().max()), moe_aux=float(aux), **extra)


def phase_lm_recurrent() -> dict:
    """xlstm-350m (24 layers), jamba-v0.1-52b (one period, 8 layers) and
    phi3-mini-3.8b (32 layers, head dim 96) at full width, bf16 random
    weights from a seed on the card: each served and prefilled
    (:func:`lm_serve_and_prefill`); the sLSTM prefill's own time at 4 x
    2048; where a decode step's time goes (xlstm and jamba); the float32
    parity of forward and sequential prefill (xlstm whole; jamba's first
    five slots, built after its bf16 weights are freed). Returns the
    counted runs by ``LM_PATHS`` key."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(REC_SEED)
    runs = {}

    # ---- xlstm-350m: 12 mLSTM (8 heads of 256) and 12 sLSTM layers --------
    t0 = time.perf_counter()
    cfg = get_lm_config(XLSTM_ARCH)
    model = build_lm_model(cfg)                       # device=None: the card
    params, init_s = init_weights(model, REC_SEED)
    out = lm_serve_and_prefill("lm_recurrent", XLSTM_ARCH, model, params,
                               rng, rms_variant="row_in_registers",
                               extra=dict(init_seconds=init_s))
    runs["xlstm_serve"], runs["xlstm_prefill"] = out["serve"], out["prefill"]
    # one sLSTM layer over the prefill's 4 x 2048 tokens: 2048 timesteps,
    # each a few kernels launched from the host
    j = next(i for i, (m, _f) in enumerate(cfg.pattern) if m == "slstm")
    layer = {k: v[0] for k, v in params["layers"][f"slot{j}"]["slstm"].items()}
    h = lm_randn(torch.Generator(device=DEV).manual_seed(REC_SEED),
                 (PREFILL_B, PREFILL_S, cfg.d_model), torch.bfloat16)
    dims = xlstm_mod.xlstm_dims(cfg.d_model, cfg.n_heads)
    xlstm_mod.slstm_apply(layer, h[:, :64], dims)           # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    y = xlstm_mod.slstm_apply(layer, h, dims, max(cfg.ssm_chunk, 16))
    torch.cuda.synchronize()
    say("lm_recurrent", path="slstm_layer", arch=XLSTM_ARCH,
        batch=PREFILL_B, seq=PREFILL_S, heads=dims.n_heads,
        head_dim=dims.head_dim, wall_seconds=time.perf_counter() - t1,
        finite=bool(torch.isfinite(y).all()), card=card_line())
    profile_decode(model, params, rng, XLSTM_ARCH)
    params32 = tree_to(params, torch.float32)               # exact
    del params, model, layer, h, y
    torch.cuda.empty_cache()
    float32_parity("lm_recurrent", XLSTM_ARCH, build_lm_model(dataclasses
                   .replace(cfg, param_dtype="float32")), params32, rng)
    del params32
    torch.cuda.empty_cache()
    say("lm_recurrent", path="done", arch=XLSTM_ARCH,
        seconds=time.perf_counter() - t0)
    # ---- jamba-v0.1-52b: one period ----------------------------------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_lm_config(JAMBA_ARCH),
                              repeats=JAMBA_REPEATS)
    model = build_lm_model(cfg)
    params, init_s = init_weights(model, REC_SEED + 1)
    out = lm_serve_and_prefill(
        "lm_recurrent", JAMBA_ARCH, model, params, rng,
        rms_variant="row_in_registers",
        extra=dict(init_seconds=init_s, capacity_factor=cfg.capacity_factor,
                   ws_rebalance=cfg.ws_rebalance, ssm_chunk=cfg.ssm_chunk))
    runs["jamba_serve"], runs["jamba_prefill"] = out["serve"], out["prefill"]
    profile_decode(model, params, rng, JAMBA_ARCH, repeats=cfg.repeats)
    del params, model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(
        cfg, pattern=cfg.pattern[:JAMBA_PARITY_SLOTS], param_dtype="float32",
        capacity_factor=64.0, ws_rebalance=False)
    model32 = build_lm_model(cfg32)
    params32, _ = init_weights(model32, REC_SEED + 2)
    float32_parity("lm_recurrent", JAMBA_ARCH, model32, params32, rng,
                   pattern=[list(sl) for sl in cfg32.pattern],
                   capacity_factor=cfg32.capacity_factor, ws_rebalance=False)
    del params32, model32
    torch.cuda.empty_cache()
    say("lm_recurrent", path="done", arch=JAMBA_ARCH,
        seconds=time.perf_counter() - t0)
    # ---- phi3-mini-3.8b: head dim 96 at full width ------------------------
    t0 = time.perf_counter()
    cfg = get_lm_config(PHI3_ARCH)
    model = build_lm_model(cfg)
    params, init_s = init_weights(model, REC_SEED + 3)
    # width 3072 has a register kernel since the encoder-decoder slice
    out = lm_serve_and_prefill("lm_recurrent", PHI3_ARCH, model, params, rng,
                               rms_variant="row_in_registers",
                               extra=dict(init_seconds=init_s,
                                          head_dim=cfg.hd))
    runs["phi3_serve"], runs["phi3_prefill"] = out["serve"], out["prefill"]
    del params, model
    torch.cuda.empty_cache()
    say("lm_recurrent", path="done", arch=PHI3_ARCH,
        seconds=time.perf_counter() - t0)
    say("lm_recurrent", path="phase_done",
        seconds=time.perf_counter() - t_phase)
    return runs


# ---------------------------------------------------------------------------
# Phase lm_encdec: the encoder-decoder (whisper-large-v3: its encoder over
# audio frames, a cross-attention in every decoder layer, learned positions)
# and the vision prefix (internvl2-76b: patch embeddings before the text),
# each served and prefilled at full width.
# ---------------------------------------------------------------------------

ENCDEC_SEED = 0
WHISPER_ARCH, INTERNVL_ARCH = "whisper-large-v3", "internvl2-76b"
#: InternVL's depth served: 8 of its 80 layers (8.95 B parameters, 17.9 GB
#: in bf16; all 80 are 70.55 B, 141 GB, above the card's 80 GB)
INTERNVL_REPEATS = 8
#: InternVL's float32 parity: its first 2 layers (3.82 B parameters,
#: 15.3 GB)
INTERNVL_PARITY_REPEATS = 2
#: frames and patch embeddings: normal draws times this
#: (tests/test_models_smoke.py draws them so)
INPUT_SCALE = 0.02


def model_inputs(cfg, batch: int, gen, dtype=torch.bfloat16) -> dict:
    """The audio frames (B, encoder_seq_len, D) or the patch embeddings (B,
    vision_prefix_len, D) that ``cfg`` takes beside its tokens, drawn on the
    card from ``gen`` and scaled by INPUT_SCALE; {} for a config that takes
    neither. The JAX package stubs both frontends: its configs take these
    embeddings precomputed."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = lm_randn(gen, (batch, cfg.encoder_seq_len,
                                       cfg.d_model), dtype, INPUT_SCALE)
    if cfg.vision_prefix_len:
        out["vis_embeds"] = lm_randn(gen, (batch, cfg.vision_prefix_len,
                                           cfg.d_model), dtype, INPUT_SCALE)
    return out


def serve_with_inputs(model, params, batch: dict, step) -> tuple:
    """The greedy loop of ``serve.decode_batch`` over a batch that carries
    frames or patch embeddings beside its tokens (``decode_batch`` takes
    tokens alone, as the JAX package's does): ``Model.prefill(...,
    step=)`` — Whisper encodes and writes its cross caches first, InternVL
    runs its patch rows as steps on embeddings — then SERVE_NEW steps, every
    step through ``step``. Returns (tokens (B, SERVE_NEW) int32, wall
    seconds of (before the first step, the prefix's steps, the text's
    steps))."""
    P = batch["vis_embeds"].shape[1] if "vis_embeds" in batch else 0
    S = batch["tokens"].shape[1]
    marks = {}

    def run(params, cache, tokens, pos, embeds=None):
        kind = "tokens" if embeds is None else "embeds"
        if kind not in marks:
            torch.cuda.synchronize()
            marks[kind] = time.perf_counter()
        return step(params, cache, tokens, pos, embeds=embeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, batch, max_seq=P + S + SERVE_NEW,
                                  step=run)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    outs = []
    for i in range(SERVE_NEW):
        outs.append(tok[:, 0])
        logits, cache = run(params, cache, tok, P + S + i)
        tok = torch.argmax(logits, dim=-1)
    out = torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
    end = time.perf_counter()
    first = marks.get("embeds", marks["tokens"])
    return out, (first - t0, marks["tokens"] - first, end - marks["tokens"])


def encdec_serve_and_prefill(arch: str, model, params, rng, gen, *,
                             extra: dict) -> dict:
    """(1) Serving at serve.py's defaults (24 requests, prompt 16, 8 new
    tokens) behind the config's frames or patch embeddings
    (:func:`serve_with_inputs`), every step after the first of its kind a
    replay of ``GraphedDecodeStep``'s graphs (InternVL's prefix: a second
    graph, on embeddings), its tokens equal to the eager loop's; (2)
    ``build_prefill_step`` at 4 x 2048 behind the same inputs. Each counted
    on its own, every count at 0 just before and exact just after: a step
    runs the norm before each mixer, cross-attention and FFN and the final
    norm, and one flash decode a self-attention and a cross-attention;
    Whisper's encoder, once, the norms of its layers and its final norm and
    one flash attention a layer; the prefill the decoder's norms and one
    flash attention (``tc_bf16``) a self-attention and a cross-attention,
    after the encoder's. Every RMSNorm is ``row_in_registers``. The text
    step's byte bound: :func:`step_weight_bytes`, and the K and V rows and
    whole cross caches a replayed step reads
    (:func:`kv_bytes_per_replayed_step`). Returns dict(serve=...,
    prefill=...)."""
    cfg = model.cfg
    P = cfg.vision_prefix_len
    layers = cfg.repeats * len(cfg.pattern)
    cross = cfg.repeats * sum(m == "xattn" for m, _f in cfg.pattern)
    norms = 2 * layers + cross + 1
    enc_layers = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    enc_norms = 2 * enc_layers + 1 if enc_layers else 0
    text_steps = SERVE_PROMPT + SERVE_NEW
    steps = P + text_steps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode_variants = Counter()
    for smax, n in ((steps, layers), (cfg.encoder_seq_len, cross)):
        if n:
            split = fd.num_splits(SERVE_REQUESTS, cfg.n_heads, cfg.n_kv_heads,
                                  smax, sms)[0] > 1
            decode_variants[fd.VARIANTS[split]] += steps * n
    prompts = rng.integers(1, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=DEV),
             **model_inputs(cfg, SERVE_REQUESTS, gen)}
    serve_with_inputs(model, params, batch, GraphedDecodeStep(model))  # warm
    reset_all_counts()
    graphed = GraphedDecodeStep(model)
    tokens, (before_s, prefix_s, text_s) = serve_with_inputs(
        model, params, batch, graphed)
    serve_s = before_s + prefix_s + text_s
    rms = enc_norms + steps * norms
    want = {"rms_norm": {"row_in_registers": rms},
            "flash_decode": dict(decode_variants)}
    if enc_layers:
        want["flash_attention"] = {"tc_bf16": enc_layers}
    serve_counts, serve_variants = lm_counts_since_reset(
        want, rms_norm=rms, flash_decode=steps * (layers + cross),
        flash_attention=enc_layers)
    graphs = graphed.stats()["graphs"]
    if set(graphs) != ({"tokens", "embeds"} if P else {"tokens"}) or \
            graphs["tokens"]["replays"] != text_steps - 1 or \
            (P and graphs["embeds"]["replays"] != P - 1):
        raise AssertionError(f"{arch}: the graphs replayed {graphs}")
    if tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or tokens.min() < 0 or \
            tokens.max() >= cfg.padded_vocab:
        raise AssertionError(f"{arch} served {tokens.shape} tokens in "
                             f"[{tokens.min()}, {tokens.max()}]")
    eager_tokens, eager_walls = serve_with_inputs(model, params, batch,
                                                  model.decode_step)
    if not np.array_equal(tokens, eager_tokens):
        raise AssertionError(f"{arch}: the graphs' tokens differ from the "
                             f"eager loop's in "
                             f"{int((tokens != eager_tokens).sum())} places")
    tg = graphs["tokens"]
    text_replay_ms = (text_s - tg["warmup_seconds"] - tg["capture_seconds"]) \
        / tg["replays"] * 1e3
    weight_bytes = step_weight_bytes(params, SERVE_REQUESTS)
    cache = model.init_cache(SERVE_REQUESTS, steps)
    kv_bytes = kv_bytes_per_replayed_step(cache, text_steps, first=P)
    del cache
    serve = dict(requests=SERVE_REQUESTS, prompt=SERVE_PROMPT,
                 new_tokens=SERVE_NEW, prefix_rows=P, decode_steps=steps,
                 wall_seconds=serve_s,
                 tokens_per_second=SERVE_REQUESTS * SERVE_NEW / serve_s,
                 seconds_before_the_first_step=before_s,
                 prefix_steps_seconds=prefix_s, text_steps_seconds=text_s,
                 graphs=graphs, ms_per_replayed_step=text_replay_ms,
                 step_weight_bytes=weight_bytes, step_kv_bytes=kv_bytes,
                 step_bound_ms=(weight_bytes + kv_bytes)
                 / HBM_BYTES_PER_S * 1e3,
                 step_bound_ms_weights_only=weight_bytes
                 / HBM_BYTES_PER_S * 1e3,
                 eager_loop_wall_seconds=sum(eager_walls),
                 eager_loop_seconds=dict(zip(
                     ("before_the_first_step", "prefix_steps",
                      "text_steps"), eager_walls)),
                 eager_loop_ms_per_text_step=eager_walls[2] / text_steps
                 * 1e3,
                 tokens_equal_the_eager_loop=True,
                 launches=serve_counts, launches_by_variant=serve_variants,
                 launches_per_replay=tg["launches_per_replay"][0],
                 sample=tokens[0].tolist())
    if P:
        eg = graphs["embeds"]
        serve["ms_per_replayed_prefix_step"] = (
            prefix_s - eg["warmup_seconds"] - eg["capture_seconds"]) \
            / eg["replays"] * 1e3
    say("lm_encdec", path="serve.prefill_and_greedy_steps", arch=arch,
        repeats=cfg.repeats, layers=cfg.n_layers,
        encoder_layers=enc_layers, params=model.param_count(),
        param_dtype=cfg.param_dtype, card=card_line(), **extra, **serve)
    rms, attn = enc_norms + norms, enc_layers + layers + cross
    prefill = counted_prefill(
        "lm_encdec", arch, model, params, model_inputs(cfg, PREFILL_B, gen),
        rng, {"rms_norm": {"row_in_registers": rms},
              "flash_attention": {"tc_bf16": attn}},
        rms_norm=rms, flash_attention=attn, prefix_rows=P,
        encoder_frames=cfg.encoder_seq_len if enc_layers else 0)
    return dict(serve=serve, prefill=prefill)


def phase_lm_encdec() -> dict:
    """whisper-large-v3 whole (32 encoder and 32 decoder layers) and
    internvl2-76b at ``INTERNVL_REPEATS`` of its 80 layers, at full width,
    bf16 random weights from a seed on the card: each served and prefilled
    (:func:`encdec_serve_and_prefill`); where a decode step's time goes,
    eager and replayed; the float32 parity of forward and sequential prefill (Whisper
    whole; InternVL's first ``INTERNVL_PARITY_REPEATS`` layers, cast from
    the served weights after they are freed). Returns the counted runs by
    ``LM_PATHS`` key."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(ENCDEC_SEED)
    gen = torch.Generator(device=DEV).manual_seed(ENCDEC_SEED)
    runs = {}
    # ---- whisper-large-v3 ---------------------------------------------------
    t0 = time.perf_counter()
    cfg = get_lm_config(WHISPER_ARCH)
    model = build_lm_model(cfg)                       # device=None: the card
    params, init_s = init_weights(model, ENCDEC_SEED)
    out = encdec_serve_and_prefill(
        WHISPER_ARCH, model, params, rng, gen,
        extra=dict(init_seconds=init_s, encoder_frames=cfg.encoder_seq_len,
                   head_dim=cfg.hd))
    runs["whisper_serve"], runs["whisper_prefill"] = (out["serve"],
                                                      out["prefill"])
    profile_decode(model, params, rng, WHISPER_ARCH)
    params32 = tree_to(params, torch.float32)               # exact
    del params, model
    torch.cuda.empty_cache()
    model32 = build_lm_model(dataclasses.replace(cfg, param_dtype="float32"))
    float32_parity("lm_encdec", WHISPER_ARCH, model32, params32, rng,
                   inputs=model_inputs(cfg, PARITY_B, gen),
                   encoder_frames=cfg.encoder_seq_len)
    del params32, model32
    torch.cuda.empty_cache()
    say("lm_encdec", path="done", arch=WHISPER_ARCH,
        seconds=time.perf_counter() - t0)
    # ---- internvl2-76b: 8 of 80 layers --------------------------------------
    t0 = time.perf_counter()
    full = get_lm_config(INTERNVL_ARCH)
    cfg = dataclasses.replace(full, repeats=INTERNVL_REPEATS)
    model = build_lm_model(cfg)
    params, init_s = init_weights(model, ENCDEC_SEED + 1)
    out = encdec_serve_and_prefill(
        INTERNVL_ARCH, model, params, rng, gen,
        extra=dict(init_seconds=init_s, layers_of_the_config=full.n_layers,
                   prefix_step="a second CUDA graph, on embeddings"))
    runs["internvl_serve"], runs["internvl_prefill"] = (out["serve"],
                                                        out["prefill"])
    profile_decode(model, params, rng, INTERNVL_ARCH, repeats=cfg.repeats)
    parity_params = {k: (tree_to(_first(v, INTERNVL_PARITY_REPEATS),
                                 torch.float32) if k == "layers"
                         else v.float())
                     for k, v in params.items()}
    del params, model
    torch.cuda.empty_cache()
    model32 = build_lm_model(dataclasses.replace(
        cfg, repeats=INTERNVL_PARITY_REPEATS, param_dtype="float32"))
    float32_parity("lm_encdec", INTERNVL_ARCH, model32, parity_params, rng,
                   inputs=model_inputs(cfg, PARITY_B, gen),
                   repeats=INTERNVL_PARITY_REPEATS)
    del parity_params, model32
    torch.cuda.empty_cache()
    say("lm_encdec", path="done", arch=INTERNVL_ARCH,
        seconds=time.perf_counter() - t0)
    say("lm_encdec", path="phase_done",
        seconds=time.perf_counter() - t_phase)
    return runs


# ---------------------------------------------------------------------------
# Phase lm_train: qwen3-1.7b trained at full width through the port's
# training entry points (train.build_state_and_step, fault.run_training),
# its checkpoint saved and restored, the float32 parity of a train step,
# examples/train_lm_torch.py's command line.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SEED = 0
#: the global batch of a full-width step: 2 x 2048 tokens (4096 a step)
TRAIN_B, TRAIN_S = 2, 2048
#: 10 steps at lr 1e-3 (warm-up 1 step, then the cosine): at 3e-4 the
#: loss of 10 steps does not move beyond the batches' noise (first five
#: 12.3985, last five 12.3983 on an H100), at 3e-3 it rises; at 1e-3 it
#: falls by ≈ 0.2
TRAIN_STEPS, TRAIN_LR = 10, 1e-3
#: the float32 parity: full width cut to 2 layers, batch 2 x 128
TRAIN_PARITY_REPEATS, TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 2, 128
#: the example's command line (reduced qwen3) and its --compress twin
TRAIN_EXAMPLE_B, TRAIN_EXAMPLE_S = 8, 128
TRAIN_COMPRESS_STEPS = 30
#: device kernels of a train step by kind, the first pattern that matches a
#: kernel's name taking it (:func:`train_groups`)
TRAIN_GROUPS = {
    "rms_norm kernel": r"rmsnorm_(regs|generic)_kernel",
    "flash_attention kernel": r"(fa_tc|flash_attention)_kernel",
    "gemm (cuBLAS)": r"gemm|nvjet|xmma|cutlass|cublas|sm90_",
    "softmax and log-sum-exp": r"softmax|logsumexp",
    "reductions": r"reduce",
    "copies and casts": r"(?i)copy|memcpy|memset|cat_|catarray|fill",
    "index and scatter": r"index|scatter|gather|embedding",
    "elementwise": r"elementwise|vectorized|unrolled",
}


def train_groups(rows) -> dict:
    """Device ms a step of each TRAIN_GROUPS kind, and ``other``, from
    :func:`profile_window`'s rows of every kernel."""
    by_group = dict.fromkeys(list(TRAIN_GROUPS) + ["other"], 0.0)
    for name, ms, _c in rows:
        by_group[next((g for g, pat in TRAIN_GROUPS.items()
                       if re.search(pat, name)), "other")] += ms
    return by_group


def train_rms_per_step(cfg) -> int:
    """RMSNorm launches of a train step's forward: norm1, norm2 (a layer
    with an FFN) and, with q/k norms, q_norm and k_norm (an attention
    layer), then the final norm (the backward is the plain version's
    gradient: no launch)."""
    return cfg.repeats * sum(
        1 + (ffn != "none") + 2 * (cfg.qk_norm and mixer in ("attn", "xattn"))
        for mixer, ffn in cfg.pattern) + 1


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` with an attention mixer: one
    ``flash_attention`` each a step's forward."""
    return cfg.repeats * sum(m in ("attn", "xattn") for m, _f in cfg.pattern)


def train_step_bound(model, B: int, S: int) -> dict:
    """The least time a train step of B x S tokens could take on the card:
    the larger of (a) its operations at the bf16 peak — 6 per weight of a
    product (the forward's 2, the backward's 4) per token, every weight but
    the embedding table (a lookup), plus causal attention's two products
    (2 B S^2 H hd a layer forward, counting half of S^2, and twice that
    backward) — and (b) its bytes at the HBM rate: AdamW reads and writes
    every weight and both float32 moments and reads the gradient (22 bytes
    a bf16 weight), and the head's float32 logits are written and read
    once each way."""
    cfg = model.cfg
    shapes = model.param_shapes()
    n_weights = sum(math.prod(s) for path, (s, _d) in
                    tr.flatten_with_path(shapes)
                    if path[-1] != "tok_embed" and len(s) >= 2)
    n_all = model.param_count()
    attn = 6 * B * S * S * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * n_weights * B * S + attn
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    nbytes = n_all * (3 * elt + 16) + 4 * B * S * cfg.padded_vocab * 3
    ops_ms = flops / FLOPS_PER_S[torch.bfloat16] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, weights_in_products=n_weights,
                attention_flops=attn, bytes=nbytes, ops_ms=ops_ms,
                bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def train_full_width() -> dict:
    """(1) qwen3-1.7b at full width, bf16, all its layers: TRAIN_STEPS
    steps of TRAIN_B x TRAIN_S tokens through ``build_state_and_step`` and
    ``run_training``, the calls ``train.main`` makes, every count at 0 just
    before; each step launches exactly train_rms_per_step RMSNorms and one
    attention a layer; the loss falls. (2) run_training's final checkpoint
    of the state (bf16 weights stored as float32, float32 moments), its
    seconds and bytes, then ``load_checkpoint`` onto the card: every leaf
    bit-equal to the state in memory. (3) One steady step under
    torch.profiler, and its parts timed on their own. Returns the counted
    run."""
    cfg = get_lm_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
    opt = adamw.AdamWConfig(lr=TRAIN_LR,
                            warmup_steps=max(TRAIN_STEPS // 10, 1),
                            total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    model, state, step_fn = ptrain.build_state_and_step(cfg, opt, False,
                                                        seed=TRAIN_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bound = train_step_bound(model, TRAIN_B, TRAIN_S)
    rms, attn = train_rms_per_step(cfg), cfg.n_layers
    last, marks, counts = {}, [], []

    def kept_step(st, batch):
        new, met = step_fn(st, batch)
        last["state"] = new
        return new, met

    def on_metrics(step, _m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())

    def batch_fn(step):
        return batch_at(cfg, shape, step, DataConfig(seed=TRAIN_SEED + 99))

    ckpt_dir = Path(tempfile.mkdtemp(prefix="ws_train_ckpt_"))
    try:
        free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
        reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        out = run_training(
            TrainLoopConfig(total_steps=TRAIN_STEPS,
                            ckpt_every=TRAIN_STEPS + 1,
                            ckpt_dir=str(ckpt_dir)),
            kept_step, state, batch_fn, on_metrics=on_metrics)
        t_end = time.perf_counter()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launched, by_variant = lm_counts_since_reset(
            {"rms_norm": {"row_in_registers": TRAIN_STEPS * rms},
             "flash_attention": {"tc_bf16": TRAIN_STEPS * attn}},
            rms_norm=TRAIN_STEPS * rms, flash_attention=TRAIN_STEPS * attn)
        prev = dict.fromkeys(LM_KERNELS, 0)
        for i, c in enumerate(counts):
            step_counts = {k: c[k] - prev[k] for k in LM_KERNELS}
            if step_counts != {"rms_norm": rms, "flash_attention": attn,
                               "flash_decode": 0}:
                raise AssertionError(f"train step {i} launched "
                                     f"{step_counts}")
            prev = c
        losses = out["losses"]
        first, final = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not (out["final_step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
                and all(math.isfinite(x) for x in losses) and final < first):
            raise AssertionError(f"full-width training: {out}")
        step_s = [b - a for a, b in zip(marks, marks[1:])]
        steady_ms = float(np.median(step_s)) * 1e3
        run = dict(launches=launched, launches_by_variant=by_variant)
        say("lm_train", path="fault.run_training", arch=TRAIN_ARCH,
            layers=cfg.n_layers, params=model.param_count(),
            param_dtype=cfg.param_dtype, batch=TRAIN_B, seq=TRAIN_S,
            tokens_per_step=TRAIN_B * TRAIN_S, steps=TRAIN_STEPS, lr=TRAIN_LR,
            init_seconds=init_s, first_step_ms=(marks[0] - t_start) * 1e3,
            step_ms=[s * 1e3 for s in step_s],
            steady_step_ms=steady_ms,
            tokens_per_second=TRAIN_B * TRAIN_S / (steady_ms / 1e3),
            step_bound=bound,
            share_of_bound=bound["bound_ms"] / steady_ms, peak_gib=peak_gib,
            losses=losses, loss_first5=first, loss_last5=final,
            launches_per_step={"rms_norm": rms, "flash_attention": attn},
            **run, card=card_line())
        # ---- (2) the final checkpoint, restored onto the card -------------
        save_s = t_end - marks[-1]
        stored = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
        final_state = last.pop("state")
        del state
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, back, _ = ckpt_mod.load_checkpoint(ckpt_dir, final_state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = list(zip(tr.flatten_with_path(back),
                         tr.flatten_with_path(final_state)))
        unequal = [p for (p, a), (_q, b) in pairs
                   if not (a.device == b.device and a.dtype == b.dtype
                           and torch.equal(a, b))]
        if step != TRAIN_STEPS - 1 or unequal:
            raise AssertionError(f"checkpoint of step {step}: leaves "
                                 f"{unequal[:5]} differ from the state")
        say("lm_train", path="checkpoint", arch=TRAIN_ARCH,
            leaves=len(pairs), bytes_on_disk=stored,
            gb_on_disk=stored / 1e9, temp_dir_free_gb_before=free_gb,
            save_seconds=save_s, save_gb_per_s=stored / 1e9 / save_s,
            load_seconds=load_s, load_gb_per_s=stored / 1e9 / load_s,
            bit_equal_leaves=len(pairs), card=card_line())
        del back, pairs
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # ---- (3) where a steady step goes ---------------------------------------
    batch = batch_fn(TRAIN_STEPS)

    def run_steps(_first, n):
        st = final_state
        for _ in range(n):
            st, met = step_fn(st, batch)
        return met["loss"]
    prof, rows = profile_window(run_steps, steps=1)
    say("lm_profile", what="train step, full width", arch=TRAIN_ARCH,
        card=card_line(), **prof,
        device_ms_per_step_by_group=train_groups(rows))
    say("lm_train", path="parts of a step", arch=TRAIN_ARCH,
        steady_step_ms=steady_ms, card=card_line(),
        **train_step_parts(model, final_state, batch, opt))
    del final_state
    torch.cuda.empty_cache()
    return run


def train_step_parts(model, state, batch, opt) -> dict:
    """The parts of a full-width train step, each timed on its own with
    CUDA events (:func:`eager_ms`, so their sum need not be the step): the
    forward with autograd recording, forward and backward, AdamW alone
    against its byte bound, one layer's attention gradient (the kernel's
    forward, then the plain version's forward and backward, as the step
    runs it) times the layers, and the head's product with the
    cross-entropy, forward and backward, whose gradients are held against
    the float32 copies' (:func:`head_grad_check`)."""
    cfg = model.cfg
    params, opt_state = state["params"], state["opt"]

    def forward():
        leaves = [p.detach().requires_grad_(True) for p in tr.leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            model.loss_fn(tr.tree_map(lambda _l: next(it), params), batch)
    fwd_ms = eager_ms(forward, 3)
    fwd_bwd_ms = eager_ms(lambda: loss_and_grads(model, params, batch), 3)
    grads = loss_and_grads(model, params, batch)[2]
    adamw_ms = eager_ms(lambda: adamw.apply(opt, params, opt_state, grads),
                        3)
    n = model.param_count()
    adamw_bound_ms = n * 22 / HBM_BYTES_PER_S * 1e3
    del grads
    gen = torch.Generator(device=DEV).manual_seed(TRAIN_SEED + 3)
    B, S, H, KV, hd = TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = [lm_randn(gen, (B, S, h, hd), torch.bfloat16) for h in (H, KV, KV)]
    w = lm_randn(gen, (B, S, H, hd), torch.bfloat16)

    def attention_grad():
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        with torch.enable_grad():
            out = ops.flash_attention(*leaves)
            torch.autograd.grad((out * w).sum(), leaves)
    attn_ms = eager_ms(attention_grad, 3)
    x = lm_randn(gen, (B, S, cfg.d_model), torch.bfloat16)
    head = params["lm_head"]
    labels = batch["labels"]

    def head_grads(product):
        xs, hs = x.clone().requires_grad_(True), head.detach().requires_grad_(
            True)
        with torch.enable_grad():
            loss = softmax_xent(product(xs, hs), labels)
            return torch.autograd.grad(loss, [xs, hs])
    head_ms = eager_ms(lambda: head_grads(logits_f32), 3)
    head_check = head_grad_check(
        head_grads(logits_f32),
        head_grads(lambda a, b: a.float() @ b.float()))
    return dict(forward_ms=fwd_ms, forward_backward_ms=fwd_bwd_ms,
                backward_ms=fwd_bwd_ms - fwd_ms, adamw_ms=adamw_ms,
                adamw_bound_ms=adamw_bound_ms,
                attention_layer_fwd_plain_bwd_ms=attn_ms,
                attention_all_layers_ms=attn_ms * cfg.n_layers,
                head_and_cross_entropy_ms=head_ms,
                head_grads_vs_float32_copies=head_check)


def head_grad_check(got, want) -> dict:
    """The full-width bf16 head's gradients (x's and the head's) through
    ``logits_f32`` on the card against the float32 copies' product's: each
    element within one bf16 step of its own value plus 1e-5 of the largest
    (float32 sums in other orders, then each rounded to bf16)."""
    out = {}
    for name, g, w in zip(("x", "head"), got, want):
        w = w.float()
        diff = (g.float() - w).abs()
        scale = float(w.abs().max())
        ok = bool((diff <= 2 ** -7 * w.abs() + 1e-5 * scale).all())
        out[name] = dict(max_abs_err=float(diff.max()), largest=scale,
                         unequal_share=float((diff > 0).float().mean()))
        if not ok:
            raise AssertionError(f"the head's {name} gradient is off the "
                                 f"float32 copies' by more than one bf16 "
                                 f"step: {out[name]}")
    return out


def train_float32_parity() -> None:
    """The full-width config cut to TRAIN_PARITY_REPEATS layers in float32
    (the same weights on the card and on the CPU, drawn on the card):
    ``loss_and_grads`` — the loss within 1e-5 and every gradient leaf
    within 1e-4 of its largest element of the CPU's plain path; two steps
    of ``build_train_step`` — loss, grad_norm and lr within 1e-4; and
    ``microbatches=2`` against 1 on the card — loss within 1e-5, grad_norm
    within 1e-4 (float32 sums in other orders)."""
    cfg = dataclasses.replace(get_lm_config(TRAIN_ARCH),
                              repeats=TRAIN_PARITY_REPEATS,
                              param_dtype="float32")
    shape = ShapeSpec("parity", TRAIN_PARITY_S, TRAIN_PARITY_B, "train")
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                            total_steps=TRAIN_STEPS)
    gpu = build_lm_model(cfg)
    cpu = build_lm_model(cfg, device="cpu")
    params = gpu.init_params(torch.Generator(device=DEV).manual_seed(
        TRAIN_SEED))
    models = {"cuda": (gpu, params),
              "cpu": (cpu, tr.tree_map(lambda t: t.cpu(), params))}
    batches = {d: [batch_at(cfg, shape, k, device=m.device) for k in range(2)]
               for d, (m, _p) in models.items()}
    t0 = time.perf_counter()
    got = {d: loss_and_grads(m, p, batches[d][0])
           for d, (m, p) in models.items()}
    grad_s = time.perf_counter() - t0
    loss_err = abs(float(got["cuda"][0]) - float(got["cpu"][0]))
    worst = 0.0
    for (path, a), (_q, b) in zip(tr.flatten_with_path(got["cuda"][2]),
                                  tr.flatten_with_path(got["cpu"][2])):
        scale = float(b.abs().max())
        share = float((a.cpu() - b).abs().max()) / (1e-4 * scale)
        worst = max(worst, share)
        if not share <= 1.0:
            raise AssertionError(f"float32 gradient {path}: {share} of "
                                 f"1e-4 x {scale}")
    if not loss_err <= 1e-5 * abs(float(got["cpu"][0])):
        raise AssertionError(f"float32 loss: {got['cuda'][0]} on the card, "
                             f"{got['cpu'][0]} on the CPU")
    del got
    steps = {}
    for d, (m, p) in models.items():
        step = build_train_step(m, opt, device=m.device)
        st, mets = adamw.init(p), []
        for k in range(2):
            p, st, met = step(p, st, batches[d][k])
            mets.append({k_: float(v) for k_, v in met.items()})
        steps[d] = mets
    for a, b in zip(steps["cuda"], steps["cpu"]):
        for key in ("loss", "grad_norm", "lr"):
            if not abs(a[key] - b[key]) <= 1e-4 * abs(b[key]):
                raise AssertionError(f"float32 train step {key}: {a[key]} "
                                     f"on the card, {b[key]} on the CPU")
    mb = {}
    for n_mb in (1, 2):
        step = build_train_step(gpu, opt, microbatches=n_mb)
        mb[n_mb] = {k: float(v) for k, v in
                    step(params, adamw.init(params), batches["cuda"][0])[2]
                    .items()}
    if not (abs(mb[2]["loss"] - mb[1]["loss"]) <= 1e-5 * abs(mb[1]["loss"])
            and abs(mb[2]["grad_norm"] - mb[1]["grad_norm"])
            <= 1e-4 * mb[1]["grad_norm"]):
        raise AssertionError(f"microbatches 2 against 1 on the card: {mb}")
    say("lm_train", path="parity", arch=TRAIN_ARCH, layers=cfg.n_layers,
        params=gpu.param_count(), param_dtype="float32",
        batch=TRAIN_PARITY_B, seq=TRAIN_PARITY_S,
        loss_abs_diff=loss_err, worst_gradient_share_of_tol=worst,
        gradient_tol="1e-4 x max|leaf|", grads_seconds_both=grad_s,
        train_steps={"cuda": steps["cuda"], "cpu": steps["cpu"]},
        microbatches={"1": mb[1], "2": mb[2]}, card=card_line())


def train_example() -> dict:
    """examples/train_lm_torch.py's command line through ``train.main`` on
    the card in a fresh checkpoint directory (reduced qwen3, 200 steps,
    8 x 128, a failure at step 57): one restart, step 200, the loss falling
    (``main`` asserts it); every count at 0 just before, each step run
    (re-run steps included) launching its RMSNorms and attentions. Then a
    reduced ``--compress`` run of TRAIN_COMPRESS_STEPS steps. Returns the
    example's counted run."""
    cfg = get_lm_config(TRAIN_ARCH).reduced()
    rms, attn = train_rms_per_step(cfg), cfg.n_layers
    argv = list(train_lm_torch.ARGV)
    runs = {}
    for name, make_argv in (
            ("example", lambda d: argv[:argv.index("--ckpt-dir") + 1] + [d]
             + argv[argv.index("--ckpt-dir") + 2:]),
            ("compress", lambda d: ["--arch", TRAIN_ARCH, "--reduced",
                                    "--steps", str(TRAIN_COMPRESS_STEPS),
                                    "--batch", str(TRAIN_EXAMPLE_B),
                                    "--seq", str(TRAIN_EXAMPLE_S),
                                    "--lr", "3e-3", "--compress",
                                    "--ckpt-dir", d])):
        with tempfile.TemporaryDirectory(prefix="ws_train_example_") as d:
            reset_all_counts()
            t0 = time.perf_counter()
            out, text = quiet(lambda: ptrain.main(make_argv(d)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = len(out["losses"])
            launched, by_variant = lm_counts_since_reset(
                {}, rms_norm=ran * rms, flash_attention=ran * attn)
            n_steps = TRAIN_COMPRESS_STEPS if name == "compress" else 200
            want_restarts = 0 if name == "compress" else 1
            if out["final_step"] != n_steps or \
                    out["restarts"] != want_restarts:
                raise AssertionError(f"train.main {name}: {out['final_step']}"
                                     f" steps, {out['restarts']} restarts")
            runs[name] = dict(launches=launched,
                              launches_by_variant=by_variant)
            say("lm_train", path=f"train.main {name}", arch=cfg.name,
                argv=make_argv("<tmp>"), steps_run=ran,
                restarts=out["restarts"], final_step=out["final_step"],
                loss_first5=float(np.mean(out["losses"][:5])),
                loss_last5=float(np.mean(out["losses"][-5:])),
                wall_seconds=wall, printed=text.strip().splitlines()[-1],
                **runs[name], card=card_line())
    return runs["example"]


def phase_lm_train() -> dict:
    """Training on the card: qwen3-1.7b at full width with its checkpoint
    and profile (:func:`train_full_width`), the float32 parity of a train
    step (:func:`train_float32_parity`), examples/train_lm_torch.py's
    command line and a compressed run (:func:`train_example`). Returns the
    counted runs by ``LM_PATHS`` key."""
    t0 = time.perf_counter()
    runs = {"train": train_full_width()}
    train_float32_parity()
    torch.cuda.empty_cache()
    runs["train_example"] = train_example()
    say("lm_train", path="phase_done", seconds=time.perf_counter() - t0)
    return runs


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


def l2_bytes() -> int:
    """The card's L2 (50 MB on an H100) where torch reports it."""
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   50 * 2**20)


def cold_sets(make, set_bytes: int) -> list:
    """``make()`` called often enough that the sets' bytes, ``set_bytes``
    each (one call's inputs and output), reach twice the card's L2 (at least
    two sets): a timed call that cycles through them (:func:`rotating`)
    finds in L2 nothing that the calls before it left there, so that its
    time is that of the memory its bound counts."""
    return [make() for _ in range(max(2, -(-2 * l2_bytes() // set_bytes)))]


def rotating(fn, sets: list):
    """A call of ``fn(*set)`` on each of ``sets`` in turn; the outputs of
    the last len(sets) calls stay alive, so that no call writes a buffer
    that a recent call wrote."""
    turn = iter(range(2**62))
    outs = [None] * len(sets)

    def call():
        i = next(turn) % len(sets)
        outs[i] = fn(*sets[i])
    return call


def lm_time_rms(gen, R: int, D: int, reps: int) -> dict:
    """Each call on rows of its own, beyond L2 (:func:`cold_sets`)."""
    dt = torch.bfloat16
    s = lm_randn(gen, (D,), dt)
    # read x and scale, write out; square, add, two multiplies per element
    bound, by, detail = lm_bound((2 * R * D + D) * 2, 4 * R * D, dt)
    xs = cold_sets(lambda: (lm_randn(gen, (R, D), dt, 3.0),), detail["bytes"])
    row = dict(shape=dict(rows=R, D=D, dtype="bfloat16"),
               **lm_times(rotating(lambda x: ops.rms_norm(x, s, 1e-6), xs),
                          rotating(lambda x: rn.rms_norm_ref(x, s, 1e-6), xs),
                          rotating(lambda x: torch.nn.functional.rms_norm(
                              x, (D,), s, 1e-6), xs), reps, reps),
               bound_ms=bound, bound_by=by, bound_detail=detail,
               buffer_sets=len(xs))
    tpr = rn.threads_per_row(R, D, dt)
    variant = (f"row_in_registers, {tpr} threads a row" if tpr
               else "generic")
    return {**row, **lm_rates(row, "rms_norm", (R, D), variant)}


def lm_time_attention(gen, B: int, S: int, reps: int, H: int = 16,
                      KV: int = 8, hd: int = 128, Skv: int = None,
                      causal: bool = True) -> dict:
    """Attention of B x S query tokens over ``Skv`` keys (default S);
    causal unless told; qwen3-1.7b's heads unless given (mixtral-8x7b: 32
    and 8; its window of 4096 masks nothing at S = 2048; phi3-mini-3.8b: 32
    and 32 of 96; whisper-large-v3: 20 and 20 of 64, non-causal, its
    encoder over 1500 frames and its cross-attention; internvl2-76b: 64 and
    8)."""
    dt = torch.bfloat16
    Skv = S if Skv is None else Skv
    # the (q, k) pairs the masks keep
    pairs = S * (S + 1) // 2 if causal else S * Skv
    bound, by, detail = lm_bound(2 * (2 * B * S * H * hd + 2 * B * Skv * KV
                                      * hd), B * H * pairs * 4 * hd, dt)
    sets = cold_sets(lambda: (lm_randn(gen, (B, S, H, hd), dt),
                              lm_randn(gen, (B, Skv, KV, hd), dt),
                              lm_randn(gen, (B, Skv, KV, hd), dt)),
                     detail["bytes"])
    # SDPA's (B, heads, S, hd) layout of the same sets
    tsets = [tuple(t.transpose(1, 2).contiguous() for t in qkv)
             for qkv in sets]
    row = dict(shape=dict(B=B, S=S, Skv=Skv, H=H, KV=KV, hd=hd,
                          dtype="bfloat16", causal=causal),
               **lm_times(
                   rotating(lambda q, k, v: ops.flash_attention(
                       q, k, v, causal=causal), sets),
                   rotating(lambda q, k, v: fa.flash_attention_ref(
                       q, k, v, causal=causal), sets),
                   rotating(lambda q, k, v: torch.nn.functional.
                            scaled_dot_product_attention(
                                q, k, v, is_causal=causal, enable_gqa=True),
                            tsets),
                   reps, 2),
               bound_ms=bound, bound_by=by, bound_detail=detail,
               buffer_sets=len(sets))
    return {**row, **lm_rates(row, "flash_attention", (B, S, H, KV),
                              ATTN_VARIANT[dt])}


def lm_time_decode(gen, B: int, Smax: int, kv_len: int, reps: int,
                   H: int = 16, KV: int = 8, hd: int = 128) -> dict:
    """The kernel with kv_len on the device, as the serving path passes
    it; qwen3-1.7b's heads unless given (mixtral-8x7b: 32 and 8;
    phi3-mini-3.8b: 32 and 32 of 96)."""
    dt = torch.bfloat16
    kv = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
    # q in, the kv_len valid rows of both caches, out
    bound, by, detail = lm_bound(2 * (2 * B * H * hd + 2 * B * kv_len * KV
                                      * hd), B * H * kv_len * 4 * hd, dt)
    sets = cold_sets(lambda: (lm_randn(gen, (B, 1, H, hd), dt),
                              lm_randn(gen, (B, Smax, KV, hd), dt),
                              lm_randn(gen, (B, Smax, KV, hd), dt)),
                     detail["bytes"])
    # SDPA's (B, heads, S, hd) layout of q and the valid rows
    tsets = [(q.transpose(1, 2).contiguous(),
              *(c[:, :kv_len].transpose(1, 2).contiguous() for c in (kc, vc)))
             for q, kc, vc in sets]
    splits, rows = fd.num_splits(B, H, KV, Smax, torch.cuda.
                                 get_device_properties(0).multi_processor_count)
    row = dict(shape=dict(B=B, Smax=Smax, kv_len=kv_len, H=H, KV=KV, hd=hd,
                          dtype="bfloat16", kv_len_on_device=True,
                          splits=splits, rows_per_split=rows),
               **lm_times(
                   rotating(lambda q, kc, vc: ops.flash_decode(q, kc, vc, kv),
                            sets),
                   rotating(lambda q, kc, vc: fd.decode_attention_ref(
                       q, kc, vc, kv_len), sets),
                   rotating(lambda q, k, v: torch.nn.functional.
                            scaled_dot_product_attention(q, k, v,
                                                         enable_gqa=True),
                            tsets), reps, reps),
               bound_ms=bound, bound_by=by, bound_detail=detail,
               buffer_sets=len(sets))
    return {**row, **lm_rates(row, "flash_decode", (B, Smax, H, KV),
                              fd.VARIANTS[splits > 1])}


PROFILE_STEPS = 8      # decode steps in each profiled window
PROFILE_TOP = 25       # kernels by time on a profiled window's line
#: host calls that start device work (kernels, graphs, copies, fills)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|MemcpyAsync|"
                         r"MemsetAsync|LaunchKernelExC)")
#: the traced device kernel that each wrapper's launch runs once (a split
#: flash decode also runs its merge kernel, which is not counted here)
TRACED_KERNEL = {"rms_norm": re.compile(r"rmsnorm_(regs|generic)_kernel"),
                 "flash_attention": re.compile(
                     r"(fa_tc|flash_attention)_kernel"),
                 "flash_decode": re.compile(r"decode_split_kernel")}


#: profiled tries of a window before a trace that lost device records fails
#: the run
PROFILE_TRIES = 3
#: device operations traced, then waited for, before each window: late in a
#: long run the first device records of a trace go missing (two to four a
#: trace on an H100 with torch 2.11), so they fall to these, not the window
LEAD_IN_OPS = 16
LEAD_IN_S = 0.01
WINDOW = "chip_smoke.profile_window"


def window_records(prof) -> tuple:
    """The host calls that start device work (``HOST_LAUNCH``) inside the
    ``WINDOW`` range of a trace, in order, and the device records of each
    (matched by correlation id); the device records that match no such call
    (the trace lost the host side) and began after the lead-in's wait, which
    count as the window's; and the numbers of the lead-in's calls whose
    records were lost and of its records with no call."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    (span,) = [e for e in events
               if e.device_type() != cuda and e.name() == WINDOW]
    calls = sorted((e for e in events if e.device_type() != cuda
                    and HOST_LAUNCH.match(e.name())), key=lambda e: e.start_ns())
    by_corr = {}
    for e in events:
        # the range's own device-side annotation is no device work
        if e.device_type() == cuda and e.name() != WINDOW:
            by_corr.setdefault(e.correlation_id(), []).append(e)
    host = [h for h in calls if span.start_ns() <= h.start_ns() <= span.end_ns()]
    launched = {h.correlation_id() for h in calls}
    # the lead-in's records end before its wait of LEAD_IN_S: half of it
    # parts them from the window's in the trace's time
    cut = span.start_ns() - LEAD_IN_S * 5e8
    orphans = [r for k, recs in by_corr.items() if k not in launched
               for r in recs]
    stray = [r for r in orphans if r.start_ns() >= cut]
    lead_in = dict(lost=sum(1 for h in calls if h.start_ns() < span.start_ns()
                            and h.correlation_id() not in by_corr),
                   without_a_call=len(orphans) - len(stray))
    return host, [by_corr.get(h.correlation_id(), []) for h in host], stray, \
        lead_in


def lost_device_records(host, ran, steps: int = PROFILE_STEPS) -> list:
    """The device records that a window's trace lost. A kernel launch, copy
    or fill must have one record; a graph launch as many as the window's
    fullest replay of that graph, whose kernel names tell which ones a
    shorter replay lost. One dict per lost record: the host call's index in
    the window, its name and the kernel that ran there (for an eager step,
    the kernel of the call at its place in another step)."""
    per_step = len(host) // steps if len(host) % steps == 0 else 0
    fullest = {}
    for h, recs in zip(host, ran):
        if "Graph" in h.name() and len(recs) > len(fullest.get(h.name(), [])):
            fullest[h.name()] = [r.name() for r in recs]
    lost = []
    for i, (h, recs) in enumerate(zip(host, ran)):
        if "Graph" in h.name():
            missing = Counter(fullest[h.name()]) - Counter(r.name()
                                                           for r in recs)
            lost += [dict(call=i, host=h.name(), kernel=k[:80])
                     for k in missing.elements()]
        elif not recs:
            same = [ran[j][0].name() for j in range(i % per_step, len(host),
                                                    per_step)
                    if ran[j]] if per_step else []
            lost.append(dict(call=i, host=h.name(),
                             kernel=same[0][:80] if same else None))
    return lost


def profile_window(run_steps, steps: int = PROFILE_STEPS) -> tuple:
    """torch.profiler over one window of ``steps`` steps (``run_steps(
    first_pos, n)``: serving-path decode steps, or train steps): device time
    by kernel against the window's own wall time, the device operations
    and the host's launch calls a step, and the PROFILE_TOP kernels by time.
    Returns that summary and every kernel's (name, ms a step, launches in
    the window), slowest first. The profiler adds host time of its own, so
    the window's unprofiled twin (the next ``steps`` steps) is timed beside
    it.

    The launches that the wrappers counted in the window must be the
    kernels the trace saw run, wrapper by wrapper (``TRACED_KERNEL``): for
    a replayed graph the counts are the capture's times the replays, and
    the trace shows that every replay ran them. The window is the trace's
    ``WINDOW`` range, after a lead-in of LEAD_IN_OPS operations whose lost
    records are counted on the line (``lead_in_records_lost``); a device
    record whose host call the trace lost counts as the window's if it began
    after the lead-in (``window_records_without_a_call``). The
    comparison is made on a window that lost no device record
    (:func:`lost_device_records`): one that lost some is profiled again, up
    to PROFILE_TRIES times, and the records each try lost are on the line."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    lead = torch.zeros(1, device=DEV)
    lost_by_try, lead_in_lost = [], []
    for _try in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        before = (ops.launch_counts(), ops.variant_counts())
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(LEAD_IN_OPS):
                lead.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(LEAD_IN_S)
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                logits = run_steps(3, steps)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(LEAD_IN_S)
        counted = ops.counts_since(before)[0]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("profiled steps: non-finite output")
        host, ran, stray, lead_in = window_records(prof)
        lead_in_lost.append(lead_in)
        lost = lost_device_records(host, ran, steps)
        if not lost:
            break
        lost_by_try.append(lost[:8] + [{"lost": len(lost)}])
    else:
        raise AssertionError(f"every one of {PROFILE_TRIES} traces of the "
                             f"window lost device records: {lost_by_try}")
    # device-side records only (kernels, copies, fills): an operator's own
    # row would count its kernels' time a second time
    by_name = {}
    for recs in ran + [stray]:
        for r in recs:
            ms, c = by_name.get(r.name(), (0.0, 0))
            by_name[r.name()] = (ms + r.duration_ns() / 1e6, c + 1)
    rows = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    traced = {fn: sum(c for key, _ms, c in rows if pat.search(key))
              for fn, pat in TRACED_KERNEL.items()}
    if traced != counted:
        raise AssertionError(f"the trace ran {traced} kernel launches, the "
                             f"wrappers counted {counted}")
    device_ms = sum(r[1] for r in rows)
    host_calls = dict(Counter(h.name() for h in host))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(3 + steps, steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    n = steps
    summary = dict(steps=n, wall_ms_per_step_profiled=wall_ms / n,
                   wall_ms_per_step=plain_wall_ms / n,
                   device_ms_per_step=device_ms / n if rows
                   else "not measured",
                   # one window: its traced device time over its own wall time
                   device_idle_share=(1 - device_ms / wall_ms) if rows
                   else "not measured",
                   device_idle_share_unprofiled=(1 - device_ms / plain_wall_ms)
                   if rows else "not measured",
                   kernel_launches_per_step=sum(r[2] for r in rows) / n,
                   traced_wrapper_launches_equal_the_counts=traced,
                   traces_that_lost_device_records=lost_by_try,
                   lead_in_records_lost=lead_in_lost,
                   window_records_without_a_call=[r.name()[:80]
                                                  for r in stray],
                   host_launch_calls_per_step=sum(host_calls.values()) / n,
                   host_launch_calls=host_calls,
                   top=[dict(name=n_[:80], ms_per_step=ms / n, count=c)
                        for n_, ms, c in rows[:PROFILE_TOP]])
    return summary, [(n_, ms / n, c) for n_, ms, c in rows]


def lm_profile_decode_steps(model, params, tok) -> dict:
    """Where a decode step's time goes (full width, bf16, the batch of
    phase lm_main_path, tokens ``tok`` (B, 1) at every step): a window of
    eager steps, every launch from Python, and a window of replays of the
    step's CUDA graph, as decode_batch runs them."""
    B, S = tok.shape[0], SERVE_PROMPT + SERVE_NEW
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
        out[name], _rows = profile_window(run_steps)
        del step, cache
    return out


#: the counted runs of the LM phases, as (key of their dicts, path in the
#: kernels line)
LM_PATHS = (("serve", "serve.decode_batch"),
            ("prefill", "steps.build_prefill_step"),
            ("moe_serve", f"serve.decode_batch {MOE_ARCH}"),
            ("moe_prefill", f"steps.build_prefill_step {MOE_ARCH}"),
            ("xlstm_serve", f"serve.decode_batch {XLSTM_ARCH}"),
            ("xlstm_prefill", f"steps.build_prefill_step {XLSTM_ARCH}"),
            ("jamba_serve", f"serve.decode_batch {JAMBA_ARCH}"),
            ("jamba_prefill", f"steps.build_prefill_step {JAMBA_ARCH}"),
            ("phi3_serve", f"serve.decode_batch {PHI3_ARCH}"),
            ("phi3_prefill", f"steps.build_prefill_step {PHI3_ARCH}"),
            ("whisper_serve", f"serve.prefill_and_greedy_steps {WHISPER_ARCH}"),
            ("whisper_prefill", f"steps.build_prefill_step {WHISPER_ARCH}"),
            ("internvl_serve",
             f"serve.prefill_and_greedy_steps {INTERNVL_ARCH}"),
            ("internvl_prefill", f"steps.build_prefill_step {INTERNVL_ARCH}"),
            ("train", f"fault.run_training {TRAIN_ARCH}"),
            ("train_example", "train.main examples/train_lm_torch.py"))


def phase_lm_timing(main: dict) -> list:
    """Each kernel at the main paths' shapes (qwen3-1.7b's first, then
    mixtral-8x7b's, phi3-mini-3.8b's, whisper-large-v3's and
    internvl2-76b's), the fixed cost of a launch in a graph, qwen3-1.7b's
    decode profile; returns the kernels line's LM entries. ``main``: the
    counted runs of the LM phases (``LM_PATHS``)."""
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 1)
    serve_kv = SERVE_PROMPT + SERVE_NEW
    ivl_rows = served_cache_rows(INTERNVL_ARCH)
    H, KV = MOE_HEADS
    shapes = {
        "rms_norm": [lm_time_rms(gen, PREFILL_B * PREFILL_S, 2048, 50),
                     lm_time_rms(gen, PREFILL_B * PREFILL_S * 16, 128, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 2048, 200),
                     lm_time_rms(gen, PREFILL_B * PREFILL_S, 4096, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 4096, 200),
                     # phi3-mini-3.8b's width (the generic kernel before
                     # this slice)
                     lm_time_rms(gen, PREFILL_B * PREFILL_S, 3072, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 3072, 200),
                     # xlstm-350m's width
                     lm_time_rms(gen, SERVE_REQUESTS, 1024, 200),
                     # whisper-large-v3's and internvl2-76b's widths
                     lm_time_rms(gen, PREFILL_B * PREFILL_S, 1280, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 1280, 200),
                     lm_time_rms(gen, PREFILL_B * PREFILL_S, 8192, 50),
                     lm_time_rms(gen, SERVE_REQUESTS, 8192, 200),
                     # lm_train's full-width step
                     lm_time_rms(gen, TRAIN_B * TRAIN_S, 2048, 50),
                     # a rank's rows in phase mesh's sharded prefill and
                     # train step on the 2 x 2 mesh (B/2 x S/2)
                     lm_time_rms(gen, PREFILL_B * PREFILL_S // 4, 2048, 50),
                     lm_time_rms(gen, TRAIN_B * TRAIN_S // 4, 2048, 50),
                     # a rank's rows in step moe's (mixtral's width)
                     lm_time_rms(gen, PREFILL_B * PREFILL_S // 4, 4096, 50),
                     lm_time_rms(gen, TRAIN_B * TRAIN_S // 4, 4096, 50),
                     # step recurrent's: xlstm's width on world 1's prefill
                     # rows and on a 2 x 2 rank's (B/2 x its sequence)
                     lm_time_rms(gen, PREFILL_B * PREFILL_S, 1024, 50),
                     lm_time_rms(gen, PREFILL_B // 2 * MESH_REC_W4_XLSTM_S,
                                 1024, 50)],
        "flash_attention": [lm_time_attention(gen, PREFILL_B, PREFILL_S, 10),
                            lm_time_attention(gen, PREFILL_B, PREFILL_S, 10,
                                              H, KV),
                            lm_time_attention(gen, PREFILL_B, PREFILL_S, 10,
                                              *PHI3_HEADS, hd=96),
                            # Whisper's encoder and cross-attention
                            lm_time_attention(gen, PREFILL_B, WHISPER_FRAMES,
                                              10, *WHISPER_HEADS, hd=64,
                                              causal=False),
                            lm_time_attention(gen, PREFILL_B, PREFILL_S, 10,
                                              *WHISPER_HEADS, hd=64,
                                              Skv=WHISPER_FRAMES,
                                              causal=False),
                            # Whisper's decoder self-attention; InternVL's
                            # G = 8 over its patch rows and text
                            lm_time_attention(gen, PREFILL_B, PREFILL_S, 10,
                                              *WHISPER_HEADS, hd=64),
                            lm_time_attention(gen, PREFILL_B,
                                              internvl_prefill_rows(), 10,
                                              *INTERNVL_HEADS),
                            # lm_train's full-width step
                            lm_time_attention(gen, TRAIN_B, TRAIN_S, 10),
                            # a rank's heads in phase mesh's sharded
                            # prefill and train step on the 2 x 2 mesh
                            lm_time_attention(gen, PREFILL_B // 2, PREFILL_S,
                                              10, 16 // 2, 8 // 2),
                            lm_time_attention(gen, TRAIN_B // 2, TRAIN_S,
                                              10, 16 // 2, 8 // 2),
                            # a rank's heads in step moe's (mixtral's)
                            lm_time_attention(gen, PREFILL_B // 2, PREFILL_S,
                                              10, H // 2, KV // 2),
                            lm_time_attention(gen, TRAIN_B // 2, TRAIN_S,
                                              10, H // 2, KV // 2)],
        "flash_decode": [lm_time_decode(gen, SERVE_REQUESTS, serve_kv,
                                        serve_kv, 200),
                         lm_time_decode(gen, SERVE_REQUESTS, 2048, 2048, 50),
                         lm_time_decode(gen, 1, 32768, 32768, 50),
                         lm_time_decode(gen, SERVE_REQUESTS, serve_kv,
                                        serve_kv, 200, H, KV),
                         lm_time_decode(gen, SERVE_REQUESTS, serve_kv,
                                        serve_kv, 200, *PHI3_HEADS, hd=96),
                         lm_time_decode(gen, 1, 32768, 32768, 50,
                                        *PHI3_HEADS, hd=96),
                         # Whisper's cross cache and self-attention
                         # cache; InternVL's serving cache at the mean
                         # kv_len of a replayed text step
                         lm_time_decode(gen, SERVE_REQUESTS, WHISPER_FRAMES,
                                        WHISPER_FRAMES, 200, *WHISPER_HEADS,
                                        hd=64),
                         lm_time_decode(gen, SERVE_REQUESTS, serve_kv,
                                        serve_kv, 200, *WHISPER_HEADS,
                                        hd=64),
                         lm_time_decode(gen, SERVE_REQUESTS, ivl_rows,
                                        internvl_mean_kv_len(), 200,
                                        *INTERNVL_HEADS)],
    }
    for kernel, rows in shapes.items():
        for r in rows:
            say("lm_timing", kernel=kernel, card=card_line(), **r)
    # the fixed cost of one launch inside a replayed graph: a kernel that
    # writes one element
    one = torch.zeros(1, device=DEV)
    say("lm_timing", kernel="one-element fill (Tensor.fill_)",
        ms=graph_ms(lambda: one.fill_(1.0), 200), card=card_line())
    model = build_lm_model(get_lm_config(LM_ARCH))
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(LM_SEED))
    tok = torch.zeros((SERVE_REQUESTS, 1), dtype=torch.int64, device=DEV)
    for window, profile in lm_profile_decode_steps(model, params,
                                                   tok).items():
        say("lm_profile", what=f"decode steps, serving path, {window}",
            arch=LM_ARCH, card=card_line(), **profile)
    del model, params
    entries = []
    for kernel, rows in shapes.items():
        head = rows[0]          # the main path's shape (prefill; decode: a)
        by_path = {path: main[key]["launches"][kernel]
                   for key, path in LM_PATHS}
        entries.append({
            "name": kernel, "route": "cuda", "source": LM_SOURCES[kernel],
            "replaces": LM_REPLACES[kernel],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_by_variant": {
                path: main[key]["launches_by_variant"].get(kernel)
                for key, path in LM_PATHS},
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

    def count(name):
        return subprocess.run([str(cuobjdump), "-sass",
                               str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.count("HGMMA")
    # one cuobjdump a library, all at once
    with ThreadPoolExecutor() as pool:
        counts = dict(zip(_build.sources(), pool.map(count,
                                                     _build.sources())))
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


# ---------------------------------------------------------------------------
# Phase mesh: the mesh-sharded sweep and context-parallel decode, on a world
# of one NCCL rank, then on four gloo ranks sharing the card.
# ---------------------------------------------------------------------------

#: rows cut from the end of each main path's first sweep for the sharded
#: runs, so that no row count is a multiple of the four ranks
MESH_TRIM = 3
#: context-parallel decode of the served model: the cache's sequence over
#: "model", the batch over "data" (decode_32k's split)
MESH_CP = (("model",), ("data",))
#: one layer's context-parallel attention at long_500k's split: (B, S, H,
#: KV, hd), the sequence over ("data", "model")
MESH_ATTN = (1, 32768, 16, 8, 128)
MESH_TIMEOUT_S = 420


def mesh_sweeps() -> dict:
    """Each main path's first sweep as (model, rows, remote_prob), its last
    MESH_TRIM rows cut."""
    out = {}
    for path, spec in MAIN_PATHS.items():
        s = spec["sweeps"][0]
        kw = s["kw"]
        rows = sw.grid_rows(kw.get("W_list", (0,)), kw["lam_list"],
                            kw["reps"])
        out[path] = (sweep_model(s), rows.slice(0, len(rows) - MESH_TRIM),
                     s["topo"]().remote_prob)
    return out


def grid_npz(g: sw.GridResult) -> dict:
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name not in ("p", "extras")}
    out.update({"extras/" + k: np.asarray(v) for k, v in g.extras.items()})
    return out


def same_grid(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{what}: fields {sorted(got)} != "
                             f"{sorted(want)}")
    for f, v in want.items():
        if got[f].dtype != v.dtype or not np.array_equal(got[f], v):
            raise AssertionError(f"{what}: {f} differs")


def mesh_sharded_sweeps(mesh, world: int, out: Path, ref: Path) -> dict:
    """Each path's sweep through ``run_rows(mesh=, shard_axes=("data",
    "model"))`` on the card, every count at 0 just before and read just
    after; world 1 writes its fields (and holds them to the unsharded
    ``run_rows``), world 4 holds every field to world 1's."""
    line = {}
    for path, (model, rows, rp) in mesh_sweeps().items():
        body = MAIN_PATHS[path]["body"]
        ws.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = sw.run_rows(model, rows, remote_prob=rp, mesh=mesh,
                        shard_axes=("data", "model"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ws.ws_sim_cuda.launches_by_body)
        if launches != {**dict.fromkeys(launches, 0), body: 1}:
            raise AssertionError(f"mesh {path}: launches {launches}, "
                                 f"expected one of {body}")
        fields = grid_npz(g)
        if world == 1:
            plain = grid_npz(sw.run_rows(model, rows, remote_prob=rp))
            same_grid(fields, plain, f"mesh {path} against run_rows()")
            np.savez(out / f"sweep_{path}.npz", **fields)
        else:
            same_grid(fields, dict(np.load(ref / f"sweep_{path}.npz")),
                      f"mesh {path} world {world} against world 1")
        line[path] = dict(rows=len(rows), wall_seconds=wall,
                          rows_per_second=len(rows) / wall,
                          launches_by_body=launches,
                          rows_this_rank=-(-len(rows) // world))
    return line


def forced_logits(model, params, prompts, forced, step, cache=None) -> list:
    """The logits each new token is chosen from, under teacher forcing: the
    prompt's last step's, then each step's on the forced token before
    (``forced``, (B, new)); ``step`` runs every step (``cache``: a
    context-parallel step's shard). A list of ``new`` (B, Vpad) float32."""
    S, new = prompts.shape[1], forced.shape[1]
    cache, logits = model.prefill(params, {"tokens": prompts},
                                  max_seq=S + new, step=step, cache=cache)
    out = [logits[:, -1].clone()]
    for i in range(new - 1):
        logits, cache = step(params, cache, forced[:, i:i + 1], S + i)
        out.append(logits[:, -1].clone())
    return out


@contextmanager
def one_shard_attention():
    """The serving path's decode attention swapped, for the length of the
    block, for the context-parallel partials' arithmetic on one shard
    holding the whole cache (``attention.decode_attention_partial``,
    float64, normalized as ``merge_partial_attention`` normalizes). On a
    world of one rank the merge's maximum and sums change nothing, so a
    step without a mesh run so gives the context-parallel step's logits
    bit for bit: the witness that what the context-parallel step changes
    against the served step is the attention's arithmetic, float64 against
    ``flash_decode``'s, and not the split, the owner's write or the
    collectives."""
    from repro_torch.models import attention as attn_mod

    def one_shard(q, k_cache, v_cache, kv_len, *, window=0):
        o, _m, l = attn_mod.decode_attention_partial(
            q, k_cache, v_cache, 0, kv_len, window=window)
        return (o / torch.clamp(l, min=1e-30)[..., None])[:, None] \
            .to(q.dtype)

    served = attn_mod.decode_attention
    attn_mod.decode_attention = one_shard
    try:
        yield
    finally:
        attn_mod.decode_attention = served


def mesh_cp_decode(mesh, world: int, work: Path) -> dict:
    """qwen3-1.7b at full width serving the lm_main_path requests with the
    KV cache's sequence over "model" and the batch over "data".

    World 1 (NCCL; each step replays one CUDA graph, the merge's
    all-reduces captured in it) runs, under teacher forcing on
    lm_main_path's tokens and then greedily: the served step without
    context parallelism (its forced argmax and its tokens must be
    lm_main_path's), the context-parallel step, and the step without a
    mesh whose attention is the partials' arithmetic on one shard
    (:func:`one_shard_attention`), whose logits and tokens must equal the
    context-parallel step's bit for bit. The context-parallel logits'
    distance from the served step's and its tokens equal to lm_main_path's
    are recorded, not bounded: the witness accounts for them. It writes its
    forced logits and tokens for world 4.

    World 4 (gloo, on the host; eager steps, each rank its 12 requests and
    its half of the sequence) must give world 1's forced logits for its
    requests and world 1's tokens, bit for bit: the float64 partials round
    alike however the cache is split (``attention.PARTIAL_DTYPE``)."""
    from repro_torch.launch import mesh as ml
    ref_lm = np.load(work / "lm_tokens.npz")
    cfg = get_lm_config(LM_ARCH)
    model = build_lm_model(cfg)
    params, _ = init_weights(model, LM_SEED)
    reqs = [Request(uid=i, prompt=p, max_new=SERVE_NEW)
            for i, p in enumerate(ref_lm["prompts"])]
    steps = SERVE_PROMPT + SERVE_NEW
    norms = 4 * cfg.n_layers + 1
    cp_kw = dict(cp_axes=MESH_CP, mesh=mesh)
    # ---- teacher forcing: this rank's requests ---------------------------
    rows = SERVE_REQUESTS // ml.axis_size(mesh, *MESH_CP[1])
    lo = ml.shard_index(mesh, MESH_CP[1]) * rows
    prompts = torch.as_tensor(ref_lm["prompts"][lo:lo + rows],
                              dtype=torch.int64, device=DEV)
    forced = torch.as_tensor(ref_lm["tokens"][lo:lo + rows],
                             dtype=torch.int64, device=DEV)
    shard = model.init_cache(rows, steps // ml.axis_size(mesh, *MESH_CP[0]))

    def forced_run(step, cache=None):
        return torch.stack(forced_logits(model, params, prompts, forced,
                                         step, cache))

    line = {}
    if world == 1:
        cp = forced_run(GraphedDecodeStep(model, **cp_kw), shard)
        plain = forced_run(GraphedDecodeStep(model))
        if not torch.equal(plain.argmax(-1), forced.T):
            raise AssertionError("mesh: the plain step's forced tokens are "
                                 "not lm_main_path's")
        with one_shard_attention():
            one = forced_run(GraphedDecodeStep(model))
        if not torch.equal(one, cp):
            raise AssertionError(
                f"mesh: the context-parallel logits are not the one-shard "
                f"step's: {float((one - cp).abs().max())} apart")
        d = float((cp - plain).abs().max())
        line["forced"] = dict(
            steps=SERVE_NEW, rows=rows, cp_equal_to_one_shard=True,
            cp_vs_plain_max_abs=d,
            cp_vs_plain_share_of_max_logit=d / float(plain.abs().max()),
            cp_argmax_equal_to_plain=int((cp.argmax(-1) ==
                                          plain.argmax(-1)).sum()))
        np.save(work / "cp_forced_logits.npy", cp.cpu().numpy())
        del plain, one
    else:
        def cp_step(params, cache, tok, pos, embeds=None):
            return model.decode_step(params, cache, tok, pos, embeds,
                                     **cp_kw)
        cp = forced_run(cp_step, shard)
        want = torch.from_numpy(np.ascontiguousarray(np.load(
            work / "cp_forced_logits.npy", mmap_mode="r")[:, lo:lo + rows]
        )).to(DEV)
        if not torch.equal(cp, want):
            raise AssertionError(
                f"mesh world {world}: the forced logits of requests "
                f"{lo}-{lo + rows - 1} are not world 1's: "
                f"{float((cp - want).abs().max())} apart")
        line["forced"] = dict(steps=SERVE_NEW, rows=rows,
                              equal_to_world1=True)
        del want
    del cp, shard
    # ---- the served runs, counted ----------------------------------------
    runs = (("cp", cp_kw, False),)
    if world == 1:
        runs = (("plain", {}, False),) + runs + (("one_shard", {}, True),)
    for name, kw, witness in runs:
        with one_shard_attention() if witness else contextlib.nullcontext():
            if world == 1:
                decode_batch(model, params, reqs, **kw)            # warm
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = decode_batch(model, params, reqs, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counted = {"rms_norm": {"row_in_registers": steps * norms}}
        attn = {}
        if name == "plain":
            counted["flash_decode"] = {"single": steps * cfg.n_layers}
            attn = {"flash_decode": steps * cfg.n_layers}
        counts, _ = lm_counts_since_reset(counted, rms_norm=steps * norms,
                                          **attn)
        if name == "plain" and not np.array_equal(tokens, ref_lm["tokens"]):
            raise AssertionError("mesh: the plain decode's tokens differ "
                                 "from lm_main_path's")
        if name == "cp" and world == 1:
            np.save(work / "cp_tokens.npy", tokens)
        if name != "plain":
            want = np.load(work / "cp_tokens.npy")
            if not np.array_equal(tokens, want):
                raise AssertionError(
                    f"mesh world {world} {name}: tokens differ from world "
                    f"1's context-parallel tokens in "
                    f"{int((tokens != want).sum())} places")
        run = dict(tokens_equal_to_lm_main_path=int(
            (tokens == ref_lm["tokens"]).sum()), tokens=int(tokens.size),
            wall_seconds=wall, launches=counts)
        graph = decode_batch.last_graph
        run["graph"] = graph is not None
        if graph is not None:
            if graph["replays"] != steps - 1:
                raise AssertionError(f"mesh decode {name}: {graph}")
            replayed = wall - graph["warmup_seconds"] - \
                graph["capture_seconds"]
            run["ms_per_replayed_step"] = replayed / graph["replays"] * 1e3
        else:
            run["ms_per_eager_step"] = wall / steps * 1e3
        line[name] = run
    del params
    torch.cuda.empty_cache()
    return line


def mesh_cp_attention(mesh) -> dict:
    """One layer's attention at MESH_ATTN, the cache split four ways over
    ("data", "model"), the new row written by its owner at the last
    position: equal bit for bit to the one-shard arithmetic over the whole
    cache (:func:`one_shard_attention`), and against flash_decode on the
    whole cache within the bf16 tolerance."""
    from repro_torch.launch import mesh as ml
    from repro_torch.models import attention as attn_mod
    B, S, H, KV, hd = MESH_ATTN
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 7)
    q = lm_randn(gen, (B, 1, H, hd), torch.bfloat16)
    kc = lm_randn(gen, (B, S, KV, hd), torch.bfloat16)
    vc = lm_randn(gen, (B, S, KV, hd), torch.bfloat16)
    kn = lm_randn(gen, (B, 1, KV, hd), torch.bfloat16)
    vn = lm_randn(gen, (B, 1, KV, hd), torch.bfloat16)
    cp = ("data", "model")
    n = ml.axis_size(mesh, *cp)
    i, rows = ml.shard_index(mesh, cp), S // n
    kl, vl = (c[:, i * rows:(i + 1) * rows].clone() for c in (kc, vc))
    pos = torch.full((1,), S - 1, dtype=torch.int64, device=DEV)
    f = attn_mod.make_cp_decode_attention(cp, (), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, kl, vl = f(q, kl, vl, kn, vn, pos, (pos + 1).int())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kc[:, S - 1:], vc[:, S - 1:] = kn, vn
    with one_shard_attention():
        one = attn_mod.decode_attention(q, kc, vc, pos + 1)
    if not torch.equal(out, one):
        raise AssertionError(f"cp attention {MESH_ATTN}: the merged output "
                             f"is not one shard's: "
                             f"{float((out - one).abs().max())} apart")
    want = ops.flash_decode(q, kc, vc, S)
    case = lm_compare("flash_decode", out, want,
                      LM_TOL[("attention", torch.bfloat16)],
                      f"cp attention {MESH_ATTN} over {cp}",
                      kernel_output=False)
    owner = i == n - 1
    if owner and not (torch.equal(kl[:, -1:], kn)
                      and torch.equal(vl[:, -1:], vn)):
        raise AssertionError("cp attention: the owner did not write the row")
    return dict(case, shard_rows=rows, owner_of_the_new_row=owner,
                equal_to_one_shard=True, seconds=seconds)


#: phase mesh's prefill: qwen3-1.7b at full width on a PREFILL_B x
#: PREFILL_S prompt drawn from this seed, its weights laid out by the
#: placement rules (TP on "model", FSDP on "data", sequence parallelism)
MESH_PREFILL_SEED = LM_SEED + 11
#: the leaves the rules leave whole: the norms
MESH_WHOLE_LEAVES = {"final_norm", "norm1", "norm2", "q_norm", "k_norm"}


def prefill_collectives(cfg, model_size: int, sp: bool) -> dict:
    """PERF.md's count of a sharded prefill of an attention / dense stack
    of L layers: per layer 7 FSDP gathers (wq, wk, wv, wo, w_gate, w_up,
    w_down), 5 column and 2 row products, 2 sequence gathers and 2
    reduce-scatters with SP (2 all-reduces without), 2 head gathers (k, v)
    where KV % |model| != 0; per step the embedding's and the head's FSDP
    gathers, the embedding's reduce-scatter (all-reduce), and with SP the
    last position's broadcast."""
    L = cfg.n_layers
    cut = cfg.n_kv_heads % model_size != 0
    calls = dict(fsdp_gather=7 * L + 2, column=5 * L, row=2 * L,
                 sp_gather=2 * L if sp else 0,
                 head_gather=2 * L if cut else 0, embed=1, head=1,
                 last_position=1, moe=0)
    collectives = dict(
        all_gather=calls["fsdp_gather"] + calls["sp_gather"]
        + calls["head_gather"],
        reduce_scatter=2 * L + 1 if sp else 0,
        all_reduce=0 if sp else 2 * L + 1, broadcast=1 if sp else 0,
        all_to_all=0)
    return {"calls": calls, "collectives": collectives}


def mesh_prefill(mesh, world: int, work: Path) -> dict:
    """qwen3-1.7b at full width prefilling a PREFILL_B x PREFILL_S prompt
    with each rank holding only its shards of the weights
    (``sharding.local_params``), its rows of the batch (``shard_batch``)
    and the step's collectives issued by ``launch/partition.py``.

    Each rank holds its shard bytes (the placement rules' ``shard_shape``
    summed over the leaves) and only the norms whole. Each sharded step
    (bf16, then the same weights in float32) is counted on its own: every
    count at 0 just before, and just after one ``rms_norm`` per norm
    (``row_in_registers``) and one ``flash_attention`` a layer (the
    dtype's variant), and the collectives of :func:`prefill_collectives`.
    World 1 (NCCL, 1 x 1; every collective a real NCCL call over a group
    of one): the bf16 logits equal the unsharded ``build_prefill_step``'s
    bit for bit; each step's ms beside the unsharded one's; it writes its
    bf16 and float32 logits for world 4. World 4 (gloo, 2 x 2: the batch
    on "data", heads, columns and the sequence on "model"): the float32
    logit shard within 1e-3·max|logit| + 1e-3 of world 1's matching
    slice; the bf16 distance and equal argmax tokens recorded, not
    bounded; each step's seconds and the rank's peak memory."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_act_constrainer
    cfg = get_lm_config(LM_ARCH)
    model = build_lm_model(cfg)
    params, _ = init_weights(model, LM_SEED)
    tokens = torch.as_tensor(np.random.default_rng(MESH_PREFILL_SEED).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), dtype=torch.int64,
        device=DEV)
    batch = {"tokens": tokens}
    line = dict(batch=PREFILL_B, seq=PREFILL_S, mesh=ml.mesh_shape(mesh),
                layers=cfg.n_layers)

    def timed(step, p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(p, batch)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    if world == 1:
        plain = build_prefill_step(model)
        timed(plain, params)                                    # warm
        want, seconds = timed(plain, params)
        line["unsharded_ms"] = seconds * 1e3
    shardings = shd.shard_params(model.param_shapes(), mesh)
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in tr.leaves(params))
    lp = shd.local_params(params, shardings, mesh)
    whole = {path[-1] for (path, a), b in zip(tr.flatten_with_path(lp),
                                               tr.leaves(params)) if a is b}
    if world > 1:
        del params
    torch.cuda.empty_cache()
    local_bytes = sum(t.numel() * t.element_size() for t in tr.leaves(lp))
    want_bytes = shd.shard_bytes(model.param_shapes(), shardings)
    if local_bytes != want_bytes or whole != MESH_WHOLE_LEAVES:
        raise AssertionError(f"mesh prefill: the rank holds {local_bytes} "
                             f"bytes against its shards' {want_bytes}, "
                             f"whole leaves {sorted(whole)}")
    line["weights"] = dict(local_bytes=local_bytes, whole_bytes=whole_bytes,
                           share=local_bytes / whole_bytes,
                           whole_leaves=sorted(whole))
    batch = shard_batch(batch, mesh)
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=True)
    formula = prefill_collectives(cfg, ml.mesh_shape(mesh)["model"], True)
    rows = PREFILL_B // ml.axis_size(mesh, "data")
    vocab = cfg.padded_vocab // ml.axis_size(mesh, "model")
    lo_b = ml.coordinate(mesh)["data"] * rows
    lo_v = ml.coordinate(mesh)["model"] * vocab

    def counted(model_, p, dtype):
        step = build_prefill_step(model_, act_spec=act)
        logits, run = counted_mesh_step(step, (p, batch), cfg, dtype,
                                        formula, f"mesh prefill {dtype}")
        if logits.shape != (rows, 1, vocab) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"mesh prefill {dtype}: logits "
                                 f"{tuple(logits.shape)} {logits.dtype} "
                                 "or not finite")
        run["seconds"] = run.pop("ms") / 1e3
        run["collectives"] = formula["collectives"]
        if world == 1:
            _again, again_s = timed(step, p)
            run["ms"] = again_s * 1e3
        return logits, run

    got, line["bf16"] = counted(model, lp, torch.bfloat16)
    if world == 1:
        if not torch.equal(got, want):
            raise AssertionError(
                f"mesh prefill world 1: the sharded bf16 logits are not the "
                f"unsharded step's: {float((got - want).abs().max())} apart")
        line["bf16"]["equal_to_unsharded"] = True
        np.save(work / "prefill_bf16.npy", got.cpu().numpy())
        del want, params
    else:
        ref = torch.from_numpy(np.load(work / "prefill_bf16.npy")[
            lo_b:lo_b + rows, :, lo_v:lo_v + vocab]).to(DEV)
        line["bf16"]["vs_world1_max_abs"] = float((got - ref).abs().max())
        line["bf16"]["vs_world1_share_of_max_logit"] = \
            line["bf16"]["vs_world1_max_abs"] / float(ref.abs().max())
        line["bf16"]["argmax_equal_to_world1"] = int(
            (got.argmax(-1) == ref.argmax(-1)).sum())
        line["bf16"]["rows"] = rows
    # float32: the same weights, each shard cast (exact)
    model32 = build_lm_model(dataclasses.replace(cfg, param_dtype="float32"))
    lp32 = tree_to(lp, torch.float32)
    del lp
    torch.cuda.empty_cache()
    got32, line["float32"] = counted(model32, lp32, torch.float32)
    if world == 1:
        plain32, seconds = timed(build_prefill_step(model32), lp32)
        line["float32"]["unsharded_ms"] = seconds * 1e3
        line["float32"]["equal_to_unsharded"] = bool(torch.equal(got32,
                                                                 plain32))
        np.save(work / "prefill_f32.npy", got32.cpu().numpy())
    else:
        ref = torch.from_numpy(np.load(work / "prefill_f32.npy")[
            lo_b:lo_b + rows, :, lo_v:lo_v + vocab]).to(DEV)
        tol = 1e-3 * float(ref.abs().max()) + 1e-3
        err = float((got32 - ref).abs().max())
        if not err <= tol:
            raise AssertionError(f"mesh prefill world {world}: float32 "
                                 f"logits {err} from world 1's, limit {tol}")
        line["float32"].update(vs_world1_max_abs=err, tol=tol,
                               share_of_tol=err / tol)
    del lp32
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# Phase mesh, step train: the sharded train step
# ---------------------------------------------------------------------------

#: world 1 trains qwen3-1.7b whole (28 layers, bf16) at lm_train's shape
#: for this many steps through run_training(state_shardings=)
MESH_TRAIN_STEPS = 3
#: world 4 trains it at full width cut to this many of its 28 layers (the
#: vocabulary's 0.62 B weights, whole in width, are most of what a step
#: moves through gloo; 4 layers made the step 131.8 s of the script, over
#: its 120 s)
MESH_TRAIN_REPEATS = 2
#: world 4's ranks run the step without a mesh this many at a time (its
#: float32 step peaks at ≈ 27 GiB on the card)
MESH_TRAIN_TURN = 2
#: world 4's steps in each dtype (bf16, then float32)
MESH_TRAIN_W4_STEPS = 2
#: tests/test_torch_train.py's tolerance: each leaf within 1e-4 of its
#: largest element; each metric within 1e-4 of itself
MESH_TRAIN_TOL = 1e-4
#: the AdamW config of both worlds: ``plan_cell``'s default (lr 3e-4 after
#: 100 warm-up steps: 3e-6 at the first step, so that an element whose
#: gradient is near 0 and of the other sign in two runs — at the first
#: step every element moves by ±lr — stays within the leaf tolerance)
MESH_TRAIN_OPT = adamw.AdamWConfig()


def train_collectives(cfg, model_size: int, sp: bool = True) -> dict:
    """PERF.md §6's count of a sharded train step of an attention /
    dense (swiglu) stack of L layers, qwen3-1.7b's five norm leaves.
    Forward (``collectives``): the prefill's (:func:`prefill_collectives`)
    without the last position's broadcast, plus with SP one sequence
    gather before the head, the loss's 3 all-reduces over "model" (max, sum
    of exponentials, gold logit) and 1 over the dp axes. Backward: each of
    those that carries a gradient transposed — an all-gather's a
    reduce-scatter, a reduce-scatter's an all-gather, an all-reduce's an
    all-reduce (the max carries none; the sum and the gold logit share
    one) —, one all-reduce a leaf whole on some mesh axis (``leaf_sum``:
    the five norm leaves) and one of AdamW's sums of squares
    (``norm_sum``)."""
    L = cfg.n_layers
    cut = cfg.n_kv_heads % model_size != 0
    R = 2 * L + 1
    calls = dict(fsdp_gather=7 * L + 2, column=5 * L, row=2 * L,
                 sp_gather=2 * L + 1 if sp else 0,
                 head_gather=2 * L if cut else 0, embed=1, head=1,
                 last_position=0, moe=0)
    gathers = calls["fsdp_gather"] + calls["sp_gather"] \
        + calls["head_gather"]
    return {"calls": calls,
            "collectives": dict(all_gather=gathers,
                                reduce_scatter=R if sp else 0,
                                all_reduce=(0 if sp else R) + 4,
                                broadcast=0, all_to_all=0),
            "backward": dict(all_gather=R if sp else 0,
                             reduce_scatter=gathers,
                             all_reduce=(0 if sp else R) + 2,
                             all_to_all=0, leaf_sum=5, norm_sum=1)}


def train_state_sh(model, mesh) -> tuple:
    """(the param shardings, those of the state {"params", "opt"})."""
    from repro_torch.launch import sharding as shd
    sh = shd.shard_params(model.param_shapes(), mesh)
    return sh, {"params": sh, "opt": shd.shard_opt_state(
        adamw.state_shapes(model.param_shapes()), sh, mesh)}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree))


def leaf_distance(got, want, scale=None) -> dict:
    """Each leaf of ``got`` against ``want``'s (on any device; ``scale``:
    each whole leaf's max|.| where ``want`` holds slices): how many are
    equal bit for bit, and the largest |got - want| as a share of
    MESH_TRAIN_TOL x max|leaf| (``share_of_tol``; 1 is the limit), with
    its path."""
    pairs = list(zip(tr.flatten_with_path(got), tr.leaves(want)))
    equal, worst, where = 0, 0.0, None
    for i, ((path, a), b) in enumerate(pairs):
        b = b.to(a.device)
        top = float(b.abs().max()) if scale is None else scale[i]
        if a.dtype == b.dtype and torch.equal(a, b):
            equal += 1
            continue
        err = float((a.float() - b.float()).abs().max())
        share = err / (MESH_TRAIN_TOL * top) if top else math.inf
        if share > worst:
            worst, where = share, "/".join(path)
    return dict(leaves=len(pairs), equal=equal, share_of_tol=worst,
                worst_leaf=where)


def metric_distance(got: dict, want: dict,
                    keys=("loss", "grad_norm")) -> dict:
    """|got - want| of each of ``keys`` as a share of MESH_TRAIN_TOL x
    |want|, and whether lr is equal."""
    out = {k: abs(float(got[k]) - float(want[k]))
           / (MESH_TRAIN_TOL * abs(float(want[k]))) for k in keys}
    out["lr_equal"] = float(got["lr"]) == float(want["lr"])
    return out


def timed_ms(fn, *args) -> tuple:
    """(``fn(*args)``, its wall ms between two synchronizations)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def counted_mesh_step(fn, args, cfg, dtype, formula, what: str) -> tuple:
    """One sharded step ``fn(*args)`` with every count at 0 just before
    and read just after: one ``rms_norm`` a norm (``row_in_registers``:
    :func:`train_rms_per_step`) and one ``flash_attention`` an attention
    layer (the dtype's variant) in the forward, none in a backward (the
    plain versions' gradients), and the collectives of ``formula`` (with
    its ``backward`` where it has one). Returns (its output, its line)."""
    from repro_torch.launch import partition as mpt
    rms, attn = train_rms_per_step(cfg), attention_layers(cfg)
    reset_all_counts()
    mpt.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, by_variant = lm_counts_since_reset(
        {"rms_norm": {"row_in_registers": rms},
         "flash_attention": {ATTN_VARIANT[dtype]: attn}},
        rms_norm=rms, flash_attention=attn)
    got = dict(mpt.counts(), **({"backward": mpt.backward_counts()}
                                if "backward" in formula else {}))
    if got != formula:
        raise AssertionError(f"{what}: collectives {got}, PERF.md's "
                             f"formula {formula}")
    return out, dict(ms=seconds * 1e3, peak_gib=peak / 2**30,
                     step_gib=(peak - base) / 2**30, launches=counts,
                     launches_by_variant=by_variant)


def counted_train_step(step, st, batch, cfg, dtype, formula,
                       what: str = "mesh train") -> tuple:
    """:func:`counted_mesh_step` of a train step from the state ``st``
    {"params", "opt"}, its metrics finite. Returns (the new state, its
    metrics, its line with the metrics)."""
    what = f"{what} {dtype}"
    (p, o, met), line = counted_mesh_step(
        step, (st["params"], st["opt"], batch), cfg, dtype, formula, what)
    if not all(math.isfinite(float(v)) for v in met.values()):
        raise AssertionError(f"{what}: metrics {met}")
    line.update({k: float(v) for k, v in met.items()})
    return {"params": p, "opt": o}, met, line


def whole_leaves(local, whole) -> set:
    """The names of the leaves that ``local_params`` left whole: those of
    ``local`` that are ``whole``'s own tensors."""
    return {path[-1] for (path, a), b in zip(tr.flatten_with_path(local),
                                              tr.leaves(whole)) if a is b}


def state_bytes(st, model, sh, state_sh, what: str) -> dict:
    """A rank's bytes of the train state ``st`` {"params", "opt"}, the
    whole state's, and its shards' (the weights' and both moments' shard
    shapes summed, and AdamW's step counter); raises unless the rank holds
    exactly its shards."""
    from repro_torch.launch import sharding as shd
    out = dict(local=tree_bytes(st), whole=sum(
        math.prod(s.global_shape(tuple(t.shape))) * t.element_size()
        for t, s in zip(tr.leaves(st), tr.leaves(state_sh))),
        shards=shd.shard_bytes(model.param_shapes(), sh)
        + 2 * shd.shard_bytes(adamw.state_shapes(
            model.param_shapes()).m, sh) + 4)
    if out["local"] != out["shards"]:
        raise AssertionError(f"{what}: the rank holds {out}")
    return out


def in_turns(mesh, turn: int, fn) -> tuple:
    """``fn()`` on every rank of ``mesh``, ``turn`` ranks at a time in rank
    order, the others waiting at a barrier (the card's memory holds
    ``turn`` of them at once). Returns (its result on this rank, the
    seconds of all the turns)."""
    from repro_torch.launch import mesh as ml
    rank = torch.distributed.get_rank()
    t0 = time.perf_counter()
    out = None
    for first in range(0, ml.world_of(mesh), turn):
        if first <= rank < first + turn:
            out = fn()
            torch.cuda.empty_cache()
        ml.barrier(mesh)
    return out, time.perf_counter() - t0


def train_batch(cfg, step: int, batch: int = TRAIN_B,
                seq: int = TRAIN_S) -> dict:
    return batch_at(cfg, ShapeSpec("train", seq, batch, "train"), step,
                    DataConfig(seed=TRAIN_SEED + 99))


def fingerprint(tree) -> list:
    """Each leaf's (dtype, shape, and its bit patterns summed as int64,
    plainly and weighted by position): two trees whose lists are equal are
    equal bit for bit but by a collision of both sums. A witness that
    needs no second copy of a full-width state on the card."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tr.leaves(tree):
        bits = t.contiguous().view(ints[t.element_size()]).reshape(-1).to(
            torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
        out.append((str(t.dtype), tuple(t.shape), int(bits.sum()),
                    int((bits * w).sum())))
        del bits, w
    return out


def mesh_train_world1(mesh, work: Path) -> dict:
    """World 1 (NCCL, 1 x 1). (a) qwen3-1.7b whole, bf16, MESH_TRAIN_STEPS
    steps of TRAIN_B x TRAIN_S, each this rank's shards of the state and
    its rows of the batch (``shard_batch``) through
    ``build_train_step(act_spec=)`` made as ``plan_cell``'s train plan
    makes it (the batch on the dp axes, SP, AdamW's default config), each
    step counted (:func:`counted_train_step`). Before each, the step
    without a mesh runs from the same state: loss, grad_norm and lr must be
    equal bit for bit, and every leaf of the weights and moments
    (:func:`fingerprint`: two full-width states do not fit on the card
    beside a step). A leaf that differs is then held within MESH_TRAIN_TOL
    x max|leaf| of the step without a mesh, run again with the sharded
    leaves on the host, its distance printed. ms a step of both. The steps
    are driven here, not by ``run_training``, whose final checkpoint at
    full width (24.4 GB) phase lm_train already writes and times: the
    loop's sharded checkpoint and resume run on world 4's state
    (:func:`mesh_train_world4`, :func:`mesh_train_elastic`, the latter on a
    world of one). (b) The same at MESH_TRAIN_REPEATS layers in bf16 and
    float32, MESH_TRAIN_W4_STEPS steps each: world 4's references, written
    to ``work``."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_act_constrainer
    cfg = get_lm_config(TRAIN_ARCH)
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=True)
    formula = train_collectives(cfg, 1)
    model = build_lm_model(cfg)
    params, _ = init_weights(model, TRAIN_SEED)
    sh, _ = train_state_sh(model, mesh)
    local = shd.local_params(params, sh, mesh)
    del params
    sharded = build_train_step(model, MESH_TRAIN_OPT, act_spec=act)
    plain = build_train_step(model, MESH_TRAIN_OPT)
    steps = []

    def step_fn(st, w):
        b = shard_batch(w, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, want = plain(st["params"], st["opt"], w)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want_fp = fingerprint({"params": p, "opt": o})
        del p, o
        torch.cuda.empty_cache()
        new, met, line = counted_train_step(sharded, st, b, cfg,
                                            torch.bfloat16, formula)
        got_fp = fingerprint(new)
        differ = [i for i, (a, b_) in enumerate(zip(got_fp, want_fp))
                  if a != b_]
        d = dict(leaves=len(got_fp), equal=len(got_fp) - len(differ),
                 share_of_tol=0.0, worst_leaf=None)
        if differ:
            # the new state on the host, the step without a mesh again,
            # each differing leaf held to it, the state back on the card
            host = tr.tree_map(lambda t: t.cpu(), new)
            del new
            torch.cuda.empty_cache()
            p, o, _ = plain(st["params"], st["opt"], w)
            ref = tr.leaves({"params": p, "opt": o})
            at = tr.flatten_with_path(host)
            for i in differ:
                share = leaf_distance({"x": at[i][1].to(DEV)},
                                      {"x": ref[i]})["share_of_tol"]
                if share >= d["share_of_tol"]:
                    d.update(share_of_tol=share, worst_leaf="/".join(
                        at[i][0]))
            del p, o, ref, at
            torch.cuda.empty_cache()
            new = tr.tree_map(lambda t: t.to(DEV), host)
            del host
            if not d["share_of_tol"] <= 1.0:
                raise AssertionError(f"mesh train world 1 step "
                                     f"{len(steps)}: {d}")
        m = metric_distance(met, want)
        if not (max(m["loss"], m["grad_norm"]) <= 1.0 and m["lr_equal"]):
            raise AssertionError(f"mesh train world 1 step {len(steps)}: "
                                 f"{m}")
        equal = not differ and all(torch.equal(met[k], want[k])
                                   for k in ("loss", "grad_norm", "lr"))
        steps.append(dict(step=len(steps), **line, plain_ms=plain_ms,
                          leaves=d, metrics=m, bit_equal=equal))
        return new

    st = {"params": local, "opt": adamw.init(local)}
    del local
    for s in range(MESH_TRAIN_STEPS):
        st = step_fn(st, train_batch(cfg, s))
    del st
    torch.cuda.empty_cache()
    line = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, batch=TRAIN_B,
                seq=TRAIN_S, steps=steps, collectives=formula,
                bit_equal=all(s["bit_equal"] for s in steps))
    line["depth"] = mesh_train_depth_refs(mesh, work, act)
    return line


def mesh_train_depth_refs(mesh, work: Path, act) -> dict:
    """World 1 at MESH_TRAIN_REPEATS layers: bf16 then float32 (the bf16
    weights cast, exact), MESH_TRAIN_W4_STEPS sharded steps each beside
    the step without a mesh; their metrics written for world 4."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding as shd
    cfg = dataclasses.replace(get_lm_config(TRAIN_ARCH),
                              repeats=MESH_TRAIN_REPEATS)
    opt = MESH_TRAIN_OPT
    formula = train_collectives(cfg, 1)
    params, _ = init_weights(build_lm_model(cfg), TRAIN_SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_lm_model(dataclasses.replace(
            cfg, param_dtype=str(dtype).split(".")[1]))
        p = tree_to(params, dtype)
        sh, _ = train_state_sh(model, mesh)
        local = shd.local_params(p, sh, mesh)
        st, ref = {"params": local, "opt": adamw.init(local)}, \
            {"params": p, "opt": adamw.init(p)}
        step, plain = build_train_step(model, opt, act_spec=act), \
            build_train_step(model, opt)
        lines = []
        for k in range(MESH_TRAIN_W4_STEPS):
            b = train_batch(cfg, k)
            st, met, line = counted_train_step(step, st, shard_batch(b, mesh),
                                               cfg, dtype, formula)
            pp, po, want = plain(ref["params"], ref["opt"], b)
            ref = {"params": pp, "opt": po}
            d = leaf_distance(st, ref)
            if not d["share_of_tol"] <= 1.0:
                raise AssertionError(f"mesh train world 1, "
                                     f"{cfg.n_layers} layers {dtype}: {d}")
            lines.append(dict(line, leaves=d, metrics_equal=all(
                torch.equal(met[k_], want[k_])
                for k_ in ("loss", "grad_norm", "lr"))))
        out[str(dtype).split(".")[1]] = lines
        del st, ref, local, p
    del params
    torch.cuda.empty_cache()
    (work / "train_world1.json").write_text(json.dumps(out))
    return out


def unsharded_refs(model, params, cfg, mesh, sh, state_sh, whole: bool,
                   steps: int = MESH_TRAIN_W4_STEPS,
                   each: bool = True, batch_fn=None) -> tuple:
    """``steps`` float32 steps of ``model`` without a mesh on the whole
    weights (``params`` cast): (for each step its metrics, each whole
    leaf's max|.| and, after every step with ``each`` or else after the
    last only, this rank's slices of the state, on the host; with
    ``whole``, the last state whole on the host and its metrics, else
    None). Nothing of it stays on the card. ``batch_fn(step)``: the
    batches (:func:`train_batch`'s by default)."""
    from repro_torch.launch import sharding as shd
    plain = build_train_step(model, MESH_TRAIN_OPT)
    batch_fn = batch_fn or (lambda k: train_batch(cfg, k))
    p = tree_to(params, torch.float32)
    ref = {"params": p, "opt": adamw.init(p)}
    del p
    refs = []
    for k in range(steps):
        pp, po, met = plain(ref["params"], ref["opt"], batch_fn(k))
        ref = {"params": pp, "opt": po}
        del pp, po
        refs.append(dict(
            metrics={k_: float(v) for k_, v in met.items()},
            scale=[float(t.abs().max()) for t in tr.leaves(ref)]))
        if each or k == steps - 1:
            refs[-1]["state"] = tr.tree_map(lambda t: t.cpu(),
                                            shd.local_params(ref, {
                                                "params": sh,
                                                "opt": state_sh["opt"]},
                                                mesh))
    keep = dict(state=tr.tree_map(lambda t: t.cpu(), ref),
                metrics=refs[-1]["metrics"]) if whole else None
    return refs, keep


def mesh_train_world4(mesh, work: Path) -> dict:
    """World 4 (gloo, 2 x 2, four processes on the card): qwen3-1.7b at
    full width cut to MESH_TRAIN_REPEATS layers, the batch over "data",
    heads, columns and the sequence over "model". bf16: MESH_TRAIN_W4_STEPS
    counted steps, loss and grad_norm against world 1's at the same depth
    (recorded, not bounded). float32 (the same weights cast): each rank in
    turn (MESH_TRAIN_TURN at a time) runs the step without a mesh on the
    whole weights and keeps its slices of the result; then the first step through
    ``run_training(state_shardings=)``, whose final checkpoint (gathered
    onto the first rank and written there) is the one the elastic check
    resumes on a world of one, and the second step; after each, loss and
    grad_norm within MESH_TRAIN_TOL of the step without a mesh (and
    recorded against world 1's), every weight and moment shard within
    MESH_TRAIN_TOL x max|leaf|. Each rank holds its shard bytes, only the
    norms whole. Returns the line, and on the first rank the step without
    a mesh's state after the last step (the elastic check's reference)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import make_act_constrainer
    cfg = dataclasses.replace(get_lm_config(TRAIN_ARCH),
                              repeats=MESH_TRAIN_REPEATS)
    opt = MESH_TRAIN_OPT
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=True)
    formula = train_collectives(cfg, ml.mesh_shape(mesh)["model"])
    world1 = json.loads((work / "train_world1.json").read_text())
    rank = torch.distributed.get_rank()
    params, _ = init_weights(build_lm_model(cfg), TRAIN_SEED)
    line = dict(layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
                mesh=ml.mesh_shape(mesh), collectives=formula)
    keep = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        model = build_lm_model(dataclasses.replace(cfg, param_dtype=name))
        p = tree_to(params, dtype)
        sh, state_sh = train_state_sh(model, mesh)
        local = shd.local_params(p, sh, mesh)
        whole = whole_leaves(local, p)
        del p
        st = {"params": local, "opt": adamw.init(local)}
        refs = []
        if dtype == torch.float32:
            # the step without a mesh, MESH_TRAIN_TURN ranks at a time
            (refs, keep), line["turns_seconds"] = in_turns(
                mesh, MESH_TRAIN_TURN, lambda: unsharded_refs(
                    model, params, cfg, mesh, sh, state_sh, rank == 0))
            line["reserved_gib_after_turns"] = \
                torch.cuda.memory_reserved() / 2**30
        torch.cuda.empty_cache()
        step = build_train_step(model, opt, act_spec=act)
        runs, kept = [], {}

        def check(s, met, row):
            w1 = world1[name][s]
            row["vs_world1"] = metric_distance(met, w1)
            if refs:
                ref = refs[s]
                d = leaf_distance(kept["state"], ref["state"],
                                  scale=ref["scale"])
                m = metric_distance(met, ref["metrics"])
                if not (d["share_of_tol"] <= 1.0 and m["lr_equal"]
                        and max(m["loss"], m["grad_norm"]) <= 1.0):
                    raise AssertionError(f"mesh train world 4 {name} step "
                                         f"{s}: {d} {m}")
                row.update(leaves=d, vs_unsharded=m)
            runs.append(row)
            kept["t_last"] = time.perf_counter()

        def step_fn(st_, b):
            new, met, kept["row"] = counted_train_step(step, st_, b, cfg,
                                                       dtype, formula)
            kept["state"] = new
            return new, met

        def batch_fn(s):
            return shard_batch(train_batch(cfg, s), mesh)

        first = 0
        if dtype == torch.float32:
            ckpt_dir = work / "train_w4_ckpt"
            run_training(TrainLoopConfig(total_steps=1, ckpt_every=2,
                                         ckpt_dir=str(ckpt_dir)),
                         step_fn, st, batch_fn, state_shardings=state_sh,
                         on_metrics=lambda s, met: check(s, met, kept.pop(
                             "row")))
            line["checkpoint_save_seconds"] = time.perf_counter() \
                - kept.pop("t_last")
            st, first = kept["state"], 1
        for s in range(first, MESH_TRAIN_W4_STEPS):
            st, met = step_fn(st, batch_fn(s))
            check(s, met, kept.pop("row"))
        bytes_ = state_bytes(st, model, sh, state_sh,
                             f"mesh train world 4 {name}")
        if whole != MESH_WHOLE_LEAVES:
            raise AssertionError(f"mesh train world 4 {name}: whole leaves "
                                 f"{whole}")
        line[name] = dict(steps=runs, bytes=bytes_,
                          share=bytes_["local"] / bytes_["whole"],
                          whole_leaves=sorted(whole))
        kept.clear()            # the step's closures hold it
        del st, local, refs
        torch.cuda.empty_cache()
    return line, keep


def mesh_train_elastic(work: Path, want) -> dict:
    """The elastic check, on the first rank of world 4 once its group is
    gone: a world of one NCCL rank resumes world 4's float32 checkpoint of
    its first step through ``run_training(state_shardings=)`` and runs the
    second step, which must be the uninterrupted step without a mesh's
    (``want``, its state on the host) within MESH_TRAIN_TOL x max|leaf|,
    loss and grad_norm within MESH_TRAIN_TOL."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    ml.init_world("nccl")
    mesh = ml.make_test_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_lm_config(TRAIN_ARCH),
                              repeats=MESH_TRAIN_REPEATS,
                              param_dtype="float32")
    model = build_lm_model(cfg)
    _sh, state_sh = train_state_sh(model, mesh)
    step = build_train_step(model, MESH_TRAIN_OPT, mesh=mesh)
    kept = {}

    def step_fn(st, b):
        new, met, kept["row"] = counted_train_step(
            step, st, b, cfg, torch.float32,
            train_collectives(cfg, 1))
        kept["state"], kept["met"] = new, met
        return new, met

    ckpt_dir = work / "train_w4_ckpt"
    t0 = time.perf_counter()
    out = run_training(TrainLoopConfig(total_steps=MESH_TRAIN_W4_STEPS,
                                       ckpt_every=MESH_TRAIN_W4_STEPS + 1,
                                       ckpt_dir=str(ckpt_dir)),
                       step_fn, want["state"],
                       lambda s: shard_batch(train_batch(cfg, s), mesh),
                       state_shardings=state_sh)
    seconds = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    d = leaf_distance(kept["state"], want["state"])
    m = metric_distance(kept["met"], want["metrics"])
    if not (out["final_step"] == MESH_TRAIN_W4_STEPS
            and len(out["losses"]) == MESH_TRAIN_W4_STEPS - 1
            and d["share_of_tol"] <= 1.0 and m["lr_equal"]
            and max(m["loss"], m["grad_norm"]) <= 1.0):
        raise AssertionError(f"elastic resume on world 1: {out} {d} {m}")
    torch.distributed.destroy_process_group()
    return dict(resumed_from_step=MESH_TRAIN_W4_STEPS - 2, **kept["row"],
                leaves=d, vs_uninterrupted=m, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase mesh, step moe: mixtral-8x7b's sharded prefill and train step
# ---------------------------------------------------------------------------

#: world 1's prefill depth (phase lm_moe's 4 of 32 layers) and its float32
#: step's (lm_moe's parity depth); world 4 prefills at the latter in both
#: dtypes
MESH_MOE_REPEATS, MESH_MOE_F32_REPEATS = MOE_REPEATS, MOE_PARITY_REPEATS
#: the train steps' depth in both worlds: 1 layer (1.71 B parameters). A
#: step from a state holds the old and the new state (12 bytes a parameter
#: each), the gradient and AdamW's float32 temporaries of the largest leaf:
#: at 2 layers (3.16 B) ≈ 92 GB on one rank, at 1 ≈ 51 GB; on world 4's
#: four ranks sharing the card ≈ 114 GB and ≈ 57 GB
MESH_MOE_TRAIN_REPEATS = 1
#: world 1's bit-equal train steps; world 4's steps in each dtype
MESH_MOE_STEPS, MESH_MOE_W4_STEPS = 3, 2
MESH_MOE_SEED = MOE_SEED + 17
#: the dispatch groups of world 4's references (plan_cell's |dp|·|model|)
MESH_MOE_W4_GROUPS = 4
#: the leaves a rank holds whole: the norms (mixtral has no q/k norms)
MESH_MOE_WHOLE_LEAVES = {"final_norm", "norm1", "norm2"}


def moe_collectives(cfg, shape: tuple, B: int, S: int, train: bool) -> dict:
    """PERF.md §6's count of a sharded prefill (``train`` False) or
    train step of mixtral's attn + moe stack of L layers on a (|data|,
    |model|) mesh, B x S tokens, SP where S splits over "model". Attention
    a layer: 4 FSDP gathers, 3 column and 1 row product (wo's sum over
    "model"), with SP one sequence gather. MoE a layer
    (``partition.moe``): the router's FSDP gather; with SP a sequence
    gather unless the rank's SP slice is its groups (``direct``); with EP
    two all-to-alls; with d_ff split on "model" the groups' gather and the
    partial sums' reduce-scatter (one all-reduce where a "model" column
    shares its groups); the output's gather unless direct or shared; aux's
    all-reduce over the group axes. A step: the embedding's and head's
    FSDP gathers, the embedding's sum over "model", the prefill's
    last-position broadcast (SP), the train step's sequence gather before
    the head, the loss's 3 + 1 all-reduces, the transposes (an all-to-all's
    the reverse all-to-all), a leaf sum for the 3 norm leaves, the router
    and, where no EP or d_ff whole, w_gate, w_up and w_down, and AdamW's
    norm sum."""
    dsz, msz = shape
    L = cfg.n_layers
    G = cfg.moe_groups if (B * S) % cfg.moe_groups == 0 else 1
    shared = (G // dsz) % msz != 0
    sp = S % msz == 0
    direct = sp and B // dsz == 1 and not shared
    ep, ff = cfg.n_experts % dsz == 0, cfg.expert_d_ff % msz == 0
    router = cfg.d_model % dsz == 0
    calls = dict(fsdp_gather=(4 + router) * L + 2, column=3 * L, row=L,
                 sp_gather=((1 + (not direct)) * L + train) if sp else 0,
                 head_gather=L * (2 * (cfg.n_kv_heads % msz != 0)
                                  + (cfg.n_heads % msz != 0)),
                 embed=1, head=1, last_position=int(not train), moe=L)
    gathers = calls["fsdp_gather"] + calls["sp_gather"] \
        + calls["head_gather"] + L * ((ff and not shared)
                                      + (not direct and not shared))
    sums, moe_ar = L + 1, L * (ff and shared) + L
    fwd = dict(all_gather=gathers,
               reduce_scatter=(sums if sp else 0) + L * (ff and not shared),
               all_reduce=(0 if sp else sums) + moe_ar + 4 * train,
               broadcast=int(sp and not train), all_to_all=2 * ep * L)
    out = {"calls": calls, "collectives": fwd}
    if train:
        out["backward"] = dict(
            all_gather=fwd["reduce_scatter"], reduce_scatter=gathers,
            all_reduce=(0 if sp else sums) + moe_ar + 2,
            all_to_all=fwd["all_to_all"],
            leaf_sum=4 + 3 * (not (ep and ff)), norm_sum=1)
    return out


def moe_plan(mesh, kind: str, repeats: int):
    """``plan_cell``'s plan of mixtral-8x7b at ``repeats`` layers on
    ``mesh`` (its prefill_32k or train_4k plan: the batch on the dp axes,
    SP, the dispatch groups it sets for the mesh), on the card."""
    from repro_torch.launch.steps import plan_cell
    return plan_cell(MOE_ARCH, "prefill_32k" if kind == "prefill"
                     else "train_4k", mesh, opt_cfg=MESH_TRAIN_OPT,
                     cfg_overrides=dict(repeats=repeats), device=DEV)


def moe_weights_in(tree, dtype):
    """bf16 weights (their float32 routers) as they are, or every leaf cast
    to float32 (exact)."""
    return tree if dtype == torch.bfloat16 else tree_to(tree, torch.float32)


def moe_layer_input(cfg) -> torch.Tensor:
    """One MoE layer's input (PREFILL_B, PREFILL_S, D) in bf16 from the
    seed: normal tokens and MOE_SKEW times a direction they share, which
    skews the routing (experts overflow, idle ones steal)."""
    gen = torch.Generator(device=DEV).manual_seed(MESH_MOE_SEED + 1)
    D = cfg.d_model
    x = torch.randn((PREFILL_B, PREFILL_S, D), generator=gen, device=DEV)
    x = x + MOE_SKEW * torch.randn((D,), generator=gen, device=DEV)
    return x.to(torch.bfloat16)


def moe_tokens(cfg) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(MESH_MOE_SEED).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), dtype=torch.int64,
        device=DEV)


#: the metrics a MoE train step is held to (:func:`metric_distance`)
MOE_METRICS = ("loss", "xent", "moe_aux", "grad_norm")


def mesh_moe_world1(mesh, work: Path) -> dict:
    """World 1 (NCCL, 1 x 1), mixtral-8x7b at full width through
    ``plan_cell``'s plans (one dispatch group: a world of one). (a) The
    bf16 prefill of PREFILL_B x PREFILL_S at MESH_MOE_REPEATS layers, its
    logits equal to the unsharded step's bit for bit, ms of both. (b) At
    MESH_MOE_F32_REPEATS layers (weights from the seed at that depth): the
    float32 step (the bf16 weights cast) against the unsharded one; the
    unsharded steps with world 4's MESH_MOE_W4_GROUPS groups in both dtypes,
    whose logits world 4 holds its own to. (c) MESH_MOE_STEPS bf16 train
    steps of TRAIN_B x TRAIN_S at MESH_MOE_TRAIN_REPEATS layers, each from
    the same state as the step without a mesh and equal to it bit for bit
    (metrics; every leaf by :func:`fingerprint`), ms of both; and the
    unsharded bf16 steps with world 4's groups, whose metrics world 4's
    bf16 steps are recorded against. Each sharded step counted
    (:func:`counted_mesh_step`)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding as shd
    t0 = time.perf_counter()
    line = dict(arch=MOE_ARCH)
    # ---- (a) the prefill at MESH_MOE_REPEATS layers, bf16 -------------------
    plan = moe_plan(mesh, "prefill", MESH_MOE_REPEATS)
    cfg = plan.cfg
    model = build_lm_model(cfg)
    params, _ = init_weights(model, MESH_MOE_SEED)
    tokens = moe_tokens(cfg)
    plain = build_prefill_step(model)
    timed_ms(plain, params, {"tokens": tokens})                 # warm
    want, plain_ms = timed_ms(plain, params, {"tokens": tokens})
    lp = shd.local_params(params, shd.shard_params(model.param_shapes(),
                                                   mesh), mesh)
    del params
    batch = shard_batch({"tokens": tokens}, mesh)
    formula = moe_collectives(cfg, (1, 1), PREFILL_B, PREFILL_S, False)
    got, run = counted_mesh_step(plan.fn, (lp, batch), cfg, torch.bfloat16,
                                 formula, "mesh moe world 1 prefill bf16")
    if not torch.equal(got, want):
        raise AssertionError(f"mesh moe world 1: the sharded bf16 logits "
                             f"are not the unsharded step's: "
                             f"{float((got - want).abs().max())} apart")
    _again, run["ms"] = timed_ms(plan.fn, lp, batch)
    line["prefill"] = dict(layers=cfg.n_layers, batch=PREFILL_B,
                           seq=PREFILL_S, groups=cfg.moe_groups,
                           unsharded_ms=plain_ms, equal_to_unsharded=True,
                           collectives=formula, **run)
    del lp, want, got, _again
    torch.cuda.empty_cache()
    # ---- (b) MESH_MOE_F32_REPEATS layers: float32; world 4's references ---
    cfg2 = dataclasses.replace(cfg, repeats=MESH_MOE_F32_REPEATS)
    p2, _ = init_weights(build_lm_model(cfg2), MESH_MOE_SEED)
    refs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        cfg_d = dataclasses.replace(cfg2, param_dtype=name)
        p = moe_weights_in(p2, dtype)
        four = build_lm_model(dataclasses.replace(
            cfg_d, moe_groups=MESH_MOE_W4_GROUPS))
        refs[name] = build_prefill_step(four)(p, {"tokens": tokens})
        if dtype == torch.float32:
            model32 = build_lm_model(cfg_d)
            want, plain_ms = timed_ms(build_prefill_step(model32), p,
                                   {"tokens": tokens})
            lp = shd.local_params(p, shd.shard_params(
                model32.param_shapes(), mesh), mesh)
            f32 = build_prefill_step(model32, act_spec=plan.act_spec)
            got, run = counted_mesh_step(
                f32, (lp, batch), cfg_d, dtype,
                moe_collectives(cfg_d, (1, 1), PREFILL_B, PREFILL_S, False),
                "mesh moe world 1 prefill float32")
            tol = 1e-3 * float(want.abs().max()) + 1e-3
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"mesh moe world 1 float32 prefill: "
                                     f"{err} from the unsharded, limit {tol}")
            line["prefill_float32"] = dict(
                layers=cfg_d.n_layers, unsharded_ms=plain_ms,
                equal_to_unsharded=bool(torch.equal(got, want)),
                max_abs=err, **run)
            del lp, want, got
        del p
    # one MoE layer (layer 0's FFN, bf16) with world 4's groups
    y, aux, st = moe_mod.moe_apply(
        {k: v[0] for k, v in p2["layers"]["slot0"]["ffn"].items()},
        moe_layer_input(cfg2), n_experts=cfg2.n_experts,
        top_k=cfg2.experts_per_tok, capacity_factor=cfg2.capacity_factor,
        ws_rebalance=cfg2.ws_rebalance, n_groups=MESH_MOE_W4_GROUPS)
    refs["layer_y"] = y.float()
    (work / "moe_layer_ref.json").write_text(json.dumps(dict(
        aux=float(aux), dropped=float(st.dropped), stolen=float(st.stolen),
        load_std=float(st.load_std))))
    np.savez(work / "moe_prefill_refs.npz",
             **{k: v.cpu().numpy() for k, v in refs.items()})
    del p2, refs
    torch.cuda.empty_cache()
    # ---- (c) the train steps at MESH_MOE_TRAIN_REPEATS layers, bf16 -------
    plan = moe_plan(mesh, "train", MESH_MOE_TRAIN_REPEATS)
    cfg = plan.cfg
    model = build_lm_model(cfg)
    params, _ = init_weights(model, MESH_MOE_SEED)
    plain = build_train_step(model, MESH_TRAIN_OPT)
    four = build_train_step(build_lm_model(dataclasses.replace(
        cfg, moe_groups=MESH_MOE_W4_GROUPS)), MESH_TRAIN_OPT)
    st = {"params": params, "opt": adamw.init(params)}
    w4 = []
    for k in range(MESH_MOE_W4_STEPS):
        p, o, met = four(st["params"], st["opt"], train_batch(cfg, k))
        st = {"params": p, "opt": o}
        w4.append({m: float(v) for m, v in met.items()})
        del p, o
    (work / "moe_train_refs.json").write_text(json.dumps(w4))
    del st
    torch.cuda.empty_cache()
    local = shd.local_params(params, shd.shard_params(model.param_shapes(),
                                                      mesh), mesh)
    del params
    formula = moe_collectives(cfg, (1, 1), TRAIN_B, TRAIN_S, True)
    st = {"params": local, "opt": adamw.init(local)}
    del local
    steps = []
    for k in range(MESH_MOE_STEPS):
        b = train_batch(cfg, k)
        (p, o, want), plain_ms = timed_ms(plain, st["params"], st["opt"], b)
        want_fp = fingerprint({"params": p, "opt": o})
        del p, o
        torch.cuda.empty_cache()
        st, met, run = counted_train_step(plan.fn, st, shard_batch(b, mesh),
                                          cfg, torch.bfloat16, formula,
                                          f"mesh moe world 1 step {k}")
        got_fp = fingerprint(st)
        equal = got_fp == want_fp and all(
            torch.equal(met[m], want[m]) for m in want)
        if not equal:
            raise AssertionError(f"mesh moe world 1 train step {k}: not "
                                 f"bit-equal to the step without a mesh: "
                                 f"{metric_distance(met, want, MOE_METRICS)}")
        steps.append(dict(step=k, plain_ms=plain_ms, leaves=len(got_fp),
                          bit_equal=True, **run))
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    line["train"] = dict(layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
                         groups=cfg.moe_groups, steps=steps,
                         collectives=formula)
    line["seconds"] = time.perf_counter() - t0
    return line


def moe_layer_world4(plan, lp, batch, work: Path, coord: dict,
                     shape: tuple) -> dict:
    """Layer 0's MoE FFN (bf16) on this rank's dispatch groups
    (``partition.moe`` with its statistics) against world 1's
    ``moe_apply`` on the whole input with the same groups: ``dropped`` and
    ``stolen`` equal (fractions of 2 x 2048 assignments a group: exact in
    float32), ``aux`` and ``load_std`` within 1e-4 of it, ``y``'s
    distance recorded (bf16)."""
    from repro_torch.launch import partition as mpt
    cfg = plan.cfg
    part = mpt.for_model(plan.act_spec, cfg, mpt.local(batch["tokens"]))
    rows = PREFILL_B // shape[0]
    x = moe_layer_input(cfg)[coord["data"] * rows:(coord["data"] + 1) * rows]
    ffn = {k: v[0] for k, v in lp["layers"]["slot0"]["ffn"].items()}
    y, aux, st = mpt.moe(part, part.into_layout(x), ffn, stats=True)
    want = json.loads((work / "moe_layer_ref.json").read_text())
    got = dict(aux=float(aux), dropped=float(st.dropped),
               stolen=float(st.stolen), load_std=float(st.load_std))
    if not (got["dropped"] == want["dropped"]
            and got["stolen"] == want["stolen"] and got["stolen"] > 0
            and all(abs(got[k] - want[k]) <= 1e-4 * abs(want[k])
                    for k in ("aux", "load_std"))):
        raise AssertionError(f"mesh moe world 4 layer: {got} against the "
                             f"unsharded {want}")
    ref = np.load(work / "moe_prefill_refs.npz")["layer_y"][
        coord["data"] * rows:(coord["data"] + 1) * rows]
    n = PREFILL_S // shape[1]
    ref = torch.from_numpy(ref[:, coord["model"] * n:
                               (coord["model"] + 1) * n]).to(DEV)
    return dict(got, unsharded=want, layout=part.moe._asdict(),
                y_vs_unsharded_max_abs=float((y.float() - ref).abs().max()),
                y_max_abs=float(ref.abs().max()))


def mesh_moe_world4(mesh, work: Path) -> dict:
    """World 4 (gloo, 2 x 2, four processes on the card), mixtral-8x7b at
    full width through ``plan_cell``'s plans: MESH_MOE_W4_GROUPS dispatch
    groups, the 8 experts split on "data" (4 a rank: EP, the all-to-all),
    their d_ff on "model". (a) The prefill at MESH_MOE_F32_REPEATS layers
    in bf16, then float32 (the shards cast): the float32 logit shard
    within 1e-3·max|logit| + 1e-3 of the unsharded step's with the same
    groups (world 1's), the bf16 distance and equal argmax recorded; layer
    0's MoE FFN's routing against world 1's (:func:`moe_layer_world4`). (b)
    MESH_MOE_W4_STEPS bf16 train steps at MESH_MOE_TRAIN_REPEATS layers,
    loss, xent, moe_aux and grad_norm against world 1's unsharded steps with
    the same groups (recorded, not bounded); then float32: each rank in
    turn runs the unsharded steps on the whole weights and keeps its
    slices of the result, then the sharded steps, each step's metrics
    within MESH_TRAIN_TOL of the unsharded step's, every weight and moment
    shard within MESH_TRAIN_TOL x max|leaf| after the last. Not through
    ``run_training``: its final checkpoint of this 20.6 GB state, gathered
    through gloo onto the first rank, took 37.1 s on an H100 80GB HBM3 at
    700 W, half of what the step may add to the script. The loop's sharded
    save runs on step ``train``'s state; that of a state with expert
    leaves split on "data" is held on the CPU only
    (tests/test_torch_sharded_moe.py). Each rank holds its
    shard bytes, only the norms whole. Each sharded step counted
    (:func:`counted_mesh_step`)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    from repro_torch.launch import sharding as shd
    t0 = time.perf_counter()
    shape = (ml.axis_size(mesh, "data"), ml.axis_size(mesh, "model"))
    coord = ml.coordinate(mesh)
    line = dict(mesh=ml.mesh_shape(mesh))
    # ---- (a) the prefill ---------------------------------------------------
    plan = moe_plan(mesh, "prefill", MESH_MOE_F32_REPEATS)
    cfg = plan.cfg
    if cfg.moe_groups != MESH_MOE_W4_GROUPS:
        raise AssertionError(f"plan_cell set {cfg.moe_groups} groups")
    model = build_lm_model(cfg)
    params, _ = init_weights(model, MESH_MOE_SEED)
    sh = shd.shard_params(model.param_shapes(), mesh)
    lp = shd.local_params(params, sh, mesh)
    whole = whole_leaves(lp, params)
    local_bytes = tree_bytes(lp)
    if local_bytes != shd.shard_bytes(model.param_shapes(), sh) or \
            whole != MESH_MOE_WHOLE_LEAVES:
        raise AssertionError(f"mesh moe world 4 prefill: {local_bytes} "
                             f"bytes, whole leaves {whole}")
    line["prefill_weights"] = dict(local_bytes=local_bytes, share=(
        local_bytes / tree_bytes(params)), whole_leaves=sorted(whole))
    del params
    torch.cuda.empty_cache()
    batch = shard_batch({"tokens": moe_tokens(cfg)}, mesh)
    refs = np.load(work / "moe_prefill_refs.npz")
    rows = PREFILL_B // shape[0]
    vocab = cfg.padded_vocab // shape[1]
    lo_b, lo_v = coord["data"] * rows, coord["model"] * vocab
    formula = moe_collectives(cfg, shape, PREFILL_B, PREFILL_S, False)
    line["prefill"] = dict(layers=cfg.n_layers, batch=PREFILL_B,
                           seq=PREFILL_S, groups=cfg.moe_groups,
                           collectives=formula)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        cfg_d = dataclasses.replace(cfg, param_dtype=name)
        fn = plan.fn if dtype == torch.bfloat16 else build_prefill_step(
            build_lm_model(cfg_d), act_spec=plan.act_spec)
        p = moe_weights_in(lp, dtype)
        got, run = counted_mesh_step(fn, (p, batch), cfg_d, dtype, formula,
                                     f"mesh moe world 4 prefill {name}")
        del p
        ref = torch.from_numpy(refs[name][lo_b:lo_b + rows, :,
                                          lo_v:lo_v + vocab]).to(DEV)
        err = float((got - ref).abs().max())
        run.update(vs_unsharded_max_abs=err, argmax_equal=int(
            (got.argmax(-1) == ref.argmax(-1)).sum()), rows=rows)
        if dtype == torch.float32:
            tol = 1e-3 * float(ref.abs().max()) + 1e-3
            if not err <= tol:
                raise AssertionError(f"mesh moe world 4 float32 prefill: "
                                     f"{err} from the unsharded, limit {tol}")
            run.update(tol=tol, share_of_tol=err / tol)
        line[f"prefill_{name}"] = run
        del got, ref
    line["moe_layer"] = moe_layer_world4(plan, lp, batch, work, coord, shape)
    del lp
    torch.cuda.empty_cache()
    # ---- (b) the train steps -----------------------------------------------
    plan = moe_plan(mesh, "train", MESH_MOE_TRAIN_REPEATS)
    cfg = plan.cfg
    formula = moe_collectives(cfg, shape, TRAIN_B, TRAIN_S, True)
    w1 = json.loads((work / "moe_train_refs.json").read_text())

    def batch_fn(s):
        return shard_batch(train_batch(cfg, s), mesh)

    def local_state(dtype) -> tuple:
        """(the model in ``dtype``, its shardings, those of its state, this
        rank's state from the seed's weights, the leaves left whole)."""
        model_ = build_lm_model(dataclasses.replace(
            cfg, param_dtype=str(dtype).split(".")[1]))
        whole_p = moe_weights_in(init_weights(build_lm_model(cfg),
                                       MESH_MOE_SEED)[0], dtype)
        sh_, state_sh_ = train_state_sh(model_, mesh)
        local = shd.local_params(whole_p, sh_, mesh)
        whole = whole_leaves(local, whole_p)
        del whole_p
        torch.cuda.empty_cache()
        return (model_, sh_, state_sh_,
                {"params": local, "opt": adamw.init(local)}, whole)

    # bf16: counted steps, recorded against world 1's unsharded steps
    model_, sh_, state_sh_, st, whole = local_state(torch.bfloat16)
    if whole != MESH_MOE_WHOLE_LEAVES:
        raise AssertionError(f"mesh moe world 4 train: whole {whole}")
    runs = []
    for k in range(MESH_MOE_W4_STEPS):
        st, met, run = counted_train_step(plan.fn, st, batch_fn(k), cfg,
                                          torch.bfloat16, formula,
                                          f"mesh moe world 4 step {k}")
        runs.append(dict(run, vs_unsharded=metric_distance(
            met, w1[k], MOE_METRICS)))
    line["train_bfloat16"] = dict(steps=runs, bytes=state_bytes(
        st, model_, sh_, state_sh_, "mesh moe world 4 train bf16"),
        whole_leaves=sorted(whole))
    del st
    torch.cuda.empty_cache()
    # float32: the unsharded steps with the same groups, one rank at a time
    # (≈ 57 GB each), this rank's slices of the last state kept
    ref_model = build_lm_model(dataclasses.replace(
        cfg, param_dtype="float32", moe_groups=MESH_MOE_W4_GROUPS))
    ref_sh, ref_state_sh = train_state_sh(ref_model, mesh)
    refs, line["turns_seconds"] = in_turns(mesh, 1, lambda: unsharded_refs(
        ref_model, init_weights(build_lm_model(cfg), MESH_MOE_SEED)[0], cfg,
        mesh, ref_sh, ref_state_sh, False, MESH_MOE_W4_STEPS,
        each=False)[0])
    model32, sh_, state_sh_, st, _whole = local_state(torch.float32)
    fn32 = build_train_step(model32, MESH_TRAIN_OPT, act_spec=plan.act_spec)
    runs = []
    for k in range(MESH_MOE_W4_STEPS):
        st, met, run = counted_train_step(fn32, st, batch_fn(k), cfg,
                                          torch.float32, formula,
                                          f"mesh moe world 4 step {k}")
        m = metric_distance(met, refs[k]["metrics"], MOE_METRICS)
        if not (m["lr_equal"] and max(m[n] for n in MOE_METRICS) <= 1.0):
            raise AssertionError(f"mesh moe world 4 float32 step {k}: {m}")
        runs.append(dict(run, vs_unsharded=m))
    d = leaf_distance(st, refs[-1]["state"], scale=refs[-1]["scale"])
    if not d["share_of_tol"] <= 1.0:
        raise AssertionError(f"mesh moe world 4 float32: {d}")
    line["train_float32"] = dict(steps=runs, leaves=d, bytes=state_bytes(
        st, model32, sh_, state_sh_, "mesh moe world 4 train float32"))
    line["train"] = dict(layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
                         groups=cfg.moe_groups, collectives=formula)
    del st, refs
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return line


# ---------------------------------------------------------------------------
# Phase mesh, step recurrent: jamba-v0.1-52b's Mamba (beside its attention
# and MoE slots) and xlstm-350m's mLSTM and sLSTM in the sharded prefill and
# train steps, through plan_cell's plans (SP off: the stacks are not
# attention-only)
# ---------------------------------------------------------------------------

MESH_REC_SEED = REC_SEED + 29
#: jamba's slots: world 1's bf16 prefill runs one period (0: all 8, as
#: lm_recurrent serves it); world 1's float32 prefill and world 4's the
#: first two, ("mamba", "dense") and ("mamba", "moe"); the train steps the
#: first alone (0.81 B parameters: the ("mamba", "moe") slot is 2.9 B,
#: ≈ 81 GB at ≈ 28 bytes a parameter for a step from a state)
MESH_REC_JAMBA_PREFILL_SLOTS, MESH_REC_JAMBA_TRAIN_SLOTS = 2, 1
#: xlstm-350m cut to one repeat of its pattern: one mLSTM and one sLSTM
MESH_REC_XLSTM_REPEATS = 1
#: world 1's bit-equal train steps of each config; world 4's steps a dtype
MESH_REC_STEPS = {JAMBA_ARCH: 1, XLSTM_ARCH: 2}
MESH_REC_W4_STEPS = 1
#: world 4's xlstm sequence (prefill and train). Not cut: at 512 one
#: element of sLSTM's normalizer n (of 2 x 4 x 256 x 512) lay within
#: 1.2e-6 of the kink of max(|n|, 1), the unsharded and sharded float32
#: steps (n 1e-5 apart) took its two sides, and the gradient's leaves left
#: the tolerance (3.33x on m of w_in; PERF.md §6)
MESH_REC_W4_XLSTM_S = TRAIN_S
#: world 4's prefill depth (jamba's slots, 0: xlstm's one repeat) by
#: (arch, dtype): jamba's float32 prefill at its first slot alone (at two
#: slots it took 5.1 s of a 60.3 s step, whose limit is 60 s; H100 80GB
#: HBM3, 700.00 W): its MoE slot runs in bf16
MESH_REC_W4_PREFILL_SLOTS = {
    (JAMBA_ARCH, "bfloat16"): MESH_REC_JAMBA_PREFILL_SLOTS,
    (JAMBA_ARCH, "float32"): 1,
    (XLSTM_ARCH, "bfloat16"): 0, (XLSTM_ARCH, "float32"): 0}
#: the dispatch groups of world 4's jamba (plan_cell's |dp|·|model|)
MESH_REC_W4_GROUPS = 4
#: world 4's ranks run the float32 train step without a mesh this many at
#: a time (jamba's first slot ≈ 25 GB each, xlstm's two layers ≈ 3 GB)
MESH_REC_TURN = {JAMBA_ARCH: 2, XLSTM_ARCH: 4}
#: the leaves a rank holds whole: the norms and the mixers' whole leaves
MESH_REC_WHOLE = {
    JAMBA_ARCH: {"final_norm", "norm1", "norm2", "dt_bias", "A_log", "D"},
    XLSTM_ARCH: {"final_norm", "norm1", "out_norm", "r_rec", "bias"}}
#: the metrics a recurrent train step is held to (jamba's first slot and
#: xlstm have no MoE: moe_aux is 0)
REC_METRICS = ("loss", "xent", "grad_norm")


def recurrent_collectives(cfg, shape: tuple, B: int, S: int,
                          train: bool, sp: bool = False) -> dict:
    """PERF.md §6's count of a sharded prefill (``train`` False) or train
    step of a stack of ``attn``, ``mamba``, ``mlstm`` and ``slstm`` mixers
    with ``dense``, ``moe`` or no FFNs on a (|data|, |model|) mesh, B x S
    tokens, SP as ``plan_cell`` sets it for a stack that is not
    attention-only (off), every split dim dividing its axis. A layer:

    * with SP, a sequence gather before the mixer and before a dense or
      MoE FFN (unless the MoE is ``direct``);
    * Mamba: 2 FSDP gathers (in_proj, out_proj), 1 column product and the
      x/z exchange (a head gather), 3 row products (bc_proj and dt_proj
      all-reduced whole, out_proj reduced over "model"), a head gather of
      the conv's output where the channels cut a head; 6 leaf sums a slot
      (conv_w, bc_proj, dt_proj, dt_bias, A_log, D);
    * mLSTM: 6 FSDP gathers, 5 column products (up_proj, wq, wk, wv, w_if)
      and the x/z exchange, 3 head gathers (q, k, v) where its columns cut
      a head, 1 row product (down_proj); 2 leaf sums (w_if, out_norm);
    * sLSTM: 2 FSDP gathers, 2 column products (w_in, out_proj), a head
      gather of the pre-activations where the split cuts a head or else of
      the heads' h where |model| > 1, 1 of out_proj's output; 2 leaf sums
      (r_rec, bias);
    * attention, dense and MoE FFNs as :func:`moe_collectives`;
    * a leaf sum for each norm of a slot.

    A step: the embedding's and head's FSDP gathers and the embedding's sum
    over "model"; the prefill's last-position broadcast (SP); the train
    step's sequence gather before the head, the loss's 3 + 1 all-reduces,
    the transposes (the loss's backward 2 all-reduces), AdamW's norm
    sum."""
    dsz, msz = shape
    D, R = cfg.d_model, cfg.repeats
    E = 2 * D
    sp = sp and S % msz == 0
    calls = dict.fromkeys(("fsdp_gather", "column", "row", "sp_gather",
                           "head_gather", "embed", "head", "last_position",
                           "moe"), 0)
    n = dict(ag=0, rs=0, ar=0, a2a=0)
    leaf = 1                                      # final_norm

    def add(key, k=1):                            # k a layer, R layers
        if key in calls:
            calls[key] += R * k
        else:
            n[key] += R * k
    reduce_model = "rs" if sp else "ar"           # a row product's sum
    G = cfg.moe_groups if (B * S) % cfg.moe_groups == 0 else 1
    shared = (G // dsz) % msz != 0
    direct = sp and B // dsz == 1 and not shared
    for mixer, ffn in cfg.pattern:
        add("sp_gather", sp)
        leaf += 1                                 # norm1
        if mixer == "mamba":
            add("fsdp_gather", 2)
            add("column")
            add("row", 3)
            add("head_gather", 1 + ((E // msz) % cfg.ssm_head_p != 0))
            add("ar", 2)
            add(reduce_model)
            leaf += 6
        elif mixer == "mlstm":
            add("fsdp_gather", 6)
            add("column", 5)
            add("row")
            add("head_gather", 1 + 3 * ((E // (D // cfg.n_heads)) % msz
                                        != 0))
            add(reduce_model)
            leaf += 2
        elif mixer == "slstm":
            add("fsdp_gather", 2)
            add("column", 2)
            add("head_gather", int(msz > 1) + 1)
            leaf += 2
        else:
            add("fsdp_gather", 4)
            add("column", 3)
            add("row")
            add("head_gather", 2 * (cfg.n_kv_heads % msz != 0)
                + (cfg.n_heads % msz != 0))
            add(reduce_model)
            leaf += 2 * cfg.qk_norm
        if ffn == "dense":
            add("sp_gather", sp)
            add("fsdp_gather", 3 if cfg.act == "swiglu" else 2)
            add("column", 2 if cfg.act == "swiglu" else 1)
            add("row")
            add(reduce_model)
            leaf += 1                             # norm2
        elif ffn == "moe":
            ep = cfg.n_experts % dsz == 0
            ff = cfg.expert_d_ff % msz == 0
            add("moe")
            add("fsdp_gather")                    # the router
            add("sp_gather", sp and not direct)
            add("ag", (ff and not shared) + (not direct and not shared))
            add("rs", ff and not shared)
            add("ar", (ff and shared) + 1)        # + aux
            add("a2a", 2 * ep)
            leaf += 2 + 3 * (not (ep and ff))     # norm2, the router
    calls["fsdp_gather"] += 2
    calls["embed"] = calls["head"] = 1
    n[reduce_model] += 1                          # the embedding's sum
    calls["last_position"] = int(not train)
    calls["sp_gather"] += sp and train
    gathers = calls["fsdp_gather"] + calls["sp_gather"] \
        + calls["head_gather"] + n["ag"]
    fwd = dict(all_gather=gathers, reduce_scatter=n["rs"],
               all_reduce=n["ar"] + 4 * train,
               broadcast=int(sp and not train), all_to_all=n["a2a"])
    out = {"calls": calls, "collectives": fwd}
    if train:
        out["backward"] = dict(all_gather=n["rs"], reduce_scatter=gathers,
                               all_reduce=n["ar"] + 2, all_to_all=n["a2a"],
                               leaf_sum=leaf, norm_sum=1)
    return out


def rec_plan(mesh, arch: str, kind: str, slots: int = 0):
    """``plan_cell``'s plan of ``arch`` on ``mesh`` (its prefill_32k or
    train_4k plan, on the card): jamba at one repeat, its pattern cut to
    the first ``slots`` slots (0: the whole period), xlstm at
    MESH_REC_XLSTM_REPEATS. Raises unless the plan's layout is SP off."""
    from repro_torch.launch.steps import plan_cell
    cfg = get_lm_config(arch)
    over = (dict(repeats=MESH_REC_XLSTM_REPEATS) if arch == XLSTM_ARCH
            else dict(repeats=1, pattern=cfg.pattern[:slots or None]))
    plan = plan_cell(arch, "prefill_32k" if kind == "prefill" else
                     "train_4k", mesh, opt_cfg=MESH_TRAIN_OPT,
                     cfg_overrides=over, device=DEV)
    if plan.act_spec.sequence_parallel:
        raise AssertionError(f"{arch}: plan_cell turned SP on")
    return plan


#: the scale of the leaves the model initializes to 0, drawn from the seed
REC_ZERO_SCALE = 0.02


def rec_weights(model) -> dict:
    """Random weights of ``model`` from MESH_REC_SEED on the card, every
    leaf the model initializes to 0 (Mamba's dt_bias, sLSTM's bias) drawn
    from the seed too, N(0, REC_ZERO_SCALE²): a leaf at 0 is at most lr
    after a step (3e-6 at the first), and world 4's 1e-4·max|leaf| would
    then fall below the float32 rounding of AdamW's update where an
    element's gradient is near AdamW's eps (1e-8)."""
    params, _ = init_weights(model, MESH_REC_SEED)
    gen = torch.Generator(device=DEV).manual_seed(MESH_REC_SEED + 1)
    for leaf in tr.leaves(params):
        if not bool(leaf.any()):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=DEV)
                       * REC_ZERO_SCALE)
    return params


def rec_tokens(cfg, B: int, S: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(MESH_REC_SEED).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int64, device=DEV)


def rec_prefill_world1(mesh, arch: str, slots: int, tokens, dtype,
                       what: str) -> dict:
    """World 1's sharded prefill of ``arch`` (:func:`rec_plan`) on
    ``tokens`` in ``dtype`` (the seed's bf16 weights, cast), its logits
    equal to the unsharded step's bit for bit, ms of both and a second
    sharded run; counted (:func:`counted_mesh_step`)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding as shd
    plan = rec_plan(mesh, arch, "prefill", slots)
    name = str(dtype).split(".")[1]
    cfg = dataclasses.replace(plan.cfg, param_dtype=name)
    model = build_lm_model(cfg)
    params = moe_weights_in(rec_weights(build_lm_model(plan.cfg)), dtype)
    plain = build_prefill_step(model)
    timed_ms(plain, params, {"tokens": tokens})                 # warm
    want, plain_ms = timed_ms(plain, params, {"tokens": tokens})
    lp = shd.local_params(params, shd.shard_params(model.param_shapes(),
                                                   mesh), mesh)
    del params
    fn = plan.fn if dtype == torch.bfloat16 else build_prefill_step(
        model, act_spec=plan.act_spec)
    batch = shard_batch({"tokens": tokens}, mesh)
    formula = recurrent_collectives(cfg, (1, 1), *tokens.shape, False)
    got, run = counted_mesh_step(fn, (lp, batch), cfg, dtype, formula, what)
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the sharded logits are not the "
                             f"unsharded step's: "
                             f"{float((got - want).abs().max())} apart")
    _again, run["ms"] = timed_ms(fn, lp, batch)
    del lp, want, got, _again
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, batch=tokens.shape[0],
                seq=tokens.shape[1], groups=cfg.moe_groups,
                unsharded_ms=plain_ms, equal_to_unsharded=True,
                collectives=formula, **run)


def rec_train_world1(mesh, arch: str, slots: int, what: str) -> tuple:
    """World 1's MESH_REC_STEPS[arch] bf16 train steps of ``arch`` (its
    :func:`rec_plan` train plan) from the seed's weights, each from the
    same state as the step without a mesh and equal to it bit for bit
    (metrics; every leaf by :func:`fingerprint`), ms of both; counted.
    Returns (its line, the unsharded steps' metrics, world 4's bf16
    reference)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding as shd
    plan = rec_plan(mesh, arch, "train", slots)
    cfg = plan.cfg
    model = build_lm_model(cfg)
    params = rec_weights(model)
    plain = build_train_step(model, MESH_TRAIN_OPT)
    local = shd.local_params(params, shd.shard_params(model.param_shapes(),
                                                      mesh), mesh)
    del params
    formula = recurrent_collectives(cfg, (1, 1), TRAIN_B, TRAIN_S, True)
    st = {"params": local, "opt": adamw.init(local)}
    del local
    steps, refs = [], []
    for k in range(MESH_REC_STEPS[arch]):
        b = train_batch(cfg, k)
        (p, o, want), plain_ms = timed_ms(plain, st["params"], st["opt"], b)
        refs.append({m: float(v) for m, v in want.items()})
        want_fp = fingerprint({"params": p, "opt": o})
        del p, o
        torch.cuda.empty_cache()
        st, met, run = counted_train_step(plan.fn, st, shard_batch(b, mesh),
                                          cfg, torch.bfloat16, formula,
                                          f"{what} step {k}")
        if not (fingerprint(st) == want_fp and all(
                torch.equal(met[m], want[m]) for m in want)):
            raise AssertionError(f"{what} step {k}: not bit-equal to the "
                                 f"step without a mesh: "
                                 f"{metric_distance(met, want, REC_METRICS)}")
        steps.append(dict(step=k, plain_ms=plain_ms, bit_equal=True, **run))
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
                steps=steps, collectives=formula), refs


def mesh_recurrent_world1(mesh, work: Path) -> dict:
    """World 1 (NCCL, 1 x 1) through ``plan_cell``'s plans, SP off, every
    case bit-equal to the step without a mesh and counted
    (:func:`counted_mesh_step`): jamba-v0.1-52b at full width, the bf16
    prefill of PREFILL_B x PREFILL_S at one period (8 layers) and the
    float32 one at its first MESH_REC_JAMBA_PREFILL_SLOTS slots, then a
    bf16 train step of TRAIN_B x TRAIN_S at its first slot; xlstm-350m at
    full width and MESH_REC_XLSTM_REPEATS repeat (one mLSTM, one sLSTM),
    its bf16 prefill and two train steps (MESH_REC_STEPS). Writes world 4's
    references: the unsharded prefill logits at world 4's depth
    (MESH_REC_W4_PREFILL_SLOTS), sequence and groups in each dtype, and the
    unsharded bf16 train steps' metrics."""
    t0 = time.perf_counter()
    line = {}
    jamba = get_lm_config(JAMBA_ARCH)
    tokens = rec_tokens(jamba, PREFILL_B, PREFILL_S)
    line["jamba_prefill"] = rec_prefill_world1(
        mesh, JAMBA_ARCH, 0, tokens, torch.bfloat16,
        "mesh recurrent world 1 jamba prefill bf16")
    line["jamba_prefill_float32"] = rec_prefill_world1(
        mesh, JAMBA_ARCH, MESH_REC_JAMBA_PREFILL_SLOTS, tokens,
        torch.float32, "mesh recurrent world 1 jamba prefill float32")
    line["jamba_train"], jamba_refs = rec_train_world1(
        mesh, JAMBA_ARCH, MESH_REC_JAMBA_TRAIN_SLOTS,
        "mesh recurrent world 1 jamba train")
    xl = get_lm_config(XLSTM_ARCH)
    line["xlstm_prefill"] = rec_prefill_world1(
        mesh, XLSTM_ARCH, 0, rec_tokens(xl, PREFILL_B, PREFILL_S),
        torch.bfloat16, "mesh recurrent world 1 xlstm prefill bf16")
    line["xlstm_train"], xlstm_refs = rec_train_world1(
        mesh, XLSTM_ARCH, 0, "mesh recurrent world 1 xlstm train")
    # world 4's references without a mesh, in both dtypes
    t1 = time.perf_counter()
    refs = {}
    for (arch, name), slots in MESH_REC_W4_PREFILL_SLOTS.items():
        cfg = dataclasses.replace(rec_plan(mesh, arch, "prefill",
                                           slots).cfg,
                                  moe_groups=MESH_REC_W4_GROUPS)
        S = PREFILL_S if arch == JAMBA_ARCH else MESH_REC_W4_XLSTM_S
        params = rec_weights(build_lm_model(cfg))
        model = build_lm_model(dataclasses.replace(cfg, param_dtype=name))
        refs[f"{arch}_{name}"] = build_prefill_step(model)(
            moe_weights_in(params, getattr(torch, name)),
            {"tokens": rec_tokens(cfg, PREFILL_B, S)}).cpu().numpy()
        del params
        torch.cuda.empty_cache()
    np.savez(work / "recurrent_prefill_refs.npz", **refs)
    train_refs = {JAMBA_ARCH: jamba_refs[:MESH_REC_W4_STEPS],
                  XLSTM_ARCH: xlstm_refs[:MESH_REC_W4_STEPS]}
    if MESH_REC_W4_XLSTM_S != TRAIN_S:
        # world 4's sequence: the unsharded bf16 steps at its length
        cfg = rec_plan(mesh, XLSTM_ARCH, "train").cfg
        model = build_lm_model(cfg)
        st = rec_weights(model)
        st = (st, adamw.init(st))
        step, train_refs[XLSTM_ARCH] = build_train_step(
            model, MESH_TRAIN_OPT), []
        for k in range(MESH_REC_W4_STEPS):
            *st, met = step(*st, train_batch(cfg, k,
                                             seq=MESH_REC_W4_XLSTM_S))
            train_refs[XLSTM_ARCH].append({m: float(v)
                                           for m, v in met.items()})
        del st
    (work / "recurrent_train_refs.json").write_text(json.dumps(train_refs))
    line["refs_seconds"] = time.perf_counter() - t1
    line["seconds"] = time.perf_counter() - t0
    return line


def rec_world4(mesh, work: Path, arch: str, train_slots: int,
               S: int) -> dict:
    """World 4's cases of ``arch``: the prefill of PREFILL_B x S in bf16,
    then float32 (each at its MESH_REC_W4_PREFILL_SLOTS depth, the seed's
    bf16 weights cast), the float32 logit shard within 1e-3·max|logit| +
    1e-3 of world 1's unsharded step at the same depth and groups, the
    bf16 distance and equal argmax recorded; then
    MESH_REC_W4_STEPS train steps of TRAIN_B x S a dtype: bf16 recorded
    against world 1's unsharded steps, float32 (each rank in turn runs the
    unsharded steps on the whole weights and keeps its slices) with the
    metrics within MESH_TRAIN_TOL and every weight and moment shard within
    MESH_TRAIN_TOL x max|leaf|. Each rank holds its shard bytes, only
    MESH_REC_WHOLE whole; each step counted."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as ml
    from repro_torch.launch import sharding as shd
    shape = (ml.axis_size(mesh, "data"), ml.axis_size(mesh, "model"))
    coord = ml.coordinate(mesh)
    out = {}
    t0 = time.perf_counter()
    parts = out["seconds_by_part"] = {}

    def mark(part):
        nonlocal t0
        parts[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
    # ---- the prefill: each dtype at its MESH_REC_W4_PREFILL_SLOTS depth ---
    refs = np.load(work / "recurrent_prefill_refs.npz")
    rows = PREFILL_B // shape[0]
    lo_b = coord["data"] * rows
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        plan = rec_plan(mesh, arch, "prefill",
                        MESH_REC_W4_PREFILL_SLOTS[arch, name])
        cfg = plan.cfg
        if arch == JAMBA_ARCH and cfg.moe_groups != MESH_REC_W4_GROUPS:
            raise AssertionError(f"plan_cell set {cfg.moe_groups} groups")
        model = build_lm_model(cfg)
        params = rec_weights(model)
        sh = shd.shard_params(model.param_shapes(), mesh)
        lp = shd.local_params(params, sh, mesh)
        whole = whole_leaves(lp, params)
        local_bytes = tree_bytes(lp)
        if local_bytes != shd.shard_bytes(model.param_shapes(), sh) or \
                whole != MESH_REC_WHOLE[arch]:
            raise AssertionError(f"mesh recurrent world 4 {arch}: "
                                 f"{local_bytes} bytes, whole leaves "
                                 f"{whole}")
        weights = dict(local_bytes=local_bytes, share=(
            local_bytes / tree_bytes(params)), whole_leaves=sorted(whole))
        del params
        torch.cuda.empty_cache()
        batch = shard_batch({"tokens": rec_tokens(cfg, PREFILL_B, S)}, mesh)
        vocab = cfg.padded_vocab // shape[1]
        lo_v = coord["model"] * vocab
        formula = recurrent_collectives(cfg, shape, PREFILL_B, S, False)
        cfg_d = dataclasses.replace(cfg, param_dtype=name)
        fn = plan.fn if dtype == torch.bfloat16 else build_prefill_step(
            build_lm_model(cfg_d), act_spec=plan.act_spec)
        p = moe_weights_in(lp, dtype)
        del lp
        got, run = counted_mesh_step(fn, (p, batch), cfg_d, dtype, formula,
                                     f"mesh recurrent world 4 {arch} "
                                     f"prefill {name}")
        del p
        ref = torch.from_numpy(refs[f"{arch}_{name}"][
            lo_b:lo_b + rows, :, lo_v:lo_v + vocab]).to(DEV)
        err = float((got - ref).abs().max())
        run.update(layers=cfg.n_layers, batch=PREFILL_B, seq=S,
                   groups=cfg.moe_groups, collectives=formula,
                   weights=weights, vs_unsharded_max_abs=err,
                   argmax_equal=int((got.argmax(-1) == ref.argmax(-1)).sum()),
                   rows=rows)
        if dtype == torch.float32:
            tol = 1e-3 * float(ref.abs().max()) + 1e-3
            if not err <= tol:
                raise AssertionError(f"mesh recurrent world 4 {arch} "
                                     f"float32 prefill: {err} from the "
                                     f"unsharded, limit {tol}")
            run.update(tol=tol, share_of_tol=err / tol)
        out[f"prefill_{name}"] = run
        del got, ref
        torch.cuda.empty_cache()
    mark("prefill")
    # ---- the train steps ---------------------------------------------------
    plan = rec_plan(mesh, arch, "train", train_slots)
    cfg = plan.cfg
    formula = recurrent_collectives(cfg, shape, TRAIN_B, S, True)
    w1 = json.loads((work / "recurrent_train_refs.json").read_text())[arch]

    def batch_fn(s):
        return shard_batch(train_batch(cfg, s, seq=S), mesh)

    def local_state(dtype) -> tuple:
        model_ = build_lm_model(dataclasses.replace(
            cfg, param_dtype=str(dtype).split(".")[1]))
        whole_p = moe_weights_in(rec_weights(build_lm_model(cfg)), dtype)
        sh_, state_sh_ = train_state_sh(model_, mesh)
        local = shd.local_params(whole_p, sh_, mesh)
        whole_ = whole_leaves(local, whole_p)
        if whole_ != MESH_REC_WHOLE[arch]:
            raise AssertionError(f"mesh recurrent world 4 {arch} train: "
                                 f"whole {whole_}")
        del whole_p
        torch.cuda.empty_cache()
        return (model_, sh_, state_sh_,
                {"params": local, "opt": adamw.init(local)})

    model_, sh_, state_sh_, st = local_state(torch.bfloat16)
    runs = []
    for k in range(MESH_REC_W4_STEPS):
        st, met, run = counted_train_step(
            plan.fn, st, batch_fn(k), cfg, torch.bfloat16, formula,
            f"mesh recurrent world 4 {arch} step {k}")
        runs.append(dict(run, vs_unsharded=metric_distance(
            met, w1[k], REC_METRICS)))
    out["train_bfloat16"] = dict(steps=runs, bytes=state_bytes(
        st, model_, sh_, state_sh_, f"mesh recurrent world 4 {arch} bf16"))
    del st
    torch.cuda.empty_cache()
    mark("train_bfloat16")
    ref_model = build_lm_model(dataclasses.replace(cfg,
                                                   param_dtype="float32"))
    ref_sh, ref_state_sh = train_state_sh(ref_model, mesh)
    refs, out["turns_seconds"] = in_turns(
        mesh, MESH_REC_TURN[arch], lambda: unsharded_refs(
            ref_model, rec_weights(build_lm_model(cfg)),
            cfg, mesh, ref_sh, ref_state_sh, False, MESH_REC_W4_STEPS,
            each=False, batch_fn=lambda k: train_batch(cfg, k, seq=S))[0])
    mark("turns")
    model32, sh_, state_sh_, st = local_state(torch.float32)
    fn32 = build_train_step(model32, MESH_TRAIN_OPT, act_spec=plan.act_spec)
    runs = []
    for k in range(MESH_REC_W4_STEPS):
        st, met, run = counted_train_step(
            fn32, st, batch_fn(k), cfg, torch.float32, formula,
            f"mesh recurrent world 4 {arch} step {k}")
        m = metric_distance(met, refs[k]["metrics"], REC_METRICS)
        if not (m["lr_equal"] and max(m[n] for n in REC_METRICS) <= 1.0):
            raise AssertionError(f"mesh recurrent world 4 {arch} float32 "
                                 f"step {k}: {m}")
        runs.append(dict(run, vs_unsharded=m))
    d = leaf_distance(st, refs[-1]["state"], scale=refs[-1]["scale"])
    if not d["share_of_tol"] <= 1.0:
        raise AssertionError(f"mesh recurrent world 4 {arch} float32: {d}")
    out["train_float32"] = dict(steps=runs, leaves=d, bytes=state_bytes(
        st, model32, sh_, state_sh_, f"mesh recurrent world 4 {arch} f32"))
    out["train"] = dict(layers=cfg.n_layers, batch=TRAIN_B, seq=S,
                        collectives=formula)
    del st, refs
    torch.cuda.empty_cache()
    mark("train_float32")
    return out


def mesh_recurrent_world4(mesh, work: Path) -> dict:
    """World 4 (gloo, 2 x 2, four processes on the card) through
    ``plan_cell``'s plans, SP off (:func:`rec_world4`): jamba-v0.1-52b at
    full width, its first MESH_REC_JAMBA_PREFILL_SLOTS slots prefilled in
    bf16 (4 dispatch groups, its 16 experts split on "data", d_ff on
    "model") and its first slot in float32, its first slot trained;
    xlstm-350m at full width and
    MESH_REC_XLSTM_REPEATS repeat over MESH_REC_W4_XLSTM_S positions.
    Not through ``run_training``: the loop's sharded save is held on step
    ``train``'s state here, and on a recurrent state on the CPU
    (tests/test_torch_sharded_recurrent.py)."""
    t0 = time.perf_counter()
    line = {}
    for arch, train_slots, S in (
            (JAMBA_ARCH, MESH_REC_JAMBA_TRAIN_SLOTS, PREFILL_S),
            (XLSTM_ARCH, 0, MESH_REC_W4_XLSTM_S)):
        t1 = time.perf_counter()
        line[arch] = rec_world4(mesh, work, arch, train_slots, S)
        line[arch]["seconds"] = time.perf_counter() - t1
    line["seconds"] = time.perf_counter() - t0
    return line


def run_mesh_rank(rank: int, world: int, init: str, work: str,
                  gate: str = "") -> None:
    """One rank of phase mesh (``python3 chip_smoke.py --mesh-rank RANK
    WORLD INIT DIR [GATE]``): world 1 on NCCL, a (1, 1) mesh; world 4 on
    gloo, a (2, 2) mesh of four processes sharing the card. With GATE the
    rank, its imports done, waits for that file before it touches the card
    (world 4 starts while world 1 runs). Writes its line as
    ``DIR/world<W>_rank<R>.json``."""
    from repro_torch.launch import mesh as ml
    work = Path(work)
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while gate and not Path(gate).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"mesh rank {rank}: no {gate}")
        time.sleep(0.05)
    t0 = time.perf_counter()
    backend = ml.init_world("nccl" if world == 1 else "gloo", rank=rank,
                            world_size=world, init_method=init)
    mesh = ml.make_test_mesh((1, 1) if world == 1 else (2, 2),
                             ("data", "model"))
    line = dict(rank=rank, world=world, backend=backend,
                coordinate=ml.coordinate(mesh),
                start_seconds=time.perf_counter() - t0)
    if world == 1:
        line["service_sweep"] = mesh_service_sweep(mesh, work)
    line["sweeps"] = mesh_sharded_sweeps(mesh, world, work, work)
    line["decode"] = mesh_cp_decode(mesh, world, work)
    line["prefill"] = mesh_prefill(mesh, world, work)
    t_train = time.perf_counter()
    if world == 1:
        line["train"] = mesh_train_world1(mesh, work)
    else:
        line["cp_attention"] = mesh_cp_attention(mesh)
        t_train = time.perf_counter()
        line["train"], keep = mesh_train_world4(mesh, work)
    line["train"]["seconds"] = time.perf_counter() - t_train
    # step moe: mixtral-8x7b's sharded prefill and train step
    line["moe"] = (mesh_moe_world1 if world == 1 else mesh_moe_world4)(
        mesh, work)
    # step recurrent: jamba's Mamba, xlstm's mLSTM and sLSTM sharded
    t_rec = time.perf_counter()
    line["recurrent"] = (mesh_recurrent_world1 if world == 1
                         else mesh_recurrent_world4)(mesh, work)
    line["recurrent"]["seconds"] = time.perf_counter() - t_rec
    ml.barrier(mesh)
    torch.distributed.destroy_process_group()
    if world > 1 and rank == 0:
        # the elastic check: world 4's checkpoint on a world of one
        t_elastic = time.perf_counter()
        line["train"]["elastic"] = mesh_train_elastic(work, keep)
        line["train"]["seconds"] += time.perf_counter() - t_elastic
        del keep
    line["seconds"] = time.perf_counter() - t0
    (work / f"world{world}_rank{rank}.json").write_text(json.dumps(line))


def mesh_service_sweep(mesh, work: Path) -> dict:
    """``SimulationService(mesh=).sweep`` of the divisible main path's p=256
    sweep on the (1, 1) NCCL mesh: one launch a chunk, and the store's keys
    and npz bytes those of phase main_path."""
    s = MAIN_PATHS["divisible"]["sweeps"][0]
    root = work / "mesh_store"
    svc = SimulationService(root=root, mesh=mesh)
    ws.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pinned_zip_clock():
        g = svc.sweep(s["topo"](), backend="cuda", **s["kw"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_chunks = math.ceil(len(g) / s["kw"]["chunk_size"])
    if ws.ws_sim_cuda.launches_by_body["ws_sim_divisible"] != n_chunks or \
            ws.ws_sim_cuda.launches != n_chunks:
        raise AssertionError(f"mesh service sweep: "
                             f"{ws.ws_sim_cuda.launches_by_body}, expected "
                             f"{n_chunks} launches")
    keys = sorted(p.stem for p in root.glob("*.npz"))
    main = work / "main_store"
    if len(keys) != n_chunks:
        raise AssertionError(f"mesh service sweep stored {keys}")
    for k in keys:
        for ext in (".npz", ".json"):
            if (root / f"{k}{ext}").read_bytes() != \
                    (main / f"{k}{ext}").read_bytes():
                raise AssertionError(f"mesh service sweep: {k}{ext} differs "
                                     "from phase main_path's")
    return dict(sweep=s["name"], rows=len(g), chunks=n_chunks,
                launches=n_chunks, wall_seconds=wall,
                rows_per_second=len(g) / wall, keys_and_bytes_equal=True)


def mesh_spawn(world: int, work: Path, gate: Path = None) -> list:
    """Start the ``world`` ranks of phase mesh, each a process of its own
    on the card, all together (behind ``gate``: :func:`run_mesh_rank`).
    Returns (process, log) pairs for :func:`mesh_wait`."""
    from repro_torch.launch import mesh as ml
    init = f"tcp://localhost:{ml.free_port()}"
    while init in MESH_INITS:       # not the rendezvous of another world
        init = f"tcp://localhost:{ml.free_port()}"
    MESH_INITS.add(init)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ranks = []
    try:
        for r in range(world):
            log = work / f"world{world}_rank{r}.log"
            with open(log, "w") as f:
                ranks.append((subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mesh-rank", str(r), str(world), init, str(work)]
                    + ([str(gate)] if gate else []),
                    stdout=f, stderr=subprocess.STDOUT, text=True, env=env),
                    log))
    except BaseException:
        mesh_reap(ranks)
        raise
    return ranks


#: the rendezvous addresses of the worlds started by :func:`mesh_spawn`
MESH_INITS = set()


def mesh_reap(ranks: list) -> None:
    for p, _log in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


def mesh_wait(world: int, work: Path, ranks: list) -> list:
    """Wait for the ranks of :func:`mesh_spawn`; a failed or hung rank
    fails the phase with its output's tail, and every rank is reaped."""
    try:
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p, _log in ranks:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        mesh_reap(ranks)
    for r, (p, log) in enumerate(ranks):
        if p.returncode != 0:
            raise AssertionError(f"mesh world {world} rank {r} exited "
                                 f"{p.returncode}:\n"
                                 f"{log.read_text()[-4000:]}")
    return [json.loads((work / f"world{world}_rank{r}.json").read_text())
            for r in range(world)]


def phase_mesh(work: Path) -> dict:
    """The mesh on the card, in processes of their own (no process group
    is left in this one). ``work`` holds phase main_path's divisible store
    (``main_store``) and lm_main_path's prompts and tokens
    (``lm_tokens.npz``). (a) A world of one NCCL rank: the service's
    sharded sweep with main_path's keys and bytes, the three paths'
    sharded sweeps equal to ``run_rows()``, qwen3-1.7b's context-parallel
    decode in a CUDA graph beside the served step and the one-shard
    witness (:func:`mesh_cp_decode`). (b) Four gloo ranks on the one card,
    a (2, 2) mesh: the same sweeps equal to world 1's field for field,
    each rank launching one kernel a sweep on its quarter, the decode with
    the batch over "data" and the sequence over "model" giving world 1's
    logits and tokens, and one layer's attention at MESH_ATTN
    (:func:`mesh_cp_attention`). Each world also prefills qwen3-1.7b with
    its weights split by the placement rules (:func:`mesh_prefill`), and
    trains it with its weights, gradients and AdamW moments split
    (:func:`mesh_train_world1`, :func:`mesh_train_world4`, the elastic
    resume :func:`mesh_train_elastic`), then the MoE steps
    (:func:`mesh_moe_world1`, :func:`mesh_moe_world4`) and the recurrent
    mixers' (:func:`mesh_recurrent_world1`, :func:`mesh_recurrent_world4`:
    one ``mesh_recurrent`` line a rank, a ``recurrent_summary`` line).
    Returns the ``ws_sim`` launches of each rank and world by body, and the
    sharded steps' ``rms_norm`` and ``flash_attention`` launches."""
    torch.cuda.empty_cache()
    main_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    # world 4's ranks import while world 1 runs, and start once it is done
    # (world 4 reads what world 1 wrote, and both do not fit on the card)
    gate = work / "world1_done"
    ranks1, ranks4 = mesh_spawn(1, work), []
    try:
        ranks4 = mesh_spawn(4, work, gate)
        one = mesh_wait(1, work, ranks1)[0]
        gate.touch()
        say("mesh", **{k: v for k, v in one.items() if k != "recurrent"},
            card=card_line())
        say("mesh", step="mesh_recurrent", world=1, rank=0,
            **one["recurrent"], card=card_line())
        four = mesh_wait(4, work, ranks4)
    finally:
        mesh_reap(ranks1 + ranks4)
    for r in four:
        say("mesh", **{k: v for k, v in r.items() if k != "recurrent"})
        say("mesh", step="mesh_recurrent", world=4, rank=r["rank"],
            **r["recurrent"])
    launches = {b: {"world1": 0, "world4": [0] * 4} for b in BODIES}
    for path, line in one["sweeps"].items():
        body = MAIN_PATHS[path]["body"]
        launches[body]["world1"] += line["launches_by_body"][body]
        for r in four:
            launches[body]["world4"][r["rank"]] += \
                r["sweeps"][path]["launches_by_body"][body]
    launches["ws_sim_divisible"]["world1_service"] = \
        one["service_sweep"]["launches"]
    # the prefill's kernels: its bf16 and its float32 step, each rank
    for k in ("rms_norm", "flash_attention"):
        launches[k] = {"prefill_world1": sum(
            one["prefill"][dt]["launches"][k] for dt in ("bf16", "float32")),
            "prefill_world4": [sum(r["prefill"][dt]["launches"][k]
                                   for dt in ("bf16", "float32"))
                               for r in four]}
    # the train steps' kernels: world 1's sharded steps (whole, then at
    # MESH_TRAIN_REPEATS layers in both dtypes), each world-4 rank's (and
    # the first rank's elastic step)
    w1 = one["train"]
    for k in ("rms_norm", "flash_attention"):
        launches[k]["train_world1"] = sum(
            s["launches"][k] for s in w1["steps"]) + sum(
            s["launches"][k] for lines in w1["depth"].values()
            for s in lines)
        launches[k]["train_world4"] = [sum(
            s["launches"][k] for dt in ("bfloat16", "float32")
            for s in r["train"][dt]["steps"]) + r["train"].get(
            "elastic", {}).get("launches", {}).get(k, 0) for r in four]
    # step moe's kernels: each sharded step of each world
    def moe_launches(line, k):
        runs = [v for v in line.values()
                if isinstance(v, dict) and "launches" in v]
        runs += line["train"].get("steps", []) + [
            s for dt in ("bfloat16", "float32")
            for s in line.get(f"train_{dt}", {}).get("steps", [])]
        return sum(r["launches"][k] for r in runs)
    for k in ("rms_norm", "flash_attention"):
        launches[k]["moe_world1"] = moe_launches(one["moe"], k)
        launches[k]["moe_world4"] = [moe_launches(r["moe"], k) for r in four]
    # step recurrent's kernels: each sharded step of each world
    for k in ("rms_norm", "flash_attention"):
        launches[k]["recurrent_world1"] = sum(
            r["launches"][k] for r in launch_runs(one["recurrent"]))
        launches[k]["recurrent_world4"] = [sum(
            r_["launches"][k] for r_ in launch_runs(r["recurrent"]))
            for r in four]
    recurrent_summary(one["recurrent"], [r["recurrent"] for r in four])
    m1, m4 = one["moe"], [r["moe"] for r in four]
    say("mesh", step="moe_summary",
        world1=dict(
            prefill_ms=m1["prefill"]["ms"],
            unsharded_prefill_ms=m1["prefill"]["unsharded_ms"],
            prefill_peak_gib=m1["prefill"]["peak_gib"],
            float32_prefill_ms=m1["prefill_float32"]["ms"],
            unsharded_float32_prefill_ms=m1["prefill_float32"][
                "unsharded_ms"],
            float32_equal_to_unsharded=m1["prefill_float32"][
                "equal_to_unsharded"],
            train_ms=[s["ms"] for s in m1["train"]["steps"]],
            unsharded_train_ms=[s["plain_ms"] for s in m1["train"]["steps"]],
            train_peak_gib=max(s["peak_gib"] for s in m1["train"]["steps"]),
            bit_equal=all(s["bit_equal"] for s in m1["train"]["steps"]),
            prefill_collectives=m1["prefill"]["collectives"],
            train_collectives=m1["train"]["collectives"],
            seconds=m1["seconds"]),
        world4=dict(
            prefill_seconds={dt: [r[f"prefill_{dt}"]["ms"] / 1e3
                                  for r in m4]
                             for dt in ("bfloat16", "float32")},
            prefill_float32_share_of_tol=max(
                r["prefill_float32"]["share_of_tol"] for r in m4),
            prefill_bf16_max_abs=max(r["prefill_bfloat16"][
                "vs_unsharded_max_abs"] for r in m4),
            prefill_bf16_argmax_equal=sum(r["prefill_bfloat16"][
                "argmax_equal"] for r in m4),
            weight_share=[r["prefill_weights"]["share"] for r in m4],
            train_seconds={dt: [[s["ms"] / 1e3 for s in r[f"train_{dt}"][
                "steps"]] for r in m4] for dt in ("bfloat16", "float32")},
            peak_gib=[max(s["peak_gib"] for dt in ("bfloat16", "float32")
                          for s in r[f"train_{dt}"]["steps"]) for r in m4],
            float32_worst_share_of_tol=max(
                max([r["train_float32"]["leaves"]["share_of_tol"]] + [
                    max(v for k, v in s["vs_unsharded"].items()
                        if k != "lr_equal")
                    for s in r["train_float32"]["steps"]]) for r in m4),
            bf16_vs_unsharded=[s["vs_unsharded"] for s in m4[0][
                "train_bfloat16"]["steps"]],
            weight_and_moment_share=[r["train_float32"]["bytes"]["local"]
                                     / r["train_float32"]["bytes"]["whole"]
                                     for r in m4],
            turns_seconds=m4[0]["turns_seconds"],
            layer=dict((k, m4[0]["moe_layer"][k]) for k in (
                "dropped", "stolen", "aux", "y_vs_unsharded_max_abs")),
            collectives=dict(prefill=m4[0]["prefill"]["collectives"],
                             train=m4[0]["train"]["collectives"]),
            seconds=[r["seconds"] for r in m4]),
        card=card_line())
    say("mesh", step="train_summary",
        world1=dict(
            ms=[s["ms"] for s in w1["steps"]],
            unsharded_ms=[s["plain_ms"] for s in w1["steps"]],
            peak_gib=max(s["peak_gib"] for s in w1["steps"]),
            step_gib=max(s["step_gib"] for s in w1["steps"]),
            bit_equal=w1["bit_equal"],
            worst_share_of_tol=max(s["leaves"]["share_of_tol"]
                                   for s in w1["steps"]),
            losses=[s["loss"] for s in w1["steps"]],
            collectives=w1["collectives"], seconds=w1["seconds"]),
        world4=dict(
            layers=MESH_TRAIN_REPEATS,
            bf16_seconds=[[s["ms"] / 1e3 for s in r["train"]["bfloat16"][
                "steps"]] for r in four],
            float32_seconds=[[s["ms"] / 1e3 for s in r["train"]["float32"][
                "steps"]] for r in four],
            peak_gib=[max(s["peak_gib"] for dt in ("bfloat16", "float32")
                          for s in r["train"][dt]["steps"]) for r in four],
            weight_and_moment_share=[r["train"]["float32"]["share"]
                                     for r in four],
            float32_worst_share_of_tol=max(
                max(s["leaves"]["share_of_tol"], s["vs_unsharded"]["loss"],
                    s["vs_unsharded"]["grad_norm"])
                for r in four for s in r["train"]["float32"]["steps"]),
            bf16_vs_world1=[s["vs_world1"] for s in four[0]["train"][
                "bfloat16"]["steps"]],
            float32_vs_world1=[s["vs_world1"] for s in four[0]["train"][
                "float32"]["steps"]],
            checkpoint_save_seconds=four[0]["train"][
                "checkpoint_save_seconds"],
            turns_seconds=four[0]["train"]["turns_seconds"],
            elastic=four[0]["train"]["elastic"],
            seconds=[r["train"]["seconds"] for r in four]),
        main_process_gib=main_gib, card=card_line())
    pre = [r["prefill"] for r in four]
    say("mesh", step="prefill_summary",
        world1=dict(bf16_ms=one["prefill"]["bf16"]["ms"],
                    unsharded_bf16_ms=one["prefill"]["unsharded_ms"],
                    float32_ms=one["prefill"]["float32"]["ms"],
                    unsharded_float32_ms=one["prefill"]["float32"][
                        "unsharded_ms"],
                    float32_equal_to_unsharded=one["prefill"]["float32"][
                        "equal_to_unsharded"],
                    collectives=one["prefill"]["bf16"]["collectives"]),
        world4=dict(
            bf16_seconds=[r["bf16"]["seconds"] for r in pre],
            float32_seconds=[r["float32"]["seconds"] for r in pre],
            peak_gib=[max(r["bf16"]["peak_gib"], r["float32"]["peak_gib"])
                      for r in pre],
            weight_share=[r["weights"]["share"] for r in pre],
            float32_share_of_tol=max(r["float32"]["share_of_tol"]
                                     for r in pre),
            bf16_vs_world1_max_abs=max(r["bf16"]["vs_world1_max_abs"]
                                       for r in pre),
            bf16_argmax_equal_to_world1=sum(
                r["bf16"]["argmax_equal_to_world1"] for r in pre),
            bf16_rows=sum(r["bf16"]["rows"] for r in pre)),
        card=card_line())
    dec = one["decode"]
    say("mesh", step="summary", seconds=time.perf_counter() - t0,
        ms_per_replayed_step={k: dec[k]["ms_per_replayed_step"]
                              for k in ("plain", "cp", "one_shard")},
        tokens_equal_to_lm_main_path=dec["cp"]["tokens_equal_to_lm_main_path"],
        forced_cp_vs_plain=dec["forced"],
        ms_per_eager_step_world4=[r["decode"]["cp"]["ms_per_eager_step"]
                                  for r in four],
        rows_per_second_world1={p: l["rows_per_second"]
                                for p, l in one["sweeps"].items()},
        rows_per_second_world4={p: min(r["sweeps"][p]["rows_per_second"]
                                       for r in four)
                                for p in one["sweeps"]},
        ws_sim_launches=launches,
        cp_attention_max_abs_err=max(r["cp_attention"]["max_abs_err"]
                                     for r in four),
        card=card_line())
    return launches


def launch_runs(line) -> list:
    """Every counted run in a step's line: each dict with ``launches``."""
    if isinstance(line, dict):
        if "launches" in line:
            return [line]
        return [r for v in line.values() for r in launch_runs(v)]
    if isinstance(line, list):
        return [r for v in line for r in launch_runs(v)]
    return []


def recurrent_summary(r1: dict, r4: list) -> None:
    """Step recurrent's ``recurrent_summary`` line from world 1's line and
    each world-4 rank's."""
    def w1(case):
        c = r1[case]
        if "steps" in c:
            return dict(ms=[s["ms"] for s in c["steps"]],
                        unsharded_ms=[s["plain_ms"] for s in c["steps"]],
                        peak_gib=max(s["peak_gib"] for s in c["steps"]),
                        layers=c["layers"], collectives=c["collectives"])
        return dict(ms=c["ms"], unsharded_ms=c["unsharded_ms"],
                    peak_gib=c["peak_gib"], layers=c["layers"],
                    collectives=c["collectives"])

    def w4(arch):
        lines = [r[arch] for r in r4]
        dts = ("bfloat16", "float32")
        return dict(
            prefill_layers={dt: lines[0][f"prefill_{dt}"]["layers"]
                            for dt in dts},
            train_layers=lines[0]["train"]["layers"],
            seq=lines[0]["train"]["seq"],
            prefill_seconds={dt: [l[f"prefill_{dt}"]["ms"] / 1e3
                                  for l in lines] for dt in dts},
            train_seconds={dt: [[s["ms"] / 1e3 for s in l[f"train_{dt}"][
                "steps"]] for l in lines] for dt in dts},
            peak_gib=[max(r["peak_gib"] for r in launch_runs(l))
                      for l in lines],
            weight_share={dt: [l[f"prefill_{dt}"]["weights"]["share"]
                               for l in lines] for dt in dts},
            weight_and_moment_share=[
                l["train_float32"]["bytes"]["local"]
                / l["train_float32"]["bytes"]["whole"] for l in lines],
            float32_prefill_share_of_tol=max(
                l["prefill_float32"]["share_of_tol"] for l in lines),
            float32_train_worst_share_of_tol=max(
                max([l["train_float32"]["leaves"]["share_of_tol"]] + [
                    max(v for k, v in s["vs_unsharded"].items()
                        if k != "lr_equal")
                    for s in l["train_float32"]["steps"]])
                for l in lines),
            bf16_prefill_max_abs=max(l["prefill_bfloat16"][
                "vs_unsharded_max_abs"] for l in lines),
            bf16_argmax_equal=sum(l["prefill_bfloat16"]["argmax_equal"]
                                  for l in lines),
            bf16_train_vs_unsharded=[s["vs_unsharded"] for s in lines[0][
                "train_bfloat16"]["steps"]],
            turns_seconds=lines[0]["turns_seconds"],
            collectives=dict(train=lines[0]["train"]["collectives"], **{
                f"prefill_{dt}": lines[0][f"prefill_{dt}"]["collectives"]
                for dt in dts}),
            seconds_by_part=lines[0]["seconds_by_part"],
            seconds=[l["seconds"] for l in lines])
    say("mesh", step="recurrent_summary",
        world1=dict({case: w1(case) for case in (
            "jamba_prefill", "jamba_prefill_float32", "jamba_train",
            "xlstm_prefill", "xlstm_train")}, bit_equal=True,
            refs_seconds=r1["refs_seconds"], seconds=r1["seconds"]),
        world4={arch: w4(arch) for arch in (JAMBA_ARCH, XLSTM_ARCH)},
        seconds=dict(world1=r1["seconds"],
                     world4=[r["seconds"] for r in r4]),
        card=card_line())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    t_start = time.perf_counter()
    say("start", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), card=card_line())
    phase_seconds = {}

    def timed(name: str, fn, *args):
        """Run one phase; its wall seconds go on a line of their own."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = time.perf_counter() - t0
        say("phase_seconds", of=name, seconds=phase_seconds[name])
        return out

    # 1. build every kernel from the sources in this checkout
    def build():
        seconds = _build.build_all()
        ws._lib()
        with ThreadPoolExecutor() as pool:
            resources = pool.submit(register_variant_resources)
            hgmma = hgmma_counts()
            resources = resources.result()
        say("build", seconds=seconds, directory=str(_build.build_dir()),
            ptxas={name: [l.strip() for l in log.splitlines()
                          if "registers" in l or "spill" in l]
                   for name, log in _build.build_logs.items()},
            hgmma=hgmma, ws_sim_register_variant=resources)
    timed("build", build)
    # 2, 3. each body against its plain version and the oracle
    timed("kernels", phase_kernels_and_oracle)
    # phase mesh's work directory: its references and its ranks' files
    mesh_dir = tempfile.TemporaryDirectory(prefix="ws_mesh_")
    # 4. the main paths, each counted on its own (the zip clock pinned, so
    # that phase mesh can hold its store to these bytes)
    with tempfile.TemporaryDirectory(prefix="ws_store_") as tmp:
        with pinned_zip_clock():
            main_out = timed("main_path", lambda: {
                path: drive_path(Path(tmp) / path, path)
                for path in MAIN_PATHS})
        shutil.copytree(Path(tmp) / "divisible",
                        Path(mesh_dir.name) / "main_store")
        # 4b. the query path and the planner, under the sanitizer
        query = timed("query_main_path", phase_query_main_path,
                      Path(tmp) / "query", Path(tmp))
    # 4c. the paper's experiments, the log engine, the segmented loop and
    # serve's command line
    paper = timed("paper", phase_paper)
    # 4d. the simulation daemon: client processes, sweep chunks, library
    # mode, a daemon killed mid-round, the daemon bench
    with tempfile.TemporaryDirectory(prefix="ws_daemon_") as tmp:
        daemon = timed("daemon", phase_daemon, Path(tmp))
    # 4e. the checker suite on the card and grid_chunk; the simulator benches
    # of benchmarks/run.py (benchmarks/run_torch.py)
    with tempfile.TemporaryDirectory(prefix="ws_lint_") as tmp:
        timed("lint", phase_lint, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="ws_benches_") as tmp:
        benches = timed("benches", phase_benches, Path(tmp))
    # 5. times at a main-path shape
    entries = timed("timing", lambda: [
        time_body(path, main_out[path], reps=5 if path == "divisible" else 3)
        for path in MAIN_PATHS])
    for e in entries:
        e["launches_query_path"] = query["launches"][e["name"]]
        e["launches_paper_path"] = paper[e["name"]]
        e["launches_daemon_path"] = daemon[e["name"]]
        e["launches_bench_path"] = benches[e["name"]]
    # 6-8. the language-model serving path: its kernels against their plain
    # versions, its two main paths counted, the kernels' times
    timed("lm_kernels", phase_lm_kernels)
    lm_main = timed("lm_main_path", phase_lm_main_path)
    np.savez(Path(mesh_dir.name) / "lm_tokens.npz",
             prompts=lm_main.pop("prompts"), tokens=lm_main.pop("tokens"))
    # 6b. mixtral-8x7b at full width through the MoE layer
    lm_moe = timed("lm_moe", phase_lm_moe)
    lm_main.update(moe_serve=lm_moe["serve"], moe_prefill=lm_moe["prefill"])
    # 6c. the recurrent mixers (xlstm-350m, jamba-v0.1-52b) and head dim 96
    # (phi3-mini-3.8b) at full width
    lm_main.update(timed("lm_recurrent", phase_lm_recurrent))
    # 6d. the encoder-decoder (whisper-large-v3) and the vision prefix
    # (internvl2-76b) at full width
    lm_main.update(timed("lm_encdec", phase_lm_encdec))
    # 6e. training: qwen3-1.7b at full width, its checkpoint, the float32
    # parity of a train step, the example's command line
    lm_main.update(timed("lm_train", phase_lm_train))
    entries += timed("lm_timing", phase_lm_timing, lm_main)
    # 9. the mesh: the sharded sweep and context-parallel decode on a world
    # of one NCCL rank, then on four gloo ranks sharing the card (after
    # lm_timing: its profiled windows are traced before other processes
    # have used the card)
    with mesh_dir:
        mesh = timed("mesh", phase_mesh, Path(mesh_dir.name))
    for e in entries:
        if e["name"] in mesh:
            e["launches_mesh_path"] = mesh[e["name"]]
    say("done", seconds=round(time.perf_counter() - t_start, 1),
        phase_seconds=phase_seconds)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-group"]:
        run_kernel_group(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-rank"]:
        run_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        main()
