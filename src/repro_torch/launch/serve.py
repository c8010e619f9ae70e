"""Serving driver: batched prefill + greedy decode with the work-stealing
request scheduler (the paper's algorithm on the serving plane).

:func:`main` first plans the stealing policy by simulating the fleet
(``sched/planner.py``: the ``ws_sim`` kernel on the card), schedules the
requests with ``sched/ws_scheduler.py`` (everything lands on group 0 and
idle groups steal), then runs the model on them with :func:`decode_batch`.
On the card every step of a :func:`decode_batch` call (prefill's and
decode's) after the first is a replay of one CUDA graph
(``launch/steps.py::GraphedDecodeStep``); on the CPU the steps run eagerly.

  python -m repro_torch.launch.serve --no-reduced      # full width, card
  python -m repro_torch.launch.serve --requests 24      # reduced config
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.topology import tpu_fleet
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import GraphedDecodeStep, check_model_device
from repro_torch.models import build_model
from repro_torch.sched.planner import PlannerDecision, plan_for_mesh
from repro_torch.sched.ws_scheduler import (SchedulerStats, WorkItem,
                                            WorkStealingScheduler)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int


def decode_batch(model, params, reqs: List[Request], device=None,
                 cp_axes=None, mesh=None) -> np.ndarray:
    """Prefill + greedy-decode a batch of same-length requests; returns the
    new tokens (B, max_new) int32. Greedy takes the first maximal logit, as
    ``jnp.argmax`` does. (The JAX package's ``decode_batch`` also takes a
    ``vocab`` that it never reads; the port leaves it out.) ``device=None``
    means the card (and raises without one); the model must live on the
    same device. On the card the steps replay one CUDA graph; a failed
    capture or replay raises.

    ``cp_axes`` = (seq_axes, batch_axes) on a live ``mesh`` decodes with
    context parallelism: this rank serves its shard of the requests over
    ``batch_axes``, holds its shard of the KV cache's sequence over
    ``seq_axes`` (the prompt length plus ``max_new`` must split evenly),
    and the ranks gather the new tokens, so every rank returns all of
    them. A mesh whose collectives run through gloo cannot be captured in
    a graph: its steps run eagerly."""
    check_model_device(model, device)
    S = len(reqs[0].prompt)
    if any(len(r.prompt) != S for r in reqs):
        raise ValueError("decode_batch serves requests of one prompt length")
    max_new = max(r.max_new for r in reqs)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             dtype=torch.int64, device=model.device)
    cache = None
    batch_axes = ()
    if cp_axes:
        seq_axes, batch_axes = (tuple(a) for a in cp_axes)
        nb = mesh_lib.axis_size(mesh, *batch_axes)
        ns = mesh_lib.axis_size(mesh, *seq_axes)
        if len(reqs) % nb or (S + max_new) % ns:
            raise ValueError(f"{len(reqs)} requests of {S} + {max_new} "
                             f"positions do not split {nb} x {ns} ways")
        rows = len(reqs) // nb
        lo = mesh_lib.shard_index(mesh, batch_axes) * rows
        tokens = tokens[lo:lo + rows]
        cache = model.init_cache(rows, (S + max_new) // ns)
    # the graph is captured once a call: it holds this call's cache
    if model.device.type == "cuda" and mesh_lib.capturable(mesh):
        step = GraphedDecodeStep(model, cp_axes, mesh)
    else:
        def step(params, cache, tok, pos, embeds=None):
            return model.decode_step(params, cache, tok, pos, embeds,
                                     cp_axes=cp_axes, mesh=mesh)
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  max_seq=S + max_new, step=step, cache=cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    outs = []
    for i in range(max_new):
        outs.append(tok[:, 0])
        logits, cache = step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    decode_batch.last_graph = (step.stats() if isinstance(
        step, GraphedDecodeStep) else None)
    out = torch.stack(outs, dim=1).to(torch.int32)
    if batch_axes:
        out = mesh_lib.all_gather_shards(out, mesh, batch_axes)
    return out.cpu().numpy()


#: the graph of the last call on the card (``GraphedDecodeStep.stats()``:
#: warm-up and capture seconds, replays, launches a replay); None on the CPU
decode_batch.last_graph = None


class ServeRun(NamedTuple):
    """What :func:`main` did: the planner's decision, the scheduler's stats,
    the generated tokens (requests, max_new) and the decode's wall seconds."""
    decision: PlannerDecision
    stats: SchedulerStats
    tokens: np.ndarray
    seconds: float


def main(argv: Optional[Sequence[str]] = None) -> ServeRun:
    """The command line (``argv``: its arguments, default ``sys.argv``).
    Runs on the card. ``--reduced`` (the default, as in the JAX package)
    serves the reduced config; ``--no-reduced`` serves the full one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced() if args.reduced \
        else get_config(args.arch)
    model = build_model(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(args.seed))
    print(f"serving {cfg.name} ({model.param_count():,} params), "
          f"{args.groups * args.pods} logical groups on {args.pods} pods")

    # 1) plan the stealing policy by simulating the fleet topology
    decision = plan_for_mesh(n_pods=args.pods, chips_per_pod=args.groups * 8,
                             dcn_delay=40, work_per_group=args.prompt_len * 64,
                             reps=8)
    print(f"planner: strategy={decision.strategy_name} "
          f"theta=({decision.theta_static},{decision.theta_comm}) "
          f"mwt={decision.mwt} expected_makespan={decision.expected_makespan:.0f} "
          f"(uniform baseline {decision.baseline_makespan:.0f})")

    # 2) schedule requests with the planned policy
    topo = tpu_fleet(args.pods, args.groups, ici_delay=1, dcn_delay=40) \
        .with_strategy(decision.strategy, remote_prob=decision.remote_prob)
    sched = WorkStealingScheduler(topo, mwt=decision.mwt,
                                  theta_static=decision.theta_static,
                                  theta_comm=decision.theta_comm,
                                  seed=args.seed + 1)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    # skewed arrival: everything lands on group 0 (paper's W-on-one-processor)
    for r in reqs:
        sched.submit(0, WorkItem(uid=r.uid, cost=float(args.prompt_len
                                                       + r.max_new)))
    stats = sched.run()
    print(f"scheduler: completed={stats.completed} steals ok/fail="
          f"{stats.n_success}/{stats.n_fail} cross-pod="
          f"{stats.n_cross_cluster_steals} makespan={stats.makespan:.0f} "
          f"busy-std={np.std(stats.per_group_busy):.1f}")
    if stats.completed != args.requests:
        raise RuntimeError(f"the scheduler completed {stats.completed} of "
                           f"{args.requests} requests")

    # 3) run the actual model on the requests (single physical replica here)
    t0 = time.time()
    out = decode_batch(model, params, reqs)
    dt = time.time() - t0
    tput = args.requests * args.max_new / dt
    print(f"decoded {out.shape} tokens in {dt:.2f}s ({tput:.1f} tok/s) "
          f"sample={out[0][:6].tolist()}")
    return ServeRun(decision, stats, out, dt)


if __name__ == "__main__":
    main()
