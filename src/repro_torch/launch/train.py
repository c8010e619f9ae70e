"""End-to-end training entry point (the JAX package's
``launch/train.py``).

Assembles: config -> model -> train step (value and grad of
``Model.loss_fn``; EF-int8 gradient compression with ``--compress``; AdamW)
-> stateless data pipeline -> fault-tolerant loop (checkpoint/restart,
failure injection). Runs on the card, as ``serve.main`` does; on the card
every RMSNorm and attention of the forward is a hand-written kernel, its
gradient the plain version's.

  python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100 \\
         --reduced --batch 8 --seq 128 [--fail-at 7,13] [--compress]

On a machine without a card, drive the same loop through
``build_state_and_step(..., device="cpu")`` and ``run_training``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec, get_config, list_archs
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.runtime.fault import (FailureInjector, TrainLoopConfig,
                                       run_training)


def build_state_and_step(cfg, opt_cfg, compress: bool, seed: int = 0,
                         device=None):
    """(model, state, step_fn): random weights from ``seed`` on ``device``
    (``None``: the card, which raises without one), the state
    ``{"params", "opt"[, "ef"]}`` and ``step_fn(state, batch) -> (state,
    metrics)``, which writes into none of its arguments."""
    model = build_model(cfg, device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(seed))
    opt_state = adamw.init(params)
    state = {"params": params, "opt": opt_state}
    if compress:
        state["ef"] = comp.init_ef(params)

    def step_fn(state, batch):
        params, opt_state = state["params"], state["opt"]
        _loss, metrics, grads = loss_and_grads(model, params, batch)
        if compress:
            # the EF-int8 sandwich on the (cross-pod) gradient reduction
            grads, ef = comp.ef_compress_tree(grads, state["ef"])
        new_params, new_opt, om = adamw.apply(opt_cfg, params, opt_state,
                                              grads)
        new_state = {"params": new_params, "opt": new_opt}
        if compress:
            new_state["ef"] = ef
        return new_state, {**metrics, **om}

    return model, state, step_fn


def main(argv: Optional[Sequence[str]] = None):
    """The command line (``argv``: its arguments, default ``sys.argv``).
    Runs on the card. Returns ``run_training``'s summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="small same-family config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps for injected failures")
    ap.add_argument("--compress", action="store_true",
                    help="EF-int8 gradient compression")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)

    model, state, step_fn = build_state_and_step(cfg, opt_cfg, args.compress,
                                                 args.seed)
    print(f"arch={cfg.name} params={model.param_count():,} "
          f"batch={args.batch}x{args.seq} steps={args.steps}")

    def batch_fn(step):
        return batch_at(cfg, shape, step, DataConfig(seed=args.seed + 99),
                        device=model.device)

    fails = tuple(int(s) for s in args.fail_at.split(",") if s)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir)
    t0 = time.time()

    def on_metrics(step, m):
        if step % max(args.steps // 10, 1) == 0:
            print(f"  step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e}")

    out = run_training(loop_cfg, step_fn, state, batch_fn,
                       injector=FailureInjector(fail_at=fails) if fails else None,
                       on_metrics=on_metrics)
    dt = time.time() - t0
    first = np.mean(out["losses"][:5]) if out["losses"] else float("nan")
    last = np.mean(out["losses"][-5:]) if out["losses"] else float("nan")
    print(f"done in {dt:.1f}s; restarts={out['restarts']}; "
          f"loss {first:.4f} -> {last:.4f}")
    assert last < first, "loss did not improve"
    return out


if __name__ == "__main__":
    main()
