"""AdamW with a cosine schedule, global-norm clipping, and float32 state over
parameters of any float type (the JAX package's ``optim/adamw.py``).

Trees are the port's nested dicts of tensors. The math is float32 in the
reference's order of operations; ``m`` and ``v`` are float32; parameters
keep their dtype. :func:`apply` is functional, as the JAX function is: it
returns new tensors and writes into none of its inputs, so a training loop
may restart from a state it has already stepped from
(``runtime/fault.py``). The moments of :func:`init` are zeros that take no
memory: each leaf one float32 zero expanded to the parameter's shape, a view
that cannot be written into. The first update reads them and writes new
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tr


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, one element
    m: Any               # tree like params, float32
    v: Any               # tree like params, float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor of one element), a
    float32 tensor: linear warm-up, then a cosine down to
    ``min_lr_frac * lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def zeros(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``p``'s shape on its device that take no memory:
    one zero expanded (a view that cannot be written into)."""
    return torch.zeros((), dtype=torch.float32,
                       device=p.device).expand(p.shape)


def init(params) -> AdamWState:
    """Step 0 and zero moments (:func:`zeros`: no memory)."""
    device = tr.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tr.tree_map(zeros, params),
                      v=tr.tree_map(zeros, params))


def state_shapes(param_shapes) -> AdamWState:
    """The state's (shape, dtype) leaves for a tree of parameter (shape,
    dtype) leaves (``Model.param_shapes``), allocating nothing: the JAX
    package's ``abstract_state``."""
    def f32(leaf):
        return (tuple(leaf[0]), torch.float32)
    return AdamWState(step=((), torch.int32),
                      m=tr.tree_map(f32, param_shapes),
                      v=tr.tree_map(f32, param_shapes))


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, the leaves
    summed in pytree order. ``shardings``: a tree like ``tree`` of
    ``launch.sharding.NamedSharding`` on a live mesh, whose leaves are this
    rank's shards: each leaf's sum of squares is then taken over the whole
    mesh, a leaf held alike on several ranks counted once
    (``launch.partition.sum_squares``)."""
    squares = [torch.sum(torch.square(g.to(torch.float32)))
               for g in tr.leaves(tree)]
    if shardings is not None:
        from repro_torch.launch import partition
        shards = tr.leaves(shardings)
        squares = partition.sum_squares(squares, shards, shards[0].mesh)
    return torch.sqrt(sum(squares))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, state: AdamWState, grads,
          decay_mask=None, shardings=None) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW update: (new params, new state, {"grad_norm", "lr"}).
    Grads may be bf16; the math is float32; params keep their dtype.
    ``decay_mask``: a tree of floats like params (default 1.0 for leaves of
    2 or more dims, 0.0 for norms and biases). ``shardings``: on a live
    mesh, the params' (``sharding.shard_params``); params, grads and the
    moments are then this rank's shards (``sharding.shard_opt_state``),
    the clipping norm is the whole tree's (:func:`global_norm`), and the
    update stays elementwise on each shard."""
    gnorm = global_norm(grads, shardings)
    if cfg.clip_norm > 0:
        scale = torch.clamp(_scalar(cfg.clip_norm, gnorm)
                            / torch.clamp_min(gnorm, 1e-9), max=1.0)
    else:
        scale = _scalar(1.0, gnorm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v, wd):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        step_dir = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step_dir = step_dir + wd * cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * step_dir).to(p.dtype)
        return new_p, m, v

    if decay_mask is None:
        # decay 2D+ tensors, not norms/bias vectors (standard practice)
        decay_mask = tr.tree_map(lambda p: 1.0 if p.ndim >= 2 else 0.0,
                                 params)
    outs = tr.tree_map(upd, params, grads, state.m, state.v, decay_mask)
    new_params, m, v = (tr.tree_map(lambda o, i=i: o[i], outs)
                        for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, m=m, v=v), metrics
