"""Fault-tolerant training runtime (the JAX package's ``runtime/fault.py``).

* periodic and final checkpoints (atomic commit; see ``checkpoint/ckpt.py``),
* crash recovery: on a step failure the loop restores the latest committed
  checkpoint, fast-forwards the stateless data pipeline, and continues;
  with no checkpoint yet it starts again from ``init_state``, which the
  step functions never write into (``optim/adamw.py``, ``launch/steps.py``):
  the run then ends bit-equal to an uninterrupted one.
  ``FailureInjector`` simulates node loss deterministically in tests,
* elastic restart: with ``state_shardings`` the state is this rank's
  shards; every checkpoint holds the whole arrays (written by the mesh's
  first rank), and a resume reads each rank's slice of them whatever mesh
  wrote them (``load_checkpoint(shardings=)``), so a run resumes onto
  another mesh, or from a checkpoint of an unsharded run,
* straggler mitigation: a per-step wall-time EMA per data rank
  (``StragglerMonitor``) for the work-stealing scheduler's
  ``straggler_rebalance``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.service import resilience as rz


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically raise at given steps (once each): simulated node
    failures for tests and examples. The steps become an ``At`` spec on the
    ``train.step`` site of the general fault-injection layer
    (``service/resilience.py``), so training chaos and service chaos share
    one engine."""
    fail_at: tuple = ()

    def __post_init__(self):
        sites = {}
        if self.fail_at:
            sites["train.step"] = rz.At(*self.fail_at, exc=InjectedFailure)
        self._plan = rz.FaultPlan(rng_seed=0, sites=sites)

    def maybe_fail(self, step: int):
        self._plan.fire("train.step", {"index": step})


@dataclasses.dataclass
class StragglerMonitor:
    """EMA of per-step time; flags ranks slower than ratio × median."""
    n_ranks: int
    alpha: float = 0.3
    ratio: float = 1.5
    ema: Optional[np.ndarray] = None

    def update(self, per_rank_seconds: np.ndarray) -> List[int]:
        if self.ema is None:
            self.ema = per_rank_seconds.astype(float).copy()
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * per_rank_seconds
        med = float(np.median(self.ema))
        return [i for i, v in enumerate(self.ema) if v > self.ratio * med]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    async_ckpt: bool = False
    max_restarts: int = 5


def run_training(
    loop_cfg: TrainLoopConfig,
    step_fn: Callable,                  # (state, batch) -> (state, metrics)
    init_state: Any,                    # tree (params, opt, ...)
    batch_fn: Callable[[int], Dict],    # step -> batch (stateless pipeline)
    injector: Optional[FailureInjector] = None,
    state_shardings: Any = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> Dict:
    """Crash-safe training loop. Returns {"final_step", "restarts",
    "losses"} (a loss for every step run, re-run steps included). A
    checkpoint restores onto the devices of ``init_state``'s leaves.

    ``state_shardings``: a tree like ``init_state`` of
    ``launch.sharding.NamedSharding`` on a live mesh, whose leaves are this
    rank's shards (``sharding.local_params`` of the state;
    ``step_fn`` a sharded step, e.g. ``steps.build_train_step``'s on the
    mesh). Every rank runs the loop: the checkpoints gather the whole
    arrays onto the mesh's first rank, which writes them, and a restore
    reads this rank's slice of each (the local tensors of
    ``load_checkpoint(shardings=)``'s leaves)."""
    template = init_state
    if state_shardings is not None:
        # the stored arrays are whole: the template gives their shapes
        template = tr.tree_map(
            lambda t, sh: (sh.global_shape(tuple(t.shape)), t.dtype),
            init_state, state_shardings)

    def restore():
        got, st, _ = ckpt_mod.load_checkpoint(loop_cfg.ckpt_dir, template,
                                              shardings=state_shardings)
        if state_shardings is not None:
            st = tr.tree_map(lambda t: t.to_local(), st)
        return got, st

    state = init_state
    start_step = 0
    restarts = 0
    ckpt_handle = None

    # resume if a committed checkpoint exists
    steps = ckpt_mod.list_steps(loop_cfg.ckpt_dir)
    if steps:
        start_step, state = restore()
        start_step += 1

    step = start_step
    losses = []
    while step < loop_cfg.total_steps:
        try:
            if injector:
                injector.maybe_fail(step)
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics.get("loss", np.nan)))
            if on_metrics:
                on_metrics(step, metrics)
            if (step + 1) % loop_cfg.ckpt_every == 0:
                if ckpt_handle is not None:
                    ckpt_handle.join()
                ckpt_handle = ckpt_mod.save_checkpoint(
                    loop_cfg.ckpt_dir, step, state,
                    extra={"losses_tail": losses[-3:]},
                    async_write=loop_cfg.async_ckpt,
                    keep_last=loop_cfg.keep_last, shardings=state_shardings)
            step += 1
        except InjectedFailure:
            restarts += 1
            if restarts > loop_cfg.max_restarts:
                raise
            steps = ckpt_mod.list_steps(loop_cfg.ckpt_dir)
            if steps:
                got_step, state = restore()
                step = got_step + 1       # data pipeline fast-forwards by step
            else:
                state = init_state
                step = 0
    if ckpt_handle is not None:
        ckpt_handle.join()
    ckpt_mod.save_checkpoint(loop_cfg.ckpt_dir, loop_cfg.total_steps - 1,
                             state, keep_last=loop_cfg.keep_last,
                             shardings=state_shardings)
    return {"final_step": step, "restarts": restarts, "losses": losses}
