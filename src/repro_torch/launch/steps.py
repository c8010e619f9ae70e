"""The steps: the train step (:func:`build_train_step`), prefill and
decode of the serving path, and the decode step as one CUDA graph
(:class:`GraphedDecodeStep`).

The JAX package's ``launch/steps.py`` also plans and lowers (arch × shape ×
mesh) cells with activation and context-parallel shardings (``act_spec``,
``plan_cell``); those come with the mesh slice (Queue A 10).
"""
from __future__ import annotations

import time

import torch

from repro_torch import tree as tr
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import adamw


def check_model_device(model, device) -> None:
    """The device rule of the serving entry points: ``device=None`` means
    the card (and raises without one); the model must live there."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"the model lives on {model.device}, the caller "
                         f"asked for {dev}")


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads): ``Model.loss_fn`` and its gradient with
    respect to every leaf of ``params`` (``torch.autograd.grad``; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives). ``params`` is
    not written: the gradient is taken on detached views of its leaves.
    On the card each kernel's gradient is its plain version's
    (``kernels/_lm.py::KernelWithPlainBackward``)."""
    flat = tr.leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    it = iter(leaves)
    p = tr.tree_map(lambda _leaf: next(it), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tr.tree_map(lambda _leaf: next(it), params))


def build_train_step(model, opt_cfg: adamw.AdamWConfig,
                     microbatches: int = 1, device=None):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    metrics): the gradient of ``Model.loss_fn`` (:func:`loss_and_grads`),
    then ``adamw.apply``. Metrics: ``loss``, ``xent``, ``moe_aux``,
    ``grad_norm`` and ``lr``. ``microbatches > 1`` is gradient
    accumulation: the batch split on dim 0, the gradients summed in float32
    and divided by ``microbatches``; the metrics are then the mean loss as
    ``loss`` and ``xent`` and a ``moe_aux`` of 0, as the JAX package's scan.
    The step writes into none of its arguments. ``device=None`` means the
    card (and raises without one); the model must live there."""
    check_model_device(model, device)

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            def split(x):
                if x.shape[0] % microbatches:
                    raise ValueError(f"a batch of {x.shape[0]} does not "
                                     f"split into {microbatches} "
                                     f"microbatches")
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))
            mb = {k: split(v) for k, v in batch.items()}
            grads = tr.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            for i in range(microbatches):
                l_i, _m, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in mb.items()})
                grads = tr.tree_map(lambda a, gi: a + gi.to(torch.float32),
                                    grads, g)
                loss = loss + l_i
            grads = tr.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"loss": loss, "xent": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32,
                                              device=model.device)}
        new_params, new_opt, om = adamw.apply(opt_cfg, params, opt_state,
                                              grads)
        return new_params, new_opt, {**metrics, **om}
    return train_step


def build_prefill_step(model, device=None):
    """``prefill_step(params, batch)`` -> next-token logits (B, 1, Vpad) in
    float32: ``Model.forward`` over the whole prompt (behind its vision
    prefix ``vis_embeds``, after the encoder over its ``frames``, where the
    config has them), the head applied to the last position only (the JAX
    package slices the full logits; the other positions' logits are never
    read). ``device=None`` means the card."""
    check_model_device(model, device)

    def prefill_step(params, batch):
        x, _aux = model.hidden_states(params, batch)
        return model.head(params, x[:, -1:])
    return prefill_step


def build_decode_step(model, device=None):
    """``decode_step(params, cache, tokens, pos)`` -> (logits, cache), the
    cache updated in place. ``device=None`` means the card."""
    check_model_device(model, device)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode_step


class GraphedDecodeStep:
    """``Model.decode_step`` captured once in a CUDA graph and replayed: the
    port's counterpart of the JAX package's ``jax.jit`` of the step
    (``launch/serve.py``). Capture and replay, not compilation: the graph
    holds the same hand-written kernels and library calls as an eager step.

    Call it as ``decode_step``: ``step(params, cache, tokens, pos,
    embeds=None)`` -> (logits, cache), ``pos`` a Python int. A step on
    tokens and a step on ``embeds`` (a vision prefix's rows during prefill)
    are two graphs, each captured at its first call: that call runs the
    step eagerly on a side stream with its position as a device int32 (the
    warm-up, ``torch.cuda.graphs``' practice: it builds the kernel
    libraries at first use and creates cuBLAS's handles), then captures one
    step against that call's params and cache, reading the tokens (B, 1),
    the embeddings (B, 1, D) and the position from static buffers on the
    card. Every later call copies its inputs into those buffers and replays
    its graph, so it must pass the same params and cache (the graphs hold
    their addresses). A replay returns the graph's static logits, which the
    next replay overwrites: clone them to keep them.

    Launch counts stay true: the wrappers' counters tick while a graph is
    captured, not while it is replayed, so the runner takes the capture's
    launches back out of the counters and adds them once a replay. A
    failure to capture or to replay raises; nothing falls back to eager
    steps.
    """

    def __init__(self, model):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a model on the card, this "
                             f"one lives on {model.device}")
        self.model = model
        self._params = self._cache = None
        #: "tokens" / "embeds" -> that step's captured graph
        self.graphs = {}

    def __call__(self, params, cache, tokens, pos: int, embeds=None):
        if self.graphs and (params is not self._params
                            or cache is not self._cache):
            raise ValueError("the graph was captured against other params "
                             "or another cache")
        self._params, self._cache = params, cache
        kind = "tokens" if embeds is None else "embeds"
        if kind not in self.graphs:
            self.graphs[kind] = _CapturedStep(self.model)
            return self.graphs[kind].warm_up_and_capture(
                params, cache, tokens, pos, embeds)
        return self.graphs[kind].replay(cache, tokens, pos, embeds)

    def stats(self) -> dict:
        """Warm-up and capture seconds and replays, summed over the graphs;
        the token step's launches a replay, as ``ops.counts_since`` gives
        them (None before its capture); and each graph's own numbers."""
        each = {kind: g.stats() for kind, g in self.graphs.items()}
        tokens = each.get("tokens", {})
        return dict(
            warmup_seconds=sum(g["warmup_seconds"] for g in each.values()),
            capture_seconds=sum(g["capture_seconds"] for g in each.values()),
            replays=sum(g["replays"] for g in each.values()),
            launches_per_replay=tokens.get("launches_per_replay"),
            graphs=each)


class _CapturedStep:
    """One decode step (on tokens, or on embeddings) as a CUDA graph."""

    def __init__(self, model):
        self.model = model
        self.graph = None
        self.warmup_seconds = self.capture_seconds = 0.0
        self.replays = 0
        #: launches of one replay, as ``ops.counts_since`` gives them
        self.launches_per_replay = None

    def replay(self, cache, tokens, pos: int, embeds):
        self._tokens.copy_(tokens)
        if embeds is not None:
            self._embeds.copy_(embeds)
        self._pos.fill_(pos)
        self.graph.replay()
        ops.add_counts(self.launches_per_replay)
        self.replays += 1
        return self._logits, cache

    def warm_up_and_capture(self, params, cache, tokens, pos: int, embeds):
        dev = self.model.device
        self._tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                   device=dev)
        self._tokens.copy_(tokens)
        self._embeds = None
        if embeds is not None:
            self._embeds = torch.empty(embeds.shape, dtype=embeds.dtype,
                                       device=dev)
            self._embeds.copy_(embeds)
        self._pos = torch.full((), pos, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            logits, _ = self.model.decode_step(params, cache, self._tokens,
                                               self._pos, self._embeds)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        before = (ops.launch_counts(), ops.variant_counts())
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._logits, _ = self.model.decode_step(
                params, cache, self._tokens, self._pos, self._embeds)
        self.launches_per_replay = ops.counts_since(before)
        ops.add_counts(self.launches_per_replay, times=-1)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = t1 - t0
        self.capture_seconds = time.perf_counter() - t1
        return logits, cache

    def stats(self) -> dict:
        return dict(warmup_seconds=self.warmup_seconds,
                    capture_seconds=self.capture_seconds,
                    replays=self.replays,
                    launches_per_replay=self.launches_per_replay)
