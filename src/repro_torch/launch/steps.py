"""The steps: the train step (:func:`build_train_step`), prefill and
decode of the serving path, the decode step as one CUDA graph
(:class:`GraphedDecodeStep`), and the plan of one (arch × shape × mesh)
cell (:func:`plan_cell`): its config, its steps, the abstract shapes,
dtypes and shardings of their arguments, the activation layout
(:func:`make_act_constrainer`), the MoE layout hints and context-parallel
decode.

The prefill and train steps run on a live mesh with their weights (and
the train step's AdamW moments) split by the placement rules
(``sharding.local_params``): each rank holds its shards, and the step
issues the collectives XLA's partitioner would place, and in the backward
their transposes (``launch/partition.py``). Context-parallel decode
(``cp_axes``) runs each rank's shard of the KV cache and merges the
partials with collectives over the mesh. The decode step runs on
rank-local, whole weights.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import partition
from repro_torch.launch import sharding as shd
from repro_torch.optim import adamw


def make_act_constrainer(mesh, dp, sequence_parallel: bool = True):
    """Activation layout policy (DESIGN.md §5): batch on dp axes; between
    layers the sequence dim is additionally sharded on 'model'
    (Megatron-style sequence parallelism). Tensors whose dims don't divide
    are left to propagation on that dim. ``full_seq=True`` pins the
    sequence-gathered layout (recurrent mixers need contiguous S).

    Returns ``constrain(h, full_seq=False, seq_len=None, split=None)``.
    ``constrain.spec(shape, full_seq=False)`` is the spec the JAX package
    pins for an activation of that global shape (None below two dims), and
    decides the layout: on a DTensor ``constrain`` redistributes to it; on
    a rank-local tensor of a live mesh whose sequence has ``seq_len``
    positions in all, it moves ``h`` between the SP layout (B/|dp|,
    S/|model|, ...) and the gathered one (B/|dp|, S, ...): a gather over
    'model' (``partition.sp_gather``), or this rank's slice of the
    sequence, which needs no collective. ``split`` says whether ``h`` is
    in the SP layout now (by default: whether it holds fewer than
    ``seq_len`` positions; over a 'model' axis of one rank the two layouts
    have one shape, and a sharded step says which it holds). Without
    ``seq_len``, or off a live mesh, a rank-local tensor is returned as it
    is. ``constrain.mesh``, ``.dp`` and ``.sequence_parallel`` are its
    arguments."""
    msz = mesh_lib.mesh_shape(mesh).get("model", 1)
    dpsz = mesh_lib.axis_size(mesh, *dp) if dp is not None else 1

    def spec(shape, full_seq: bool = False) -> Optional[tuple]:
        if len(shape) < 2:
            return None
        out = [None] * len(shape)
        if dp is not None and shape[0] % dpsz == 0:
            out[0] = dp
        if (not full_seq and sequence_parallel and len(shape) == 3
                and shape[1] > 1 and shape[1] % msz == 0):
            out[1] = "model"
        return shd.P(*out)

    def constrain(h, full_seq: bool = False, seq_len: Optional[int] = None,
                  split: Optional[bool] = None):
        from torch.distributed.tensor import DTensor
        if isinstance(h, DTensor):
            sp = spec(tuple(h.shape), full_seq)
            if sp is None:
                return h
            return h.redistribute(h.device_mesh, shd.NamedSharding(
                h.device_mesh, sp).placements())
        if seq_len is None or h.dim() < 2 or not mesh_lib.is_live(mesh):
            return h
        rows = h.shape[0] * (dpsz if dp is not None else 1)
        want = spec((rows, seq_len) + tuple(h.shape[2:]), full_seq)[1] \
            == "model"
        now = h.shape[1] != seq_len if split is None else split
        if want and not now:
            n = seq_len // msz
            r = mesh_lib.coordinate(mesh)["model"]
            return h[:, r * n:(r + 1) * n].contiguous()
        if now and not want:
            return partition.sp_gather(h, mesh)
        return h

    constrain.spec = spec
    constrain.mesh = mesh
    constrain.dp = dp
    constrain.sequence_parallel = sequence_parallel
    return constrain


def check_model_device(model, device) -> None:
    """The device rule of the serving entry points: ``device=None`` means
    the card (and raises without one); the model must live there."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"the model lives on {model.device}, the caller "
                         f"asked for {dev}")


def _grads(model, params, batch, act_spec, part):
    """(loss, metrics, grads) of ``Model.loss_fn`` before the leaf sums:
    :func:`loss_and_grads` without them."""
    flat = tr.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _path, p in flat]
    it = iter(leaves)
    p = tr.tree_map(lambda _leaf: next(it), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(p, batch, act_spec=act_spec)
        if part is None:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        else:
            seed = torch.full_like(loss, 1.0 / mesh_lib.world_of(part.mesh))
            grads = list(torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                             allow_unused=True))
            unread = model.unread_params()
            for i, ((path, leaf), g) in enumerate(zip(flat, grads)):
                if g is not None:
                    continue
                if path not in unread:
                    raise RuntimeError(
                        f"the sharded loss does not reach leaf "
                        f"{'/'.join(path)}: a collective cut the graph")
                grads[i] = torch.zeros_like(leaf)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tr.tree_map(lambda _leaf: next(it), params))


def loss_and_grads(model, params, batch, act_spec=None):
    """(loss, metrics, grads): ``Model.loss_fn`` and its gradient with
    respect to every leaf of ``params`` (``torch.autograd.grad``; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives). ``params`` is
    not written: the gradient is taken on detached views of its leaves.
    On the card each kernel's gradient is its plain version's
    (``kernels/_lm.py::KernelWithPlainBackward``).

    ``act_spec`` of a live mesh (``make_act_constrainer``): ``params`` are
    this rank's shards (``sharding.local_params``), ``batch`` its rows, and
    the gradients this rank's shards of the whole batch's gradient. Each
    rank's backward starts from 1/|world| (the loss is the same on every
    rank, its cotangent held as partial sums: ``launch/partition.py``), the
    collectives' transposes run in the backward, and each leaf is summed
    over the axes its spec leaves it whole on
    (``partition.sum_whole_leaves``). There a leaf the loss does not reach
    raises, naming it, but for the leaves the forward never reads
    (``Model.unread_params``): a collective that cut the graph would
    otherwise give zeros."""
    part = partition.for_model(act_spec, model.cfg,
                               partition.local(batch["tokens"]))
    loss, metrics, grads = _grads(model, params, batch, act_spec, part)
    if part is not None:
        grads = partition.sum_whole_leaves(
            grads, shd.shard_params(model.param_shapes(), part.mesh),
            part.mesh)
    return loss, metrics, grads


def _default_act_spec(model, act_spec, mesh):
    """``act_spec``, or for a ``mesh`` alone the constrainer
    :func:`plan_cell` makes: the batch on the dp axes, the sequence on
    'model' between layers for an attention-only stack."""
    if act_spec is None and mesh is not None:
        attn_only = all(m in ("attn", "xattn") for m, _ in model.cfg.pattern)
        return make_act_constrainer(mesh, mesh_lib.dp_axes(mesh),
                                    sequence_parallel=attn_only)
    if mesh is not None and act_spec.mesh is not mesh:
        raise ValueError("act_spec was made for another mesh")
    return act_spec


def build_train_step(model, opt_cfg: adamw.AdamWConfig, act_spec=None,
                     microbatches: int = 1, device=None, mesh=None):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    metrics): the gradient of ``Model.loss_fn`` (:func:`loss_and_grads`),
    then ``adamw.apply``. Metrics: ``loss``, ``xent``, ``moe_aux``,
    ``grad_norm`` and ``lr``. ``microbatches > 1`` is gradient
    accumulation: the batch split on dim 0, the gradients summed in float32
    and divided by ``microbatches``; the metrics are then the mean loss as
    ``loss`` and ``xent`` and a ``moe_aux`` of 0, as the JAX package's scan.
    The step writes into none of its arguments. ``device=None`` means the
    card (and raises without one); the model must live there.

    With ``act_spec`` of a live mesh, or a live ``mesh`` (its constrainer
    then as :func:`build_prefill_step` makes it), the step is sharded:
    ``params`` and ``opt_state`` are this rank's shards
    (``sharding.local_params`` over the trees of ``shard_params`` and
    ``shard_opt_state``), the batch this rank's rows
    (``data.pipeline.shard_batch``), and the new params and state this
    rank's shards; the metrics are the same on every rank. Microbatches
    split this rank's rows, the leaves are summed over the mesh once after
    the accumulation, and AdamW clips by the whole tree's norm. A world of
    one rank gives the step without a mesh bit for bit."""
    check_model_device(model, device)
    act_spec = _default_act_spec(model, act_spec, mesh)
    live = act_spec is not None and mesh_lib.is_live(act_spec.mesh)
    shardings = shd.shard_params(model.param_shapes(), act_spec.mesh) \
        if live else None

    def train_step(params, opt_state, batch):
        batch = {k: partition.local(v) for k, v in batch.items()}
        part = partition.for_model(act_spec, model.cfg, batch["tokens"])
        if microbatches <= 1:
            loss, metrics, grads = _grads(model, params, batch, act_spec,
                                          part)
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
                l_i, _m, g = _grads(model, params,
                                    {k: v[i] for k, v in mb.items()},
                                    act_spec, part)
                grads = tr.tree_map(lambda a, gi: a + gi.to(torch.float32),
                                    grads, g)
                loss = loss + l_i
        if part is not None:
            grads = partition.sum_whole_leaves(grads, shardings, part.mesh)
        if microbatches > 1:
            grads = tr.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"loss": loss, "xent": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32,
                                              device=model.device)}
        new_params, new_opt, om = adamw.apply(
            opt_cfg, params, opt_state, grads,
            shardings=shardings if part is not None else None)
        return new_params, new_opt, {**metrics, **om}
    return train_step


def build_prefill_step(model, act_spec=None, mesh=None, device=None):
    """``prefill_step(params, batch)`` -> next-token logits in float32
    (``Model.last_logits``): ``Model.forward`` over the whole prompt
    (behind its vision prefix ``vis_embeds``, after the encoder over its
    ``frames``, where the config has them), the head applied to the last
    position only (the JAX package slices the full logits; the other
    positions' logits are never read). ``device=None`` means the card.

    Without a mesh the params are whole and the logits (B, 1, Vpad). With
    ``act_spec`` of a live mesh (:func:`make_act_constrainer`), or a live
    ``mesh`` (its constrainer then puts the batch on the dp axes, and the
    sequence on 'model' between layers for an attention-only stack, as
    :func:`plan_cell` does), the step is sharded: ``params`` are this
    rank's shards (``sharding.local_params``), the batch this rank's rows
    (``data.pipeline.shard_batch``), and the logits this rank's shard
    (B/|dp|, 1, Vpad/|model|) of the JAX package's ``P(dp, None,
    "model")``."""
    check_model_device(model, device)
    act_spec = _default_act_spec(model, act_spec, mesh)

    def prefill_step(params, batch):
        return model.last_logits(params, batch, act_spec=act_spec)
    return prefill_step


def build_decode_step(model, cp_axes: Optional[Tuple] = None, device=None,
                      mesh=None):
    """``decode_step(params, cache, tokens, pos)`` -> (logits, cache), the
    cache updated in place. ``cp_axes`` = (seq_axes, batch_axes): the cache
    holds this rank's shard of a KV cache whose sequence is split over
    ``seq_axes`` of ``mesh`` and batch over ``batch_axes``
    (``Model.decode_step``). ``device=None`` means the card."""
    check_model_device(model, device)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, cp_axes=cp_axes,
                                 mesh=mesh)
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

    ``cp_axes`` and ``mesh`` make each step context-parallel
    (``Model.decode_step``); the graph then holds the merge's NCCL
    all-reduces (a mesh of ``gloo`` collectives is refused: they run on
    the host).
    """

    def __init__(self, model, cp_axes: Optional[Tuple] = None, mesh=None):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a model on the card, this "
                             f"one lives on {model.device}")
        if not mesh_lib.capturable(mesh):
            raise ValueError("the mesh's collectives run through gloo, on "
                             "the host: a CUDA graph cannot hold them")
        self.model = model
        self.cp_axes, self.mesh = cp_axes, mesh
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
            self.graphs[kind] = _CapturedStep(self.model, self.cp_axes,
                                              self.mesh)
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

    def __init__(self, model, cp_axes=None, mesh=None):
        self.model = model
        self.cp = dict(cp_axes=cp_axes, mesh=mesh)
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
                                               self._pos, self._embeds,
                                               **self.cp)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        before = (ops.launch_counts(), ops.variant_counts())
        self.graph = torch.cuda.CUDAGraph()
        # NCCL's watchdog thread polls its events while a step with
        # collectives is captured: only this thread's calls are checked
        mode = "thread_local" if mesh_lib.is_live(self.cp["mesh"]) \
            else "global"
        with torch.cuda.graph(self.graph, capture_error_mode=mode):
            self._logits, _ = self.model.decode_step(
                params, cache, self._tokens, self._pos, self._embeds,
                **self.cp)
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


@dataclasses.dataclass
class CellPlan:
    """Everything that plans one (arch × shape × mesh) cell: the config (MoE
    groups set for the mesh), the step and its arguments as abstract
    (shape, dtype, sharding) leaves (``sharding.ShapeDtypeStruct``), the
    arguments the step may overwrite, whether decode is context-parallel,
    the outputs' shardings and the activation constrainer."""
    arch: str
    shape: ShapeSpec
    cfg: ArchConfig
    mesh: Any
    fn: Any
    args: Tuple
    donate: Tuple[int, ...]
    context_parallel: bool
    out_shardings: Any = None
    act_spec: Any = None


def plan_cell(arch: str, shape_name: str, mesh=None, *,
              multi_pod: bool = False,
              opt_cfg: Optional[adamw.AdamWConfig] = None,
              cfg_overrides: Optional[dict] = None,
              device="meta") -> CellPlan:
    """Plan one cell on ``mesh`` (an ``AbstractMesh`` or a DeviceMesh;
    None: ``mesh.make_production_mesh(multi_pod=)``, which needs a world of
    256 or 512 ranks — plan for the fleet from a smaller world with
    ``mesh.production_mesh()``). The model is built on ``device``: the meta
    device by default, so that a plan allocates nothing. Sets the MoE
    layout hints (``models.moe.set_shard_hints``) for the cell, as the JAX
    package's ``plan_cell`` does."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else mesh_lib.make_production_mesh(
        multi_pod=multi_pod)
    mshape = mesh_lib.mesh_shape(mesh)
    dp = mesh_lib.dp_axes(mesh)
    dpsz = mesh_lib.axis_size(mesh, *dp)
    if (cfg.n_experts and shape.kind != "decode"
            and not (cfg_overrides and "moe_groups" in cfg_overrides)):
        tokens = shape.global_batch * shape.seq_len
        _all = dpsz * mshape.get("model", 1)
        # groups over data x model: per-group capacity (and so every dispatch
        # buffer) shrinks by |model| vs data-only groups
        if tokens % _all == 0:
            cfg = dataclasses.replace(cfg, moe_groups=_all)
        elif tokens % dpsz == 0:
            cfg = dataclasses.replace(cfg, moe_groups=dpsz)
    model = build_model(cfg, device=device)

    ab_params = model.param_shapes()
    pshard = shd.shard_params(ab_params, mesh)
    params_specs = shd.abstract_with_shardings(ab_params, pshard)

    batch_shardable = (shape.global_batch % dpsz == 0
                       and shape.global_batch >= dpsz)
    # Sequence parallelism pays off for attention-only stacks; recurrent
    # mixers consume contiguous S, so SP would gather their scan inputs
    attn_only = all(m in ("attn", "xattn") for m, _ in cfg.pattern)
    force_sp = os.environ.get("REPRO_FORCE_SP")   # A/B switch
    use_sp = attn_only if force_sp is None else force_sp == "1"
    act_spec = make_act_constrainer(
        mesh, dp if batch_shardable else None,
        sequence_parallel=(shape.kind != "decode") and use_sp)

    # MoE layout hints: dispatch groups pinned to the dp axes on both the
    # token view (G, Tg, D) and the buffer views (G, E, C, D)
    if cfg.moe_groups > 1:
        g_axes = tuple(dp) + (("model",) if cfg.moe_groups > dpsz else ())
        moe_mod.set_shard_hints(tokens=(g_axes,), experts=(g_axes,))
    else:
        moe_mod.set_shard_hints(None, None)

    def plan(fn, args, donate, context_parallel=False, out_shardings=None):
        return CellPlan(arch, shape, cfg, mesh, fn, args, donate,
                        context_parallel, out_shardings, act_spec)

    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        ab_opt = adamw.state_shapes(ab_params)
        oshard = shd.shard_opt_state(ab_opt, pshard, mesh)
        opt_specs = shd.abstract_with_shardings(ab_opt, oshard)
        batch = shd.batch_specs(cfg, shape, mesh)
        fn = build_train_step(model, opt_cfg, act_spec=act_spec,
                              microbatches=cfg.train_microbatches,
                              device=device)
        metric_sh = shd.NamedSharding(mesh, shd.P())
        out_sh = (pshard, oshard,
                  {k: metric_sh for k in
                   ("loss", "xent", "moe_aux", "grad_norm", "lr")})
        return plan(fn, (params_specs, opt_specs, batch), (0, 1),
                    out_shardings=out_sh)

    logits_sh = shd.NamedSharding(
        mesh, shd.P(dp if batch_shardable else None, None, "model"))

    if shape.kind == "prefill":
        batch = shd.batch_specs(cfg, shape, mesh)
        fn = build_prefill_step(model, act_spec=act_spec, device=device)
        return plan(fn, (params_specs, batch), (), out_shardings=logits_sh)

    # decode
    cache_specs, (seq_axes, batch_axes) = shd.cache_specs(model, cfg, shape,
                                                          mesh)
    batch = shd.batch_specs(cfg, shape, mesh)
    pos = shd.ShapeDtypeStruct((), torch.int32, shd.NamedSharding(mesh,
                                                                 shd.P()))
    cp_spec = (seq_axes, batch_axes) if seq_axes else None
    fn = build_decode_step(model, cp_spec, device=device,
                           mesh=mesh if mesh_lib.is_live(mesh) else None)
    cache_sh = tr.tree_map(lambda s: s.sharding, cache_specs)
    return plan(fn, (params_specs, cache_specs, batch["tokens"], pos), (1,),
                context_parallel=bool(seq_axes),
                out_shardings=(logits_sh, cache_sh))
