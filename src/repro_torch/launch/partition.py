"""The collectives of a step whose weights are split across ranks.

The JAX package lowers its prefill and train steps under ``plan_cell``'s
shardings, and XLA's SPMD partitioner places the collectives and, under
``jax.grad``, their transposes: that package has no file for them. This
module is the port's stand-in for the part of the partitioner that the
sharded prefill and train steps need (``launch/steps.py::
build_prefill_step`` and ``build_train_step`` on a live mesh). Each
collective pattern is one function on plain rank-local tensors (the
kernels' wrappers take plain tensors, and an explicit call can be
counted); each counts its calls in :data:`CALLS`, and every collective it
issues is counted in :data:`COLLECTIVES`, every collective of the
gradient in :data:`BACKWARD`.

The layout is ``launch/sharding.py``'s: tensor parallelism (TP) on
``model`` (a projection's output columns — wq, wk, wv, w_gate, w_up —, its
input rows — wo, w_down —, the vocabulary: tok_embed's rows, lm_head's
columns), FSDP on ``data`` (the other dim of each matrix), the batch over
the dp axes (``data.pipeline.shard_batch``). With sequence parallelism
(SP) the activations between layers are (B/|dp|, S/|model|, D), each rank
its slice of the sequence; without it (B/|dp|, S, D).

The patterns:

* :func:`fsdp_gather` — a weight's ``data`` dim gathered just before its
  product;
* :func:`column` — ``x @ w``, w's output dim on ``model``: this rank's
  columns, no collective of its own;
* :func:`row` — ``x @ w``, w's input dim on ``model``: partial sums,
  reduce-scattered over ``model`` along S with SP, else all-reduced
  (all-reduced with SP too where every rank needs the whole sum: Mamba's
  B, C and dt);
* :func:`sp_gather` — S gathered over ``model`` before each mixer and each
  FFN (``steps.make_act_constrainer``'s ``constrain`` calls it, through
  :meth:`Partition.gather_seq`);
* :func:`head_gather` — a projection's output gathered over ``model``
  along its last dim: q, k or v where the split of its columns cuts a
  head in two (qwen3's 8 KV heads of 128 on a ``model`` axis of 16: 64
  columns a rank, half a head); a recurrent mixer's input projection
  (the x/z exchange); sLSTM's heads before its column-parallel
  ``out_proj``, and that product's output;
* :func:`embed` — the vocab-parallel embedding: the ids outside this
  rank's rows masked, then reduced over ``model``;
* :func:`head` — the vocab-parallel head through ``layers.logits_f32``:
  this rank's vocabulary columns;
* :func:`last_position` — the final position's hidden state sent by the
  rank that holds it (SP) to the others of its ``model`` group;
* :func:`xent` — the train step's loss: a vocab-parallel softmax
  cross-entropy over this rank's logit columns, averaged over the global
  batch;
* :func:`moe` — a MoE FFN: this rank's dispatch groups routed, their
  buffers traded for its experts' by an all-to-all over ``data`` (EP, where
  the experts split there), gathered over ``model`` for its ``d_ff``
  columns, the partial sums reduce-scattered back, the reverse all-to-all,
  and each token's k contributions combined (:class:`MoELayout`);
* :func:`mamba`, :func:`mlstm`, :func:`slstm` — the recurrent mixers on
  this rank's channels and heads, from the patterns above.

**The gradient.** Each all-gather, reduce-scatter and all-reduce is an
autograd function whose backward is its linear transpose on the same
group: an all-gather's a reduce-scatter of the cotangent along the same
dim, a reduce-scatter's an all-gather, an all-reduce's an all-reduce, an
all-to-all's the reverse all-to-all. One
convention holds throughout: the cotangent of a value that several ranks
hold alike is held as partial sums, the true cotangent their sum over
those ranks. So the loss, which every rank holds, seeds each rank's
backward with 1/|world| (``steps.loss_and_grads``); the slice into the SP
layout is autograd's own; and a leaf's gradient is summed over every mesh
axis its spec leaves it whole on (:func:`sum_whole_leaves`), after the
FSDP gather's reduce-scatter has summed it over ``data`` where it is split
there. Megatron's pairing of an all-reduce forward with an identity
backward would over-count where a replicated value feeds a computation
that every rank runs alike (a ``d_ff`` the guard leaves whole). The
broadcast of :func:`last_position` has no transpose: it is not on the
train path, and raises under autograd rather than cut the graph.

Every group is ``mesh.axes_group``'s. A collective of a ``gloo`` group runs
on host tensors (``mesh.collective_device``), one of an ``nccl`` group on
the card; a group of one rank still issues its collective.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod

#: the slots the sharded step runs; another raises naming Queue A 10d
MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")

#: calls of each pattern since :func:`reset_counts`
CALLS: Dict[str, int] = dict.fromkeys(
    ("fsdp_gather", "column", "row", "sp_gather", "head_gather", "embed",
     "head", "last_position", "moe"), 0)
#: collectives issued by forward passes since :func:`reset_counts`
COLLECTIVES: Dict[str, int] = dict.fromkeys(
    ("all_gather", "reduce_scatter", "all_reduce", "broadcast",
     "all_to_all"), 0)
#: collectives of the gradient since :func:`reset_counts`: the forward's
#: transposes, issued by autograd (``all_gather``, ``reduce_scatter``,
#: ``all_reduce``, ``all_to_all``), each leaf's sum over the axes its spec
#: leaves it whole on (``leaf_sum``) and AdamW's sum of squares over the
#: mesh (``norm_sum``), one all-reduce each
BACKWARD: Dict[str, int] = dict.fromkeys(
    ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "leaf_sum",
     "norm_sum"), 0)


def reset_counts() -> None:
    for d in (CALLS, COLLECTIVES, BACKWARD):
        for k in d:
            d[k] = 0


def counts() -> dict:
    """``{"calls": CALLS, "collectives": COLLECTIVES}``, copied."""
    return {"calls": dict(CALLS), "collectives": dict(COLLECTIVES)}


def backward_counts() -> dict:
    """:data:`BACKWARD`, copied."""
    return dict(BACKWARD)


def local(t):
    """The rank-local tensor of ``t`` (a DTensor's ``to_local()``, as
    ``shard_batch`` gives a batch), or ``t``."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def unsupported(cfg) -> Optional[str]:
    """What of ``cfg`` the sharded step does not run (None: it runs it
    all)."""
    for mixer, ffn in cfg.pattern:
        if mixer not in MIXERS or ffn not in FFNS:
            return f"the slot ({mixer!r}, {ffn!r})"
    if cfg.vision_prefix_len:
        return "a vision prefix"
    if cfg.is_encoder_decoder:
        return "an encoder"
    if cfg.learned_pos:
        return "learned positions"
    return None


def _mixer_shapes(cfg) -> Dict[str, tuple]:
    """One layer's shape of each leaf of the recurrent mixers ``cfg``'s
    pattern has, by its path in a layer (``mamba/in_proj``): their init's,
    on the meta device."""
    inits = {"mamba": lambda: ssm_mod.mamba_init(
                 None, ssm_mod.config_dims(cfg), torch.float32),
             "mlstm": lambda: xlstm_mod.mlstm_init(
                 None, xlstm_mod.config_dims(cfg), torch.float32),
             "slstm": lambda: xlstm_mod.slstm_init(
                 None, xlstm_mod.config_dims(cfg), torch.float32)}
    out = {}
    for mixer in sorted({m for m, _f in cfg.pattern} & set(inits)):
        out.update({f"{mixer}/{k}": tuple(v.shape)
                    for k, v in inits[mixer]().items()})
    return out


def weight_specs(cfg, mesh) -> Dict[str, tuple]:
    """The spec of each weight a layer or the step reads, by its path in a
    layer (``attn/wq``; a MoE FFN's ``moe/w_gate``; a recurrent mixer's
    ``mamba/in_proj``) or in the tree (``tok_embed``): the placement rules
    and their divisibility guard (``sharding.param_spec``), at the shapes
    of one layer. A MoE leaf's spec is resolved at its stacked shape
    (repeats, E, ...) and its first entry dropped: at one layer's (E, D, F)
    the dense rules would match through their leading-repeats branch."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    F, V = cfg.d_ff, cfg.padded_vocab
    shapes = {"attn/wq": (D, H * hd), "attn/wk": (D, KV * hd),
              "attn/wv": (D, KV * hd), "attn/wo": (H * hd, D),
              "ffn/w_up": (D, F), "ffn/w_down": (F, D),
              "tok_embed": (V, D), "lm_head": (D, V)}
    if cfg.act == "swiglu":
        shapes["ffn/w_gate"] = (D, F)
    shapes.update(_mixer_shapes(cfg))
    specs = {k: shd.param_spec(tuple(k.split("/")), (s, None), mesh)
             for k, s in shapes.items()}
    if any(ffn == "moe" for _mixer, ffn in cfg.pattern):
        E, Fe, R = cfg.n_experts, cfg.expert_d_ff, cfg.repeats
        for name, s in (("router", (D, E)), ("w_gate", (E, D, Fe)),
                        ("w_up", (E, D, Fe)), ("w_down", (E, Fe, D))):
            specs[f"moe/{name}"] = shd.param_spec(
                ("ffn", name), ((R,) + s, None), mesh)[1:]
    return specs


def axis_group(mesh, axis: str):
    """``mesh.axes_group(mesh, (axis,))``, checked once a mesh and axis to
    list its ranks in the order of their coordinates on ``axis`` (a
    gather's parts and a reduce-scatter's chunks go by that order)."""
    group = mesh_lib.axes_group(mesh, (axis,))
    checked = mesh.__dict__.setdefault("_partition_checked_axes", set())
    if axis not in checked:
        ranks = dist.get_process_group_ranks(group)
        order = [mesh_lib.shard_index(mesh, (axis,), r) for r in ranks]
        if order != list(range(len(ranks))):
            raise RuntimeError(f"the group of {axis!r} lists its ranks "
                               f"{ranks} out of their coordinates {order}")
        checked.add(axis)
    return group


class MoELayout(NamedTuple):
    """Where a sharded step's MoE dispatch groups live. The batch's B·S
    tokens, flattened row by row, are ``groups`` groups of ``tokens``
    tokens (the JAX package's ``moe_apply``: one group where
    ``moe_groups`` does not divide them), each with ``capacity`` slots an
    expert. Group g lives on the rank whose coordinate over the group axes
    is g in row-major order: the groups of a data shard of the batch are
    contiguous chunks of its flattened (B/|dp|, S) rows, one chunk (of
    ``local`` groups) a ``model`` rank; where they do not split over
    ``model`` (``shared``), every rank of a ``model`` column routes all of
    its shard's groups alike."""
    groups: int
    tokens: int
    capacity: int
    local: int          # the groups this rank routes
    shared: bool        # a ``model`` column routes the same groups
    direct: bool        # this rank's SP slice is its groups' tokens
    ep: bool            # the experts split on ``data``
    split_ff: bool      # the experts' d_ff split on ``model``
    axes: tuple         # the mesh axes over which the groups differ


def moe_layout(part: "Partition") -> MoELayout:
    """The :class:`MoELayout` of ``part``'s step: ``cfg.moe_groups`` over
    the global batch (``plan_cell`` sets |dp|·|model|, |dp| or 1), which
    must split over the batch's data shards; experts on ``data`` and
    ``d_ff`` on ``model`` as the placement rules' guard leaves them."""
    cfg, act = part.cfg, part.act_spec
    dp = tuple(act.dp) if act.dp else ()
    shards = mesh_lib.axis_size(part.mesh, *dp) if dp else 1
    T = shards * part.batch_rows * part.seq_len
    G = cfg.moe_groups if T % cfg.moe_groups == 0 else 1
    if G % shards:
        raise ValueError(f"{cfg.name}: {G} MoE dispatch groups of {T} "
                         f"tokens do not split over the batch's {shards} "
                         f"data shards (plan_cell sets moe_groups)")
    per_shard, mp = G // shards, part.size["model"]
    shared = per_shard % mp != 0
    gate = part.specs["moe/w_gate"]
    return MoELayout(
        groups=G, tokens=T // G,
        capacity=moe_mod.capacity(T // G, cfg.experts_per_tok,
                                  cfg.capacity_factor, cfg.n_experts),
        local=per_shard if shared else per_shard // mp, shared=shared,
        direct=part.sp and part.batch_rows == 1 and not shared,
        ep=gate[0] == "data", split_ff=gate[2] == "model",
        axes=dp + (() if shared else ("model",)))


class Partition:
    """One sharded step's context: the mesh, this rank's coordinates, the
    weights' specs, whether the activations are sequence-parallel, and the
    step's constrainer (``act_spec``) with the sequence's global length."""

    def __init__(self, act_spec, cfg, batch_rows: int, seq_len: int):
        mesh = act_spec.mesh
        names = mesh_lib.axis_names(mesh)
        if "data" not in names or "model" not in names:
            raise ValueError(f"a sharded step needs a mesh with axes "
                             f"'data' and 'model', not {names}")
        self.mesh, self.cfg, self.act_spec = mesh, cfg, act_spec
        self.seq_len = seq_len
        self.size = {a: mesh_lib.axis_size(mesh, a) for a in ("data",
                                                              "model")}
        self.coord = mesh_lib.coordinate(mesh)
        self.specs = weight_specs(cfg, mesh)
        self.batch_rows = batch_rows
        rows = batch_rows * (mesh_lib.axis_size(mesh, *act_spec.dp)
                             if act_spec.dp else 1)
        spec = act_spec.spec((rows, seq_len, cfg.d_model))
        #: whether the activations between layers are (B/|dp|, S/|model|, D)
        self.sp = spec is not None and spec[1] == "model"
        #: the MoE FFN's groups and layout (None without one)
        self.moe = (moe_layout(self) if any(
            ffn == "moe" for _mixer, ffn in cfg.pattern) else None)

    def group(self, axis: str):
        return axis_group(self.mesh, axis)

    def gather_seq(self, h):
        """``h`` (rank-local, in the step's layout) with its whole sequence:
        the constrainer's ``full_seq`` layout (an SP gather over 'model'
        with SP, even over a 'model' axis of one rank)."""
        return self.act_spec(h, True, seq_len=self.seq_len, split=self.sp)

    def into_layout(self, h):
        """``h`` (rank-local, its whole sequence) in the step's layout:
        this rank's slice of the sequence with SP, no collective."""
        return self.act_spec(h, False, seq_len=self.seq_len, split=False)


def for_model(act_spec, cfg, tokens) -> Optional[Partition]:
    """The :class:`Partition` of a step over ``tokens`` (this rank's rows)
    under ``act_spec``, or None: no constrainer, or one of an abstract
    mesh, or a world of one rank with a config the sharded step does not
    run (its tensors are whole). On a live mesh of several ranks such a
    config raises ``NotImplementedError``."""
    if act_spec is None:
        return None
    mesh = act_spec.mesh
    if not mesh_lib.is_live(mesh):
        return None
    what = unsupported(cfg)
    if what is not None:
        if mesh_lib.world_of(mesh) > 1:
            raise NotImplementedError(
                f"{cfg.name}: the sharded step runs self-attention, Mamba, "
                f"mLSTM and sLSTM with dense or MoE FFNs only; {what} under "
                f"a mesh of several ranks is ROADMAP Queue A 10d")
        return None
    return Partition(act_spec, cfg, tokens.shape[0], tokens.shape[1])


# ---------------------------------------------------------------------------
# collectives on plain tensors
# ---------------------------------------------------------------------------

def _on(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` contiguous on the group's collective device (a copy where it
    moves, else ``t`` itself when already contiguous)."""
    return t.contiguous().to(mesh_lib.collective_device(group))


def _gather_raw(t: torch.Tensor, dim: int, group, tally) -> torch.Tensor:
    """The group's shards of ``dim`` concatenated in coordinate order,
    contiguous, on ``t``'s device (counted in ``tally``)."""
    tally["all_gather"] += 1
    src = _on(t.movedim(dim, 0), group)
    n = dist.get_world_size(group)
    # the parts are views of one buffer: no concatenation after the gather
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather(list(out.chunk(n)), src, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def _scatter_raw(t: torch.Tensor, dim: int, group, tally) -> torch.Tensor:
    """The sum over the group of ``t``'s chunk along ``dim`` that this
    rank's coordinate names (the group lists its ranks in coordinate
    order: :func:`axis_group`), on ``t``'s device."""
    tally["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    chunks = [_on(c, group) for c in t.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(t.device)


def _reduce_raw(t: torch.Tensor, group, tally, key: str = "all_reduce",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of ``t`` over the group, into a new tensor on ``t``'s
    device (counted as ``tally[key]``)."""
    tally[key] += 1
    buf = _on(t, group)
    if buf is t:
        buf = t.clone()             # never into the caller's tensor
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def _all_to_all_raw(t: torch.Tensor, split_dim: int, cat_dim: int, group,
                    tally) -> torch.Tensor:
    """``t`` cut into the group's size of chunks along ``split_dim``, chunk
    j sent to the group's rank j (by coordinate), the chunks received
    concatenated along ``cat_dim`` in the order of their senders, on
    ``t``'s device (counted in ``tally``)."""
    tally["all_to_all"] += 1
    n = dist.get_world_size(group)
    src = _on(t.movedim(split_dim, 0), group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    parts = out.to(t.device).chunk(n)
    return torch.cat([c.movedim(0, split_dim) for c in parts], cat_dim)


class _AllToAll(torch.autograd.Function):
    """An all-to-all (:func:`_all_to_all_raw`); its transpose the reverse
    all-to-all of the cotangent (``cat_dim`` split, ``split_dim``
    concatenated) on the same group."""

    @staticmethod
    def forward(ctx, t, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _all_to_all_raw(t, split_dim, cat_dim, group, COLLECTIVES)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return (_all_to_all_raw(g, cat_dim, split_dim, ctx.group, BACKWARD),
                None, None, None)


class _AllGather(torch.autograd.Function):
    """An all-gather along ``dim``; its transpose the reduce-scatter of the
    cotangent (partial sums) along it."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_raw(t, dim, group, COLLECTIVES)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, ctx.dim, ctx.group, BACKWARD), None, None


class _ReduceScatter(torch.autograd.Function):
    """A reduce-scatter along ``dim``; its transpose the all-gather of the
    cotangent along it."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_raw(t, dim, group, COLLECTIVES)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.dim, ctx.group, BACKWARD), None, None


class _AllReduce(torch.autograd.Function):
    """An all-reduce (sum); its transpose the all-reduce of the cotangent's
    partial sums."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _reduce_raw(t, group, COLLECTIVES)

    @staticmethod
    def backward(ctx, g):
        return _reduce_raw(g, ctx.group, BACKWARD), None


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _AllGather.apply(t, dim, group)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ReduceScatter.apply(t, dim, group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(t, group)


def _all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int,
                group) -> torch.Tensor:
    return _AllToAll.apply(t, split_dim, cat_dim, group)


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (by coordinate) on every rank. It
    has no transpose: under autograd, on a tensor that requires a
    gradient, it raises rather than cut the graph."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("the broadcast of the last position is not on "
                           "the train path and has no transpose")
    COLLECTIVES["broadcast"] += 1
    buf = torch.empty(t.shape, dtype=t.dtype,
                      device=mesh_lib.collective_device(group))
    buf.copy_(t)                    # never into the caller's tensor
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.device)


def _reduce_model(part: Partition, y: torch.Tensor) -> torch.Tensor:
    """Partial sums over ``model``: reduce-scattered along S with SP, else
    all-reduced."""
    group = part.group("model")
    if part.sp:
        return _reduce_scatter(y, 1, group)
    return _all_reduce(y, group)


# ---------------------------------------------------------------------------
# the patterns
# ---------------------------------------------------------------------------

def fsdp_gather(part: Partition, w: torch.Tensor, key: str) -> torch.Tensor:
    """Weight ``key`` with its ``data`` dim gathered (as it is where its
    spec does not split it on ``data``)."""
    for d, entry in enumerate(part.specs[key]):
        if entry == "data":
            CALLS["fsdp_gather"] += 1
            w = _all_gather(w, d, part.group("data"))
    return w


def column(part: Partition, x: torch.Tensor, w: torch.Tensor,
           key: str) -> torch.Tensor:
    """``x @ w`` of a column-parallel weight: this rank's output columns
    (all of them where the guard left the dim whole)."""
    CALLS["column"] += 1
    return layers.dense(x, fsdp_gather(part, w, key))


def row(part: Partition, x: torch.Tensor, w: torch.Tensor,
        key: str, whole: bool = False) -> torch.Tensor:
    """``x @ w`` of a row-parallel weight on ``x`` (B, S, this rank's
    input columns): the partial sums reduced over ``model``, into the SP
    layout with SP. A weight whose input dim the guard left whole gives the
    whole sum on every rank, constrained into the step's layout. With
    ``whole`` the sum stays whole over the sequence (all-reduced with SP
    too): a value a recurrent mixer's scan reads on every rank."""
    CALLS["row"] += 1
    y = layers.dense(x, fsdp_gather(part, w, key))
    if part.specs[key][0] == "model":
        if whole:
            return _all_reduce(y, part.group("model"))
        return _reduce_model(part, y)
    return y if whole else part.into_layout(y)


def sp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(B, S/|model|, ...) -> (B, S, ...): the sequence gathered over
    ``model``."""
    CALLS["sp_gather"] += 1
    return _all_gather(x, 1, axis_group(mesh, "model"))


def head_gather(part: Partition, t: torch.Tensor) -> torch.Tensor:
    """(..., columns / |model|) -> (..., columns): a projection's output
    gathered over ``model``, where its split cuts a head."""
    CALLS["head_gather"] += 1
    return _all_gather(t, t.dim() - 1, part.group("model"))


def _heads(part: Partition, t: torch.Tensor, n: int,
           hd: Optional[int] = None) -> tuple:
    """(t with whole heads, (first, end) of the heads it holds) for a
    projection of ``n`` heads of ``hd`` columns (the config's head dim by
    default): this rank's where its columns hold whole heads, all of them
    (gathered) where they cut one."""
    hd = part.cfg.hd if hd is None else hd
    mp = part.size["model"]
    if t.shape[-1] == n * hd:
        return t, (0, n)
    if n % mp:
        return head_gather(part, t), (0, n)
    r = part.coord["model"]
    return t, (r * n // mp, (r + 1) * n // mp)


def qkv(part: Partition, x: torch.Tensor, p: Dict) -> tuple:
    """q (B, S, Hl, hd) and k, v (B, S, KVl, hd) of one self-attention on
    the gathered ``x`` (B, S, D): whole heads, q this rank's query heads,
    k and v the KV heads those read, so that ``flash_attention``'s rule
    (query head h reads KV head h // (Hl / KVl)) holds on the local heads.
    Where KV % |model| != 0 the column split of wk and wv cuts a head: k
    and v are gathered over ``model`` and the heads taken from them (so is
    q where H % |model| != 0: every rank then runs every query head)."""
    cfg = part.cfg
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    q, (h0, h1) = _heads(part, column(part, x, p["wq"], "attn/wq"), H)
    kv0, kv1 = h0 // G, (h1 - 1) // G + 1
    if not (kv1 - kv0 == 1 or (h0 % G == 0 and (h1 - h0) % G == 0)):
        raise ValueError(f"query heads {h0}-{h1 - 1} of {H} on this rank "
                         f"read KV heads {kv0}-{kv1 - 1} of {KV} unevenly")

    def kv_heads(w, key):
        t, (a, _b) = _heads(part, column(part, x, w, key), KV)
        t = t.reshape(B, S, -1, hd)
        if (a, a + t.shape[2]) != (kv0, kv1):
            t = t[:, :, kv0 - a:kv1 - a].contiguous()
        return t
    return (q.reshape(B, S, h1 - h0, hd), kv_heads(p["wk"], "attn/wk"),
            kv_heads(p["wv"], "attn/wv"))


def out_columns(part: Partition, o: torch.Tensor) -> torch.Tensor:
    """The attention's output (B, S, Hl, hd) as wo's local input rows
    need it: (B, S, Hl·hd), cut to this rank's columns where q was
    gathered whole (H % |model| != 0). A wo whose input dim the guard left
    whole has a whole q too: H·hd decides both."""
    B, S, nl, hd = o.shape
    o = o.reshape(B, S, nl * hd)
    mp = part.size["model"]
    if part.specs["attn/wo"][0] != "model" or nl * mp == part.cfg.n_heads:
        return o
    c = nl * hd // mp
    r = part.coord["model"]
    return o[..., r * c:(r + 1) * c]


def embed(part: Partition, tokens: torch.Tensor,
          table: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens`` (this rank's rows, the whole sequence)
    from a vocab-parallel table (this rank's rows of the vocabulary): the
    ids outside them give zeros, and the sum over ``model`` gives each its
    row, in the SP layout with SP."""
    CALLS["embed"] += 1
    w = fsdp_gather(part, table, "tok_embed")
    if part.specs["tok_embed"][0] != "model":
        return part.into_layout(layers.embed(tokens, w))
    rows = w.shape[0]
    ids = tokens - part.coord["model"] * rows
    keep = (ids >= 0) & (ids < rows)
    x = layers.embed(ids.clamp(0, rows - 1), w)
    x = torch.where(keep[..., None], x, x.new_zeros(()))
    return _reduce_model(part, x)


def head(part: Partition, x: torch.Tensor, params: Dict) -> torch.Tensor:
    """Float32 logits (..., Vpad/|model|) of ``x`` (whole D) against this
    rank's vocabulary columns of the head (lm_head, or tok_embed's
    transpose when tied)."""
    CALLS["head"] += 1
    if part.cfg.tie_embeddings:
        w = fsdp_gather(part, params["tok_embed"], "tok_embed").T
    else:
        w = fsdp_gather(part, params["lm_head"], "lm_head")
    return layers.logits_f32(x, w)


def last_position(part: Partition, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, D): the hidden state at the sequence's last position. With SP
    the last rank of ``model`` holds it and sends it to the others; that
    rank keeps its own view (strided as the step without a mesh has it, so
    that a world of one rank gives that step's logits bit for bit)."""
    CALLS["last_position"] += 1
    last = x[:, -1:]
    if not part.sp:
        return last
    src = part.size["model"] - 1
    got = _broadcast(last, src, part.group("model"))
    return last if part.coord["model"] == src else got


def moe(part: Partition, h: torch.Tensor, p: Dict, stats: bool = False,
        gathered: bool = False) -> tuple:
    """A MoE FFN on this rank's dispatch groups (``part.moe``): (y in the
    step's layout, the layer's aux — the mean over all the groups, the
    same on every rank —, its :class:`models.moe.MoEStats` over all the
    groups, or None without ``stats``). ``h`` is the normed input in the
    step's layout (its whole sequence with ``gathered``: a parallel
    block's), ``p`` this rank's shards of the FFN's weights.

    The schedule, fixed: the router gathered over ``data`` (FSDP); this
    rank's groups taken from its tokens (the sequence gathered first unless
    its SP slice is its groups, ``direct``) and routed with
    ``models/moe.py``'s ``_route`` at a global group's capacity; scattered
    into (groups, E, C, D); with EP an all-to-all over ``data`` trades each
    rank's expert chunks for the other ranks' groups; with d_ff split on
    ``model`` the groups of the ``model`` column gathered (unless they are
    ``shared``); gate and up on this rank's d_ff columns and down as
    partial sums (``_expert_ffn`` on the local shards), reduce-scattered
    over ``model`` back along the groups (all-reduced where they are
    shared); the reverse all-to-all; each token's k contributions combined
    in k order; the output gathered over ``model`` and put into the step's
    layout (unless ``direct``). ``aux`` and the statistics are each one
    all-reduce over the group axes, each group counted once."""
    CALLS["moe"] += 1
    cfg, lay = part.cfg, part.moe
    E, k, D = cfg.n_experts, cfg.experts_per_tok, cfg.d_model
    Tg, C, n = lay.tokens, lay.capacity, lay.local
    m = part.coord["model"]
    router = fsdp_gather(part, p["router"], "moe/router")
    rows, S = h.shape[0], part.seq_len
    if lay.direct and not gathered:
        xt = h.reshape(n * Tg, D)
    else:
        full = (h if gathered else part.gather_seq(h)).reshape(rows * S, D)
        lo = 0 if lay.shared else m * n * Tg
        xt = full[lo:lo + n * Tg]
    xg = xt.reshape(n, Tg, D)
    routes = [moe_mod._route(xg[g], router, E, k, C, cfg.ws_rebalance)
              for g in range(n)]
    buf = moe_mod.dispatch(xg, routes, E, C)                    # (n,E,C,D)
    if lay.ep:
        buf = _all_to_all(buf, 1, 0, part.group("data"))
    if lay.split_ff and not lay.shared:
        buf = _all_gather(buf, 0, part.group("model"))
    groups, e_local = buf.shape[0], buf.shape[1]
    xb = buf.transpose(0, 1).reshape(e_local, groups * C, D)
    out = moe_mod._expert_ffn(p, xb).reshape(e_local, groups, C, D) \
        .transpose(0, 1)
    if lay.split_ff:
        out = (_all_reduce(out, part.group("model")) if lay.shared
               else _reduce_scatter(out, 0, part.group("model")))
    if lay.ep:
        out = _all_to_all(out, 0, 1, part.group("data"))
    y = moe_mod.combine(out, routes, k).reshape(n * Tg, D)
    if lay.direct:
        y = y.reshape(rows, -1, D)
    else:
        if not lay.shared:
            y = _all_gather(y, 0, part.group("model"))
        y = part.into_layout(y.reshape(rows, S, D))
    aux, dropped, stolen, load = moe_mod.group_stats(routes, E)
    group = (mesh_lib.axes_group(part.mesh, lay.axes) if lay.axes
             else None)
    aux = torch.stack(aux).sum()
    if group is not None:
        aux = _all_reduce(aux, group)
    aux = aux / lay.groups
    if not stats:
        return y, aux, None
    sums = torch.cat([torch.stack(dropped).sum()[None],
                      torch.stack(stolen).sum()[None],
                      torch.stack(load).sum(0).float()]).detach()
    if group is not None:
        sums = _reduce_raw(sums, group, COLLECTIVES)
    return y, aux, moe_mod.MoEStats(
        dropped=sums[0] / lay.groups, stolen=sums[1] / lay.groups,
        load_std=torch.std(sums[2:], correction=0))


# ---------------------------------------------------------------------------
# the recurrent mixers
# ---------------------------------------------------------------------------

def _span(part: Partition, key: str, dim: int, n: int) -> tuple:
    """(first, end) of the ``n`` entries of weight ``key``'s dim ``dim``
    this rank holds: its share where the spec splits the dim on
    ``model``, all of them where the guard left it whole."""
    if part.specs[key][dim] != "model":
        return 0, n
    c, r = n // part.size["model"], part.coord["model"]
    return r * c, (r + 1) * c


def _input_halves(part: Partition, h: torch.Tensor, w: torch.Tensor,
                  key: str) -> torch.Tensor:
    """``h @ w`` of a recurrent mixer's input projection (D, 2E), whose
    output the mixer cuts at E into x and z: its columns on ``model`` hold
    x on the first ranks and z on the last, so the output is gathered
    whole over ``model`` (the x/z exchange, one :func:`head_gather`) and
    each rank takes from it what its channels read."""
    xz = column(part, h, w, key)
    if part.specs[key][1] == "model":
        xz = head_gather(part, xz)
    return xz


def mamba(part: Partition, h: torch.Tensor, p: Dict) -> torch.Tensor:
    """A Mamba mixer on the gathered ``h`` (B, S, D): its output in the
    step's layout. ``p`` is this rank's shards of the mixer's weights.

    The schedule, fixed: ``in_proj`` column-parallel and the x/z exchange
    (:func:`_input_halves`); this rank's E/|model| channels of x (those of
    its ``conv_w`` columns) through the causal conv, and the same channels
    of z; B, C and dt as row products of those channels (``bc_proj`` and
    ``dt_proj`` split on their rows), each all-reduced over ``model``
    whatever the layout (the scan reads them over the whole sequence); the
    scan of this rank's heads (of P channels) with their dt, ``A_log`` and
    ``D`` — where its channels cut a head, the conv's output is gathered
    over ``model`` and every rank scans every head —; the gate of its
    channels; ``out_proj`` row-parallel. The whole leaves ``dt_bias``,
    ``A_log`` and ``D``, and B, C and dt, which every rank computes alike,
    are read only for this rank's heads: their cotangents are partial sums
    (the module's convention), summed by the transposes and
    :func:`sum_whole_leaves`."""
    cfg = part.cfg
    d = ssm_mod.config_dims(cfg)
    E, P = d.d_inner, d.head_p
    xz = _input_halves(part, h, p["in_proj"], "mamba/in_proj")
    c0, c1 = _span(part, "mamba/conv_w", 1, E)
    xr = ssm_mod.conv_silu(xz[..., c0:c1], p["conv_w"])
    Bm, Cm, dt = ssm_mod.scan_inputs(
        row(part, xr, p["bc_proj"], "mamba/bc_proj", whole=True),
        row(part, xr, p["dt_proj"], "mamba/dt_proj", whole=True),
        p["dt_bias"])
    if (c1 - c0) % P:                       # the split cuts a head
        xs, h0, h1 = head_gather(part, xr), 0, d.n_heads
    else:
        xs, h0, h1 = xr, c0 // P, c1 // P
    y = ssm_mod.ssd_heads(xs, Bm, Cm, dt[..., h0:h1], p["A_log"][h0:h1],
                          p["D"][h0:h1], P, cfg.ssm_chunk)
    if (h0 * P, h1 * P) != (c0, c1):
        y = y[..., c0 - h0 * P:c1 - h0 * P]
    y = ssm_mod.gate(y, xz[..., E + c0:E + c1])
    return row(part, y.to(h.dtype), p["out_proj"], "mamba/out_proj")


def mlstm(part: Partition, h: torch.Tensor, p: Dict) -> torch.Tensor:
    """An mLSTM mixer on the gathered ``h`` (B, S, D): its output in the
    step's layout. ``p`` is this rank's shards of the mixer's weights.

    The schedule, fixed: ``up_proj`` column-parallel and the x/z exchange
    (:func:`_input_halves`: ``wq``, ``wk`` and ``wv`` read all E rows of
    x); q, k and v column-parallel, this rank's heads (all of them,
    gathered, where the split cuts a head: :func:`_heads`); the i and f
    gates from ``w_if`` (whole on ``model``: every rank computes every
    head's, and reads its own); the chunked recurrence of its heads; the
    out-norm scale and silu(z) of its ``down_proj`` rows' channels;
    ``down_proj`` row-parallel."""
    cfg = part.cfg
    d = xlstm_mod.config_dims(cfg)
    E, hd = int(d.proj_factor * cfg.d_model), d.head_dim
    H = E // hd
    xz = _input_halves(part, h, p["up_proj"], "mlstm/up_proj")
    xr = xz[..., :E]
    q, (h0, h1) = _heads(part, column(part, xr, p["wq"], "mlstm/wq"), H, hd)
    k, _ = _heads(part, column(part, xr, p["wk"], "mlstm/wk"), H, hd)
    v, _ = _heads(part, column(part, xr, p["wv"], "mlstm/wv"), H, hd)
    i_gate, f_gate = xlstm_mod.mlstm_gates(column(part, xr, p["w_if"],
                                                  "mlstm/w_if"))
    y = xlstm_mod.mlstm_heads(q, k, v, i_gate[..., h0:h1],
                              f_gate[..., h0:h1], hd, cfg.ssm_chunk)
    c0, c1 = _span(part, "mlstm/down_proj", 0, E)
    if (h0 * hd, h1 * hd) != (c0, c1):
        y = y[..., c0 - h0 * hd:c1 - h0 * hd]
    y = xlstm_mod.mlstm_gate(y, p["out_norm"][c0:c1], xz[..., E + c0:E + c1])
    return row(part, y.to(h.dtype), p["down_proj"], "mlstm/down_proj")


def slstm(part: Partition, h: torch.Tensor, p: Dict) -> torch.Tensor:
    """An sLSTM mixer on the gathered ``h`` (B, S, D): its output in the
    step's layout. ``p`` is this rank's shards of the mixer's weights.

    The schedule, fixed: ``w_in`` column-parallel, its (i, f, z, o)
    blocks of 4·hd columns a head: this rank's heads (all of them,
    gathered, where the split cuts a head: :func:`_heads`); the recurrence
    of those heads with their slices of the whole ``r_rec`` and ``bias``;
    the heads' h gathered over ``model`` where the rank holds only its own
    (``out_proj`` is column-parallel on its output and reads every input
    row); ``out_proj``'s output columns gathered over ``model`` and put
    into the step's layout."""
    cfg = part.cfg
    d = xlstm_mod.config_dims(cfg)
    H, hd = d.n_heads, d.head_dim
    pre, (h0, h1) = _heads(part, column(part, h, p["w_in"], "slstm/w_in"),
                           H, 4 * hd)
    y = xlstm_mod.slstm_scan(pre, p["r_rec"][h0:h1],
                             p["bias"][4 * hd * h0:4 * hd * h1]).to(h.dtype)
    if (h0, h1) != (0, H):
        y = head_gather(part, y)
    y = column(part, y, p["out_proj"], "slstm/out_proj")
    if part.specs["slstm/out_proj"][1] == "model":
        y = head_gather(part, y)
    return part.into_layout(y)


MIXER_PATTERNS = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}


# ---------------------------------------------------------------------------
# the train step: the loss and the gradient's sums
# ---------------------------------------------------------------------------

class _VocabNLL(torch.autograd.Function):
    """The negative log-likelihood of each position's label, (B, S) float32
    and the same on every rank of ``group``, from this rank's logit columns
    ``lo`` ... ``lo + V_l`` (B, S, V_l) float32: the maximum all-reduced
    (MAX, outside the gradient), the sum of exponentials and the gold logit
    (taken by the rank whose columns hold it) all-reduced. ``group`` None:
    the logits hold every column. The forward is ``torch.logsumexp``'s
    arithmetic and the backward that of ``logsumexp`` and ``gather``
    (``exp(l - lse)`` times the cotangent, its negative added at the
    label), so that a group of one gives ``layers.softmax_xent``'s loss and
    gradient bit for bit. The cotangent is partial sums over the group
    (the module's convention): the backward all-reduces it first."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, group):
        m = torch.amax(logits, dim=-1, keepdim=True)
        if group is not None:
            m = _reduce_raw(m, group, COLLECTIVES, op=dist.ReduceOp.MAX)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = torch.sum(torch.exp(logits - m), dim=-1)
        idx = labels.long() - lo
        keep = (idx >= 0) & (idx < logits.shape[-1])
        idx = idx.clamp(0, logits.shape[-1] - 1)[..., None]
        gold = torch.gather(logits, -1, idx)[..., 0]
        if group is not None:
            s = _reduce_raw(s, group, COLLECTIVES)
            gold = _reduce_raw(torch.where(keep, gold, 0.0), group,
                               COLLECTIVES)
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(logits, lse, idx, keep)
        ctx.group = group
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, keep = ctx.saved_tensors
        if ctx.group is not None:
            g = _reduce_raw(g, ctx.group, BACKWARD)
        d = g[..., None] * torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, idx, torch.where(keep, -g, 0.0)[..., None])
        return d, None, None, None


def xent(part: Partition, logits: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross-entropy of the global batch (float32, one
    element, the same on every rank) from this rank's logits (B/|dp|, S,
    Vpad/|model|) and labels (B/|dp|, S): the JAX package's
    ``softmax_xent`` over every column of the padded vocabulary, the
    log-sum-exp vocab-parallel (:class:`_VocabNLL`), the mean this rank's
    positions' mean over the batch's share it holds, summed over the dp
    axes. A head whose vocabulary the guard left whole gives every column
    on every rank, and the loss needs no collective over ``model``."""
    cfg = part.cfg
    key, d = ("tok_embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    split = part.specs[key][d] == "model"
    lo = part.coord["model"] * logits.shape[-1] if split else 0
    nll = _VocabNLL.apply(logits.float(), labels, lo,
                          part.group("model") if split else None)
    loss = torch.mean(nll)
    dp = part.act_spec.dp
    if not dp:
        return loss
    n = mesh_lib.axis_size(part.mesh, *dp)
    if n > 1:
        loss = loss * (1.0 / n)
    return _all_reduce(loss, mesh_lib.axes_group(part.mesh, dp))


def _whole_axes(sharding, mesh) -> tuple:
    """The mesh axes on which ``sharding``'s spec leaves its leaf whole."""
    used = set()
    for entry in sharding.spec:
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
    return tuple(a for a in mesh_lib.axis_names(mesh) if a not in used)


def sum_whole_leaves(grads, shardings, mesh):
    """Each leaf's gradient (this rank's shard, partial sums over the axes
    its spec leaves it whole on) summed over those axes: one all-reduce a
    leaf that has any, counted as ``BACKWARD["leaf_sum"]``. The norms are
    whole on every axis; a matrix the guard left whole on ``model`` is
    summed there after its FSDP gather's reduce-scatter over ``data``."""
    def one(g, sharding):
        axes = _whole_axes(sharding, mesh)
        if not axes:
            return g
        return _reduce_raw(g, mesh_lib.axes_group(mesh, axes), BACKWARD,
                           "leaf_sum")
    return tr.tree_map(one, grads, shardings)


def sum_squares(squares: List[torch.Tensor], shardings: list,
                mesh) -> List[torch.Tensor]:
    """Each leaf's sum of squares over the whole mesh from this rank's
    (``squares``, float32 of one element a leaf, the leaves in pytree
    order): the shards of a split leaf summed over the ranks that hold
    them, a leaf held alike on several ranks counted once (by the rank
    whose coordinate is 0 on every axis that holds it alike). One
    all-reduce, counted as ``BACKWARD["norm_sum"]``."""
    coord = mesh_lib.coordinate(mesh)
    mine = [s if not any(coord[a] for a in _whole_axes(sh, mesh))
            else torch.zeros_like(s) for s, sh in zip(squares, shardings)]
    total = _reduce_raw(torch.stack(mine), mesh_lib.mesh_group(mesh),
                        BACKWARD, "norm_sum")
    return list(total.unbind())
