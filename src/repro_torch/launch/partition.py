"""The collectives of a step whose weights are split across ranks.

The JAX package lowers its prefill step under ``plan_cell``'s shardings,
and XLA's SPMD partitioner places the collectives: that package has no
file for them. This module is the port's stand-in for the part of the
partitioner that the sharded prefill step needs
(``launch/steps.py::build_prefill_step`` on a live mesh). Each collective
pattern is one function on plain rank-local tensors (the kernels' wrappers
take plain tensors, and an explicit call can be counted); each counts its
calls in :data:`CALLS`, and every collective it issues is counted in
:data:`COLLECTIVES`.

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
  reduce-scattered over ``model`` along S with SP, else all-reduced;
* :func:`sp_gather` — S gathered over ``model`` before each mixer and each
  FFN (``steps.make_act_constrainer``'s ``constrain`` calls it, through
  :meth:`Partition.gather_seq`);
* :func:`head_gather` — q, k or v gathered over ``model`` where the split
  of its columns cuts a head in two (qwen3's 8 KV heads of 128 on a
  ``model`` axis of 16: 64 columns a rank, half a head);
* :func:`embed` — the vocab-parallel embedding: the ids outside this
  rank's rows masked, then reduced over ``model``;
* :func:`head` — the vocab-parallel head through ``layers.logits_f32``:
  this rank's vocabulary columns;
* :func:`last_position` — the final position's hidden state sent by the
  rank that holds it (SP) to the others of its ``model`` group.

Every group is ``mesh.axes_group``'s. A collective of a ``gloo`` group runs
on host tensors (``mesh.collective_device``), one of an ``nccl`` group on
the card; a group of one rank still issues its collective.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import layers

#: the slots the sharded step runs; another raises naming Queue A 10d
MIXERS = ("attn",)
FFNS = ("dense",)

#: calls of each pattern since :func:`reset_counts`
CALLS: Dict[str, int] = dict.fromkeys(
    ("fsdp_gather", "column", "row", "sp_gather", "head_gather", "embed",
     "head", "last_position"), 0)
#: collectives issued since :func:`reset_counts`
COLLECTIVES: Dict[str, int] = dict.fromkeys(
    ("all_gather", "reduce_scatter", "all_reduce", "broadcast"), 0)


def reset_counts() -> None:
    for d in (CALLS, COLLECTIVES):
        for k in d:
            d[k] = 0


def counts() -> dict:
    """``{"calls": CALLS, "collectives": COLLECTIVES}``, copied."""
    return {"calls": dict(CALLS), "collectives": dict(COLLECTIVES)}


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


def weight_specs(cfg, mesh) -> Dict[str, tuple]:
    """The spec of each weight a layer or the step reads, by its path in a
    layer (``attn/wq``) or in the tree (``tok_embed``): the placement rules
    and their divisibility guard (``sharding.param_spec``), at the shapes
    of one layer."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    F, V = cfg.d_ff, cfg.padded_vocab
    shapes = {"attn/wq": (D, H * hd), "attn/wk": (D, KV * hd),
              "attn/wv": (D, KV * hd), "attn/wo": (H * hd, D),
              "ffn/w_up": (D, F), "ffn/w_down": (F, D),
              "tok_embed": (V, D), "lm_head": (D, V)}
    if cfg.act == "swiglu":
        shapes["ffn/w_gate"] = (D, F)
    return {k: shd.param_spec(tuple(k.split("/")), (s, None), mesh)
            for k, s in shapes.items()}


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
        rows = batch_rows * (mesh_lib.axis_size(mesh, *act_spec.dp)
                             if act_spec.dp else 1)
        spec = act_spec.spec((rows, seq_len, cfg.d_model))
        #: whether the activations between layers are (B/|dp|, S/|model|, D)
        self.sp = spec is not None and spec[1] == "model"

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
                f"{cfg.name}: the sharded step runs attention and dense "
                f"FFNs only; {what} under a mesh of several ranks is "
                f"ROADMAP Queue A 10d")
        return None
    return Partition(act_spec, cfg, tokens.shape[0], tokens.shape[1])


# ---------------------------------------------------------------------------
# collectives on plain tensors
# ---------------------------------------------------------------------------

def _on(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` contiguous on the group's collective device (a copy where it
    moves, else ``t`` itself when already contiguous)."""
    return t.contiguous().to(mesh_lib.collective_device(group))


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``dim`` concatenated in coordinate order,
    contiguous, on ``t``'s device."""
    COLLECTIVES["all_gather"] += 1
    src = _on(t.movedim(dim, 0), group)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device).movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``t``'s chunk along ``dim`` that this
    rank's coordinate names (the group lists its ranks in coordinate
    order: :func:`axis_group`), on ``t``'s device."""
    COLLECTIVES["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    chunks = [_on(c, group) for c in t.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(t.device)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    buf = _on(t, group)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (by coordinate) on every rank."""
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
        key: str) -> torch.Tensor:
    """``x @ w`` of a row-parallel weight on ``x`` (B, S, this rank's
    input columns): the partial sums reduced over ``model``, into the SP
    layout with SP. A weight whose input dim the guard left whole gives the
    whole sum on every rank, constrained into the step's layout."""
    CALLS["row"] += 1
    y = layers.dense(x, fsdp_gather(part, w, key))
    if part.specs[key][0] == "model":
        return _reduce_model(part, y)
    return part.into_layout(y)


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


def _heads(part: Partition, t: torch.Tensor, n: int) -> tuple:
    """(t with whole heads, (first, end) of the heads it holds) for a
    projection of ``n`` heads of hd: this rank's where its columns hold
    whole heads, all of them (gathered) where they cut one."""
    hd, mp = part.cfg.hd, part.size["model"]
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
