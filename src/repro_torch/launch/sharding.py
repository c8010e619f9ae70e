"""Sharding policy: parameter/optimizer/batch/cache partition specs.

Scheme (DESIGN.md §5): TP on ``model`` (heads / d_ff / vocab), FSDP on
``data`` (the other matrix axis; optimizer state fully sharded), DP batch on
``('pod','data')``, EP on ``data`` when the expert count divides it,
context-parallel KV on ``('pod','data')`` for the long-decode shape.

Rules are *path-based* (regex on the flattened param path) with a
divisibility guard: any dim that doesn't divide its mesh axis extent is
replicated instead (e.g. GQA KV heads 8 on a 16-way model axis).

A spec is a tuple with one entry a dim, as ``jax.sharding.PartitionSpec``
is: ``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over their product, the first the slowest); a spec may be shorter
than the rank (the dims past it replicated). :class:`NamedSharding` pairs a
spec with a mesh (an ``AbstractMesh`` or a DeviceMesh): the shape of the
shard a rank holds (:meth:`NamedSharding.shard_shape`), the rank's slice of
the whole (:meth:`NamedSharding.local_index`), and on a live mesh the
DTensor placements (:meth:`NamedSharding.placements`). Leaves of an
abstract tree are :class:`ShapeDtypeStruct` (shape, torch dtype, sharding).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import (axis_names, axis_size, dp_axes,
                                     mesh_shape, shard_index)

# (path-regex, spec-per-dim) — first match wins. Specs name mesh axes; the
# divisibility guard downgrades un-divisible entries to None (replicated).
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"tok_embed$",                ("model", "data")),
    (r"pos_embed$",                (None, "data")),
    (r"lm_head$",                  ("data", "model")),
    (r"(final_norm|norm|norm1|norm2|xnorm|out_norm)$", (None,)),
    (r"(q_norm|k_norm)$",          (None,)),
    # attention (leading repeats axis when inside stacked layers)
    (r"attn/w[qkv]$",              ("data", "model")),
    (r"attn/wo$",                  ("model", "data")),
    # dense mlp
    (r"ffn/w_(gate|up)$",          ("data", "model")),
    (r"ffn/w_down$",               ("model", "data")),
    # moe: experts on data when divisible (EP), else fall back inside guard
    (r"ffn/router$",               ("data", None)),
    (r"ffn/(w_gate|w_up)$",        ("data", None, "model")),   # (E, D, F)
    (r"ffn/w_down$",               ("data", "model", None)),
    # mamba
    (r"mamba/in_proj$",            ("data", "model")),
    (r"mamba/conv_w$",             (None, "model")),
    (r"mamba/bc_proj$",            ("model", None)),
    (r"mamba/dt_proj$",            ("model", None)),
    (r"mamba/(dt_bias|A_log|D)$",  (None,)),
    (r"mamba/out_proj$",           ("model", "data")),
    # xlstm
    (r"mlstm/up_proj$",            ("data", "model")),
    (r"mlstm/w[qkv]$",             ("data", "model")),
    (r"mlstm/w_if$",               ("data", None)),
    (r"mlstm/down_proj$",          ("model", "data")),
    (r"slstm/w_in$",               ("data", "model")),
    (r"slstm/r_rec$",              (None, None, None)),
    (r"slstm/out_proj$",           ("data", "model")),
    # encoder nested copies resolve through the same rules above
)


def P(*entries) -> tuple:
    """A spec: one entry a dim (``PartitionSpec``'s counterpart, which also
    writes an entry of one axis as the axis's name and of none as None)."""
    return tuple(e if not isinstance(e, (tuple, list))
                 else (None if not e else e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec laid onto a mesh."""
    mesh: Any
    spec: tuple

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of the shard one rank holds of a ``shape`` array."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = axis_size(self.mesh, *_entry_axes(entry))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split {n} ways ({self.spec})")
            out[d] //= n
        return tuple(out)

    def global_shape(self, local_shape) -> Tuple[int, ...]:
        """The shape of the whole array whose shard is ``local_shape``."""
        out = list(local_shape)
        for d, entry in enumerate(self.spec):
            out[d] *= axis_size(self.mesh, *_entry_axes(entry))
        return tuple(out)

    def local_index(self, shape, rank: Optional[int] = None) -> tuple:
        """The slices of a ``shape`` array that ``rank`` (default: this
        rank) holds, on a live mesh."""
        local = self.shard_shape(shape)
        index = []
        for d, size in enumerate(local):
            axes = _entry_axes(self.spec[d]) if d < len(self.spec) else ()
            i = shard_index(self.mesh, axes, rank) if axes else 0
            index.append(slice(i * size, (i + 1) * size))
        return tuple(index)

    def placements(self) -> tuple:
        """DTensor placements on the live mesh: ``Shard(d)`` on each mesh
        axis that splits dim d, ``Replicate()`` on the others. A dim split
        over several axes names them in the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for m in dims:
                out[m] = Shard(d)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract array: shape, torch dtype and sharding (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


def _shape(leaf) -> Tuple[int, ...]:
    """The shape of a tensor, a :class:`ShapeDtypeStruct` or a (shape,
    dtype) leaf."""
    if isinstance(leaf, tuple):
        return tuple(leaf[0])
    return tuple(leaf.shape)


def _dtype(leaf):
    return leaf[1] if isinstance(leaf, tuple) else leaf.dtype


def _path_str(path) -> str:
    """A tree path as the rules read it: its entries joined by ``/`` (a dict
    key as itself, a NamedTuple field as ``.field``)."""
    return "/".join(str(k) for k in path)


def _guard(spec: Tuple, shape: Tuple[int, ...], mesh) -> tuple:
    """Replicate any dim whose extent doesn't divide the mesh axis size."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
        else:
            size = axis_size(mesh, *((ax,) if isinstance(ax, str) else ax))
            out.append(ax if dim % size == 0 else None)
    return P(*out)


def param_spec(path, leaf, mesh) -> tuple:
    ps = _path_str(path)
    shape = _shape(leaf)
    for pat, spec in _RULES:
        if re.search(pat, ps):
            # stacked layers have a leading repeats axis -> prepend None
            if len(shape) == len(spec) + 1:
                return _guard((None,) + tuple(spec), shape, mesh)
            if len(shape) == len(spec):
                return _guard(spec, shape, mesh)
            # rank mismatch (e.g. dense-vs-moe ffn rules): try the next rule
            continue
    return P()  # default: replicate


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over ``tree``'s leaves, the tree rebuilt."""
    out = iter([fn(path, leaf) for path, leaf in tr.flatten_with_path(tree)])
    return tr.tree_map(lambda _leaf: next(out), tree)


def shard_params(abstract_params, mesh):
    """Tree of :class:`NamedSharding` for a tree of parameters (tensors or
    (shape, dtype) leaves, as ``Model.param_shapes`` gives)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf, mesh)),
        abstract_params)


def shard_opt_state(abstract_opt, params_shardings, mesh):
    """m/v mirror the param shardings; step is replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=NamedSharding(mesh, P()), m=params_shardings,
                      v=tr.tree_map(lambda s: s, params_shardings))


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                seq_shard: bool = False) -> Dict[str, ShapeDtypeStruct]:
    """ShapeDtypeStructs (with shardings) for the input batch of a cell."""
    dp = dp_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    dpsz = axis_size(mesh, *dp)
    bspec = dp if B % dpsz == 0 and B >= dpsz else None
    pdt = getattr(torch, cfg.param_dtype)

    def sds(shp, dtype, spec):
        return ShapeDtypeStruct(tuple(shp), dtype, NamedSharding(mesh, spec))

    out: Dict[str, ShapeDtypeStruct] = {}
    if shape.kind in ("train", "prefill"):
        S_text = S - (cfg.vision_prefix_len if cfg.vision_prefix_len else 0)
        out["tokens"] = sds((B, S_text), torch.int32, P(bspec, None))
        if shape.kind == "train":
            out["labels"] = sds((B, S_text), torch.int32, P(bspec, None))
        if cfg.vision_prefix_len:
            out["vis_embeds"] = sds((B, cfg.vision_prefix_len, cfg.d_model),
                                    pdt, P(bspec, None, None))
        if cfg.is_encoder_decoder:
            out["frames"] = sds((B, cfg.encoder_seq_len, cfg.d_model), pdt,
                                P(bspec, None, None))
    else:  # decode
        out["tokens"] = sds((B, 1), torch.int32, P(bspec, None))
    return out


def cache_specs(model, cfg: ArchConfig, shape: ShapeSpec, mesh
                ) -> Tuple[Any, Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """(cache ShapeDtypeStruct tree with shardings, (cp_seq_axes,
    cp_batch_axes)).

    Decode KV caches always context-parallelize the sequence dim: over
    'model' when the batch covers the dp axes (decode_32k), and over
    dp+('model',) when it can't (long_500k: B=1). The attention runs
    through the partial-softmax path (``attention.make_cp_decode_attention``)
    with these axes.
    """
    dp = dp_axes(mesh)
    dpsz = axis_size(mesh, *dp)
    msz = mesh_shape(mesh).get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    batch_ok = B % dpsz == 0 and B >= dpsz
    if batch_ok:
        seq_axes = ("model",) if S % msz == 0 else ()
        batch_axes = dp
    else:
        seq_axes = tuple(dp) + (("model",) if S % (dpsz * msz) == 0 else ())
        batch_axes = ()
    abstract = model.cache_shapes(B, S, torch.bfloat16)

    bspec = batch_axes if batch_axes else None
    sspec = seq_axes if len(seq_axes) > 1 else (seq_axes[0] if seq_axes
                                                else None)

    def spec_for(path, leaf):
        ps = _path_str(path)
        shp = _shape(leaf)
        if re.search(r"/(k|v)$", ps):                # (R, B, S, KV, hd)
            spec = P(None, bspec, sspec, None, None)
        elif re.search(r"/(xk|xv)$", ps):            # (R, B, Senc, KV, hd)
            spec = P(None, bspec, None, None, None)
        # ssm/xlstm states: (R, B, ...) — shard batch when possible
        elif batch_ok and len(shp) >= 2 and shp[1] % dpsz == 0:
            spec = P(*((None, bspec) + (None,) * (len(shp) - 2)))
        else:
            spec = P()
        return ShapeDtypeStruct(shp, _dtype(leaf), NamedSharding(mesh, spec))

    return _map_with_path(spec_for, abstract), (seq_axes, batch_axes)


def abstract_with_shardings(abstract_tree, shardings):
    return tr.tree_map(
        lambda l, s: ShapeDtypeStruct(_shape(l), _dtype(l), s),
        abstract_tree, shardings)


def _sharding_on(sharding: NamedSharding, mesh) -> NamedSharding:
    """``sharding``'s spec laid onto ``mesh`` (a plan made on an
    ``AbstractMesh`` of the same shape applies to the live one)."""
    return sharding if sharding.mesh is mesh else NamedSharding(
        mesh, sharding.spec)


def _is_split(spec: tuple) -> bool:
    return any(entry is not None for entry in spec)


def local_params(params, shardings, mesh):
    """This rank's slices of whole ``params`` (a tree of tensors, as
    ``init_params`` or ``models.interop.params_from_jax`` give it) laid out
    by ``shardings`` (:func:`shard_params`' tree) on the live ``mesh``:
    each leaf's ``NamedSharding.local_index``, copied, so that the whole
    tensors can be freed. A leaf that :func:`_guard` replicated stays whole
    (the same tensor)."""
    def one(leaf, sharding):
        sh = _sharding_on(sharding, mesh)
        if not _is_split(sh.spec):
            return leaf
        return leaf[sh.local_index(tuple(leaf.shape))].clone(
            memory_format=torch.contiguous_format)
    return tr.tree_map(one, params, shardings)


def gather_params(local, shardings, mesh):
    """The inverse of :func:`local_params`: every rank gets the whole
    tensors back, each split dim gathered over its axes' group
    (``mesh.axes_group``: the ranks that differ from this one on those axes
    only, so that every part has this rank's slices of the other dims).
    For tests: a step never gathers a whole tree."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import axes_group, collective_device

    def gather(t, d, axes):
        group = axes_group(mesh, axes)
        src = t.movedim(d, 0).contiguous().to(collective_device(group))
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        by_shard = {shard_index(mesh, axes, r): part for r, part in
                    zip(dist.get_process_group_ranks(group), parts)}
        whole = torch.cat([by_shard[i] for i in range(len(parts))])
        return whole.to(t.device).movedim(0, d)

    def one(leaf, sharding):
        spec = _sharding_on(sharding, mesh).spec
        for d, entry in enumerate(spec):
            if entry is not None:
                leaf = gather(leaf, d, _entry_axes(entry))
        return leaf.contiguous()
    return tr.tree_map(one, local, shardings)


def gather_to_writer(t: torch.Tensor, sharding: NamedSharding, mesh):
    """The whole of the leaf whose shard this rank holds as ``t``, in
    ``t``'s dtype, on the mesh's first rank (``mesh.is_writer``); None on
    every other rank. Every rank sends its shard (raw bytes, so any dtype
    crosses) and the first places each at its ``local_index``, where the
    group's collectives put them (``mesh.collective_device``: the host for
    a ``gloo`` group, the card for an ``nccl`` one): one gather a split
    leaf, none for a whole one, which stays where it is. What a checkpoint
    of a sharded state writes (``checkpoint/ckpt.py``); :func:`gather_params`
    gives the whole tree to every rank instead."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (collective_device, is_writer,
                                         mesh_group)
    sh = _sharding_on(sharding, mesh)
    writer = is_writer(mesh)
    if not _is_split(sh.spec):
        return t if writer else None
    group = mesh_group(mesh)
    raw = t.contiguous().reshape(-1).view(torch.uint8).to(
        collective_device(group))
    ranks = dist.get_process_group_ranks(group)
    first = int(mesh.mesh.flatten()[0])
    parts = [torch.empty_like(raw) for _ in ranks] if writer else None
    dist.gather(raw, parts, dst=first, group=group)
    if not writer:
        return None
    shape = sh.global_shape(tuple(t.shape))
    whole = torch.empty(shape, dtype=t.dtype, device=raw.device)
    for r, part in zip(ranks, parts):
        whole[sh.local_index(shape, rank=r)] = part.view(t.dtype).reshape(
            t.shape)
    return whole


def shard_bytes(abstract_params, shardings) -> int:
    """Bytes of the shards one rank holds of ``abstract_params`` laid out by
    ``shardings``: the sum over the leaves of ``shard_shape``'s elements
    times the leaf's element size."""
    total = 0
    for leaf, sharding in zip(tr.leaves(abstract_params),
                              tr.leaves(shardings)):
        n = 1
        for d in sharding.shard_shape(_shape(leaf)):
            n *= d
        total += n * torch.empty((), dtype=_dtype(leaf)).element_size()
    return total
