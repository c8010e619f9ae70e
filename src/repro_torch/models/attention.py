"""Attention: GQA with RoPE, qk-norm, sliding windows.

* ``ref_attention``     -- full-materialization version (small shapes,
  tests); the plain version of the flash-attention kernel.
* ``chunked_attention`` -- the online-softmax attention of training and
  prefill, through the ``flash_attention`` kernel.
* ``decode_attention``  -- single-query attention against a KV cache,
  through the ``flash_decode`` kernel.

Shapes: q (B, S, H, hd), k/v (B, Skv, KV, hd) with H % KV == 0 (GQA); query
head h reads KV head h // (H // KV).

Context-parallel decode (:func:`make_cp_decode_attention`): each rank holds
a shard of the KV cache's sequence, computes the online softmax's partials
over it (:func:`decode_attention_partial`, plain products as the JAX
package's ``jnp.einsum``; that package has no kernel for it either) and the
ranks merge them with collectives (:func:`merge_partial_attention`).

The partials and the merge run in float64 (PARTIAL_DTYPE), where the JAX
package's run in float32. Float32 sums of different splits differ in their
last bits, and a bf16 model rounds such a difference into another
activation now and then; with random weights, greedy decoding then picks
another token at a near-tie. In float64 the merged output of any split
rounds to the same bf16 (and float32) value as one shard's, so a request's
tokens do not depend on how many ranks hold its cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_ref as ref_attention)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """Flash-style attention with an online softmax over kv tiles. The
    kernel keeps q's dtype for the result; unlike the JAX package's
    ``chunked_attention`` it scales q in float32 (as the Pallas kernel does)
    instead of rounding ``q * scale`` to bf16 first."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, kv_len, *, window: int = 0):
    """Single-step decode: q (B, 1, H, hd) against cache (B, Smax, KV, hd).

    ``kv_len`` = number of valid cache positions (the new token's k/v must
    already be written at kv_len-1): a Python int, or an int32 tensor of one
    element on q's device, read there only (as the JAX package's traced
    int32).
    """
    return ops.flash_decode(q, k_cache, v_cache, kv_len, window=window)


#: the masked score: finite, so that a shard with no position kept has
#: m = NEG_INF and its correction exp(m - m_glob) is 0, not NaN
NEG_INF = -1e30
#: the dtype of the partials and of their merge (module docstring)
PARTIAL_DTYPE = torch.float64


def decode_attention_partial(q, k_shard, v_shard, pos_start, kv_len, *,
                             window: int = 0, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """A shard's partials for context-parallel decode: q (B, 1, H, hd)
    against cache rows ``pos_start`` ... ``pos_start + Sloc - 1`` held in
    k_shard/v_shard (B, Sloc, KV, hd); positions at or past ``kv_len`` (an
    int or an int32 tensor of one element on q's device, read there only)
    and, with a ``window``, before ``kv_len - window`` are masked.

    Returns (o (B, H, hd) UNNORMALIZED, m (B, H), l (B, H)), all in
    PARTIAL_DTYPE: the weighted values, the row maximum and the sum of
    exp(s - m); shards are merged with :func:`merge_partial_attention`."""
    B, _, H, hd = q.shape
    Sloc, KV = k_shard.shape[1], k_shard.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qg = (q.to(PARTIAL_DTYPE)[:, 0] * scale).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_shard.to(PARTIAL_DTYPE))
    pos = pos_start + torch.arange(Sloc, device=q.device)
    keep = pos < kv_len
    if window > 0:
        keep = keep & (pos >= kv_len - window)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)                                          # (B,KV,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_shard.to(PARTIAL_DTYPE))
    return o.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def merge_partial_attention(o, m, l, group) -> torch.Tensor:
    """Online-softmax merge of the shards' partials across the ranks of
    ``group`` (a process group): the all-reduced maximum, then one
    all-reduced sum of the corrected l and o. Returns the attention output
    (B, H, hd) in the partials' dtype."""
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    hd = o.shape[-1]
    both = torch.cat([o * corr[..., None], (l * corr)[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    o_glob, l_glob = both[..., :hd], both[..., hd]
    return o_glob / torch.clamp(l_glob, min=1e-30)[..., None]


def make_cp_decode_attention(cp_axes: tuple, batch_axes: tuple = (),
                             mesh=None):
    """Context-parallel decode attention with the cache update.

    The KV cache's sequence axis is split over ``cp_axes`` of ``mesh`` (a
    DeviceMesh) and its batch axis over ``batch_axes``: each rank holds its
    shard (B_local, Sloc, KV, hd) and its batch rows of q, k_new and v_new
    (the ranks along ``cp_axes`` hold the same rows). The rank whose shard
    holds ``pos`` writes the new K/V row there, with a masked write on the
    device; every rank computes its partial online softmax over its
    positions, and the partials merge over the group of ``cp_axes`` (a
    flattened group for several axes).

    Used for decode_32k (cp = ('model',)) and long_500k (cp = dp +
    ('model',): B=1).

    Returns f(q, k_cache_shard, v_cache_shard, k_new, v_new, pos, kv_len,
    window=0) -> (out (B, 1, H, hd) in q's dtype, k_cache_shard,
    v_cache_shard), the shards written in place; ``pos`` an int64 tensor of
    one element and ``kv_len`` an int32 one, on q's device
    (``blocks.decode_position``), read there only, so that a step can be
    captured in a CUDA graph (with an NCCL mesh).
    """
    from repro_torch.launch import mesh as mesh_lib
    if not mesh_lib.is_live(mesh):
        raise ValueError("context-parallel decode needs a live mesh "
                         "(a DeviceMesh)")
    names = mesh_lib.axis_names(mesh)
    for a in tuple(cp_axes) + tuple(batch_axes):
        if a not in names:
            raise ValueError(f"axis {a!r} is not in the mesh's {names}")
    group = mesh_lib.axes_group(mesh, cp_axes)
    idx = mesh_lib.shard_index(mesh, cp_axes)

    def cp_decode(q, kc, vc, k_new, v_new, pos, kv_len, window: int = 0):
        Sloc = kc.shape[1]
        start = idx * Sloc
        local = torch.clamp(pos - start, 0, Sloc - 1)
        own = (pos >= start) & (pos < start + Sloc)
        for c, new in ((kc, k_new), (vc, v_new)):
            old = c.index_select(1, local)
            c.index_copy_(1, local, torch.where(own, new.to(c.dtype), old))
        o, m, l = decode_attention_partial(q, kc, vc, start, kv_len,
                                           window=window)
        out = merge_partial_attention(o, m, l, group)
        return out[:, None].to(q.dtype), kc, vc

    return cp_decode
