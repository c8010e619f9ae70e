"""Attention: GQA with RoPE, qk-norm, sliding windows.

* ``ref_attention``     -- full-materialization version (small shapes,
  tests); the plain version of the flash-attention kernel.
* ``chunked_attention`` -- the online-softmax attention of training and
  prefill, through the ``flash_attention`` kernel.
* ``decode_attention``  -- single-query attention against a KV cache,
  through the ``flash_decode`` kernel.

Shapes: q (B, S, H, hd), k/v (B, Skv, KV, hd) with H % KV == 0 (GQA); query
head h reads KV head h // (H // KV). Context-parallel decode
(``decode_attention_partial``, ``merge_partial_attention``,
``make_cp_decode_attention`` in the JAX package) waits for the mesh and
sharding slice.
"""
from __future__ import annotations

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
