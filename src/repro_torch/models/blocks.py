"""Layer blocks: init + apply for the (mixer, ffn) slot kinds the port runs.

A *slot* is one layer of the repeating pattern. Parameters of a slot are
stacked over the ``repeats`` axis, as in the JAX package; the model indexes
layer ``r`` out of the stack (a view, no copy). Every block is
residual-pre-norm; ``parallel_block`` (command-r) computes attention and FFN
from the same normed input. The RMSNorm before every mixer and FFN goes
through the port's kernel.

Mixers: ``attn``, ``mamba`` (``models/ssm.py``), ``mlstm`` and ``slstm``
(``models/xlstm.py``); ffn ``dense``, ``moe`` and ``none``. Mixer ``xattn``
(the encoder-decoder's cross-attention, ROADMAP Queue A 8.5) and
context-parallel decode (``cp_axes``, Queue A 10) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_rope, dense, device_of,
                                       init_dense, init_scale, rms_norm)
from repro_torch.models.mlp import mlp_apply, mlp_init


#: the mixers the port runs
MIXERS = ("attn", "mamba", "mlstm", "slstm")
#: what a mixer or feature that is not ported yet waits for
WAITS_FOR = {"xattn": "ROADMAP Queue A 8.5 (Whisper: the xattn mixer and "
                      "the encoder)",
             "cp_axes": "ROADMAP Queue A 10 (mesh and sharding)"}


def not_ported(what: str, item: str = "ROADMAP Queue A 8") -> \
        NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with a later slice of the "
        f"language-model substrate ({item})")


def check_slot(mixer: str, ffn: str) -> None:
    if mixer not in MIXERS:
        raise not_ported(f"mixer {mixer!r}",
                         WAITS_FOR.get(mixer, "ROADMAP Queue A 8"))
    if ffn not in ("dense", "moe", "none"):
        raise not_ported(f"ffn {ffn!r}")


def _mamba_dims(cfg: ArchConfig) -> ssm_mod.MambaDims:
    return ssm_mod.mamba_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_p,
                              cfg.ssm_state, cfg.ssm_conv)


def _xlstm_dims(cfg: ArchConfig) -> xlstm_mod.XlstmDims:
    return xlstm_mod.xlstm_dims(cfg.d_model, cfg.n_heads)


def _attn_init(gen: Optional[torch.Generator], cfg: ArchConfig, dtype) -> Dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": init_dense(gen, D, H * hd, dtype),
        "wk": init_dense(gen, D, KV * hd, dtype),
        "wv": init_dense(gen, D, KV * hd, dtype),
        "wo": init_dense(gen, H * hd, D, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_scale(hd, dtype, device_of(gen))
        p["k_norm"] = init_scale(hd, dtype, device_of(gen))
    return p


def slot_init(gen: Optional[torch.Generator], cfg: ArchConfig, mixer: str, ffn: str,
              dtype) -> Dict:
    """One layer's parameters, drawn from ``gen`` on its device (``None``:
    on the meta device, shapes only)."""
    check_slot(mixer, ffn)
    p: Dict = {"norm1": init_scale(cfg.d_model, dtype, device_of(gen))}
    if mixer == "attn":
        p["attn"] = _attn_init(gen, cfg, dtype)
    elif mixer == "mamba":
        p["mamba"] = ssm_mod.mamba_init(gen, _mamba_dims(cfg), dtype)
    elif mixer == "mlstm":
        p["mlstm"] = xlstm_mod.mlstm_init(gen, _xlstm_dims(cfg), dtype)
    else:
        p["slstm"] = xlstm_mod.slstm_init(gen, _xlstm_dims(cfg), dtype)
    if ffn != "none":
        p["norm2"] = init_scale(cfg.d_model, dtype, device_of(gen))
        p["ffn"] = _ffn_init(gen, cfg, ffn, dtype)
    return p


def _ffn_init(gen: Optional[torch.Generator], cfg: ArchConfig, kind: str,
              dtype) -> Dict:
    if kind == "dense":
        return mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.act)
    return moe_mod.moe_init(gen, cfg.d_model, cfg.expert_d_ff,
                            cfg.n_experts, dtype)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _qkv(p: Dict, cfg: ArchConfig, x, positions):
    """Projections, qk-norm and RoPE of one attention layer: q (B,S,H,hd),
    k and v (B,S,KV,hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, p["wq"]).reshape(B, S, H, hd)
    k = dense(x, p["wk"]).reshape(B, S, KV, hd)
    v = dense(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention_apply(p: Dict, cfg: ArchConfig, x, positions, *,
                     causal: bool):
    """x (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = attn_mod.chunked_attention(q, k, v, causal=causal,
                                   window=cfg.sliding_window)
    return dense(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])


def slot_apply(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x, positions,
               *, causal: bool = True) -> Tuple[torch.Tensor, object]:
    """One layer over a whole sequence. Returns (x, aux): the MoE auxiliary
    loss times ``router_aux_coef``, a float32 tensor of one element, or the
    Python float 0.0 for a layer without experts (the JAX package's
    ``jnp.float32(0.0)``, with no tensor made for it)."""
    check_slot(mixer, ffn)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "attn":
        mix_out = _attention_apply(p["attn"], cfg, h, positions,
                                   causal=causal)
    elif mixer == "mamba":
        mix_out = ssm_mod.mamba_apply(p["mamba"], h, _mamba_dims(cfg),
                                      cfg.ssm_chunk)
    elif mixer == "mlstm":
        mix_out = xlstm_mod.mlstm_apply(p["mlstm"], h, _xlstm_dims(cfg),
                                        cfg.ssm_chunk)
    else:
        mix_out = xlstm_mod.slstm_apply(p["slstm"], h, _xlstm_dims(cfg),
                                        max(cfg.ssm_chunk, 16))
    return _residual(p, cfg, ffn, x, mix_out, h, _ffn_apply)


def _residual(p: Dict, cfg: ArchConfig, ffn: str, x, mix_out, h, ffn_fn):
    """(the layer's output, the FFN's aux) from its input ``x``, the mixer's
    output and the normed input ``h``: ``x + mix_out + ffn(h)`` in a
    parallel block (command-r, one norm), else ``x + mix_out`` and its
    normed FFN added, in the JAX package's order of the adds.
    ``ffn_fn(p, cfg, kind, h)`` gives (the FFN's output, its aux)."""
    if ffn == "none":
        return x + mix_out, 0.0
    if cfg.parallel_block:
        f_out, aux = ffn_fn(p, cfg, ffn, h)
        return x + mix_out + f_out, aux
    x = x + mix_out
    f_out, aux = ffn_fn(p, cfg, ffn, rms_norm(x, p["norm2"], cfg.norm_eps))
    return x + f_out, aux


def _moe_kw(cfg: ArchConfig) -> Dict:
    return dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_tok,
                capacity_factor=cfg.capacity_factor,
                ws_rebalance=cfg.ws_rebalance, n_groups=cfg.moe_groups)


def _ffn_apply(p: Dict, cfg: ArchConfig, kind: str, h):
    """(the FFN's output, its aux: a MoE layer's loss times
    ``router_aux_coef``, 0.0 for a dense one)."""
    if kind == "dense":
        return mlp_apply(p["ffn"], h, cfg.act), 0.0
    y, aux, _stats = moe_mod.moe_apply(p["ffn"], h, **_moe_kw(cfg))
    return y, aux * cfg.router_aux_coef


def _ffn_output(p: Dict, cfg: ArchConfig, kind: str, h):
    """(the FFN's output, None): no aux is computed, a MoE layer runs
    ``moe_output``."""
    if kind == "dense":
        return mlp_apply(p["ffn"], h, cfg.act), None
    return moe_mod.moe_output(p["ffn"], h, **_moe_kw(cfg)), None


# ---------------------------------------------------------------------------
# decode-step apply (single token, stateful caches)
# ---------------------------------------------------------------------------

def slot_cache_init(cfg: ArchConfig, mixer: str, batch: int, max_seq: int,
                    dtype, device=None) -> Dict:
    """One layer's decode cache: k and v (B, max_seq, KV, hd) of ``dtype``
    for ``attn``; the recurrent state of the other mixers (float32, but
    Mamba's conv window, of ``dtype``), as in the JAX package."""
    check_slot(mixer, "none")
    if mixer == "mamba":
        return ssm_mod.mamba_cache_init(_mamba_dims(cfg), batch, dtype,
                                        device)
    if mixer == "mlstm":
        return xlstm_mod.mlstm_cache_init(_xlstm_dims(cfg), batch, device)
    if mixer == "slstm":
        return xlstm_mod.slstm_cache_init(_xlstm_dims(cfg), batch, device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_position(pos, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, kv_len) of a decode step on ``device``: ``pos`` as an int64
    tensor (1,) (the cache index and RoPE's position) and ``kv_len = pos +
    1`` as an int32 tensor (1,) (every ``flash_decode``'s). ``pos`` is a
    Python int or, as the JAX package's traced ``jnp.int32``, an int32
    tensor of one element on ``device``, read there only, so that a step can
    be captured in a CUDA graph and replayed at any position."""
    if isinstance(pos, int):
        pos = torch.full((1,), pos, dtype=torch.int32, device=device)
    elif pos.dtype != torch.int32 or pos.numel() != 1 \
            or pos.device.type != device.type:
        raise ValueError(f"decode_step: pos must be an int or an int32 "
                         f"tensor of one element on {device}, got "
                         f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")
    pos = pos.reshape(1)
    return pos.long(), pos + 1


def slot_decode(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x,
                cache: Dict, pos, cp_axes=None, *,
                kv_len=None) -> Tuple[torch.Tensor, Dict, object]:
    """x (B,1,D); pos the 0-based index of this token, as
    :func:`decode_position` takes it. ``Model.decode_step`` forms (pos,
    kv_len) once a step with :func:`decode_position` and passes both;
    without ``kv_len``, ``pos`` is given to it here.

    An ``attn`` layer writes the token's k and v into ``cache`` in place
    (cast to the cache's dtype) and attends over the cache's first ``pos +
    1`` positions; a recurrent layer writes its new state into ``cache`` in
    place. Returns (x, cache, aux), aux as :func:`slot_apply` gives it (a
    MoE layer routes the batch's B tokens as one group of its own).
    """
    return _decode(p, cfg, mixer, ffn, x, cache, pos, cp_axes, kv_len,
                   _ffn_apply)


def slot_decode_output(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x,
                       cache: Dict, pos, *,
                       kv_len=None) -> Tuple[torch.Tensor, Dict]:
    """:func:`slot_decode`'s (x, cache), with no aux computed: what
    ``Model.decode_step`` runs, since it drops the aux (the JAX package's
    compiled step never runs that work; eager PyTorch would launch it)."""
    x, cache, _ = _decode(p, cfg, mixer, ffn, x, cache, pos, None, kv_len,
                          _ffn_output)
    return x, cache


def _decode(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x, cache: Dict,
            pos, cp_axes, kv_len, ffn_fn):
    check_slot(mixer, ffn)
    if cp_axes:
        raise not_ported("context-parallel decode (cp_axes)",
                         WAITS_FOR["cp_axes"])
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "attn":
        B = x.shape[0]
        if kv_len is None:
            pos, kv_len = decode_position(pos, x.device)
        q, k, v = _qkv(p["attn"], cfg, h, pos.expand(B, 1))
        for name, new in (("k", k), ("v", v)):
            cache[name].index_copy_(1, pos, new.to(cache[name].dtype))
        o = attn_mod.decode_attention(q, cache["k"], cache["v"], kv_len,
                                      window=cfg.sliding_window)
        mix_out = dense(o.reshape(B, 1, cfg.n_heads * cfg.hd),
                        p["attn"]["wo"])
    elif mixer == "mamba":
        mix_out, cache = ssm_mod.mamba_decode_step(p["mamba"], h, cache,
                                                   _mamba_dims(cfg))
    elif mixer == "mlstm":
        mix_out, cache = xlstm_mod.mlstm_decode_step(p["mlstm"], h, cache,
                                                     _xlstm_dims(cfg))
    else:
        mix_out, cache = xlstm_mod.slstm_decode_step(p["slstm"], h, cache,
                                                     _xlstm_dims(cfg))
    x, aux = _residual(p, cfg, ffn, x, mix_out, h, ffn_fn)
    return x, cache, aux
