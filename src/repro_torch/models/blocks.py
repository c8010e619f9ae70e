"""Layer blocks: init + apply for the (mixer, ffn) slot kinds the port runs.

A *slot* is one layer of the repeating pattern. Parameters of a slot are
stacked over the ``repeats`` axis, as in the JAX package; the model indexes
layer ``r`` out of the stack (a view, no copy). Every block is
residual-pre-norm; ``parallel_block`` (command-r) computes attention and FFN
from the same normed input. The RMSNorm before every mixer and FFN goes
through the port's kernel.

Mixers: ``attn``, ``xattn`` (self-attention, then cross-attention over the
encoder's output: Whisper's decoder), ``mamba`` (``models/ssm.py``),
``mlstm`` and ``slstm`` (``models/xlstm.py``); ffn ``dense``, ``moe`` and
``none``. With ``learned_pos`` no attention applies RoPE. Context-parallel
decode (``cp_axes`` and ``mesh``) runs an attention layer's step on this
rank's shard of the KV cache (``attention.make_cp_decode_attention``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import partition as pt
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_rope, dense, device_of,
                                       init_dense, init_scale, rms_norm)
from repro_torch.models.mlp import mlp_apply, mlp_init


#: the mixers and FFNs of a slot
MIXERS = ("attn", "xattn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


def check_slot(mixer: str, ffn: str) -> None:
    """Raises ``ValueError`` on a mixer or FFN no config has (the JAX
    package's ``ValueError(mixer)``)."""
    if mixer not in MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}; the mixers are {MIXERS}")
    if ffn not in FFNS:
        raise ValueError(f"unknown ffn {ffn!r}; the FFNs are {FFNS}")


_mamba_dims, _xlstm_dims = ssm_mod.config_dims, xlstm_mod.config_dims


def _attn_init(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
               cross: bool = False) -> Dict:
    """One attention's projections; a cross-attention has no q/k norms."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": init_dense(gen, D, H * hd, dtype),
        "wk": init_dense(gen, D, KV * hd, dtype),
        "wv": init_dense(gen, D, KV * hd, dtype),
        "wo": init_dense(gen, H * hd, D, dtype),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = init_scale(hd, dtype, device_of(gen))
        p["k_norm"] = init_scale(hd, dtype, device_of(gen))
    return p


def slot_init(gen: Optional[torch.Generator], cfg: ArchConfig, mixer: str, ffn: str,
              dtype) -> Dict:
    """One layer's parameters, drawn from ``gen`` on its device (``None``:
    on the meta device, shapes only)."""
    check_slot(mixer, ffn)
    p: Dict = {"norm1": init_scale(cfg.d_model, dtype, device_of(gen))}
    if mixer in ("attn", "xattn"):
        p["attn"] = _attn_init(gen, cfg, dtype)
    if mixer == "xattn":
        p["xnorm"] = init_scale(cfg.d_model, dtype, device_of(gen))
        p["xattn"] = _attn_init(gen, cfg, dtype, cross=True)
    elif mixer == "mamba":
        p["mamba"] = ssm_mod.mamba_init(gen, _mamba_dims(cfg), dtype)
    elif mixer == "mlstm":
        p["mlstm"] = xlstm_mod.mlstm_init(gen, _xlstm_dims(cfg), dtype)
    elif mixer == "slstm":
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

def _qkv(p: Dict, cfg: ArchConfig, x, positions, part=None):
    """Projections, qk-norm and RoPE (none with ``learned_pos``) of one
    self-attention: q (B,S,H,hd), k and v (B,S,KV,hd). With a sharded
    step's ``part`` (``launch/partition.py``), ``x`` is the gathered
    sequence and the projections are column-parallel: q holds this rank's
    query heads and k, v the KV heads they read, whole heads
    (``partition.qkv``), normed and rotated at their global positions."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if part is not None:
        q, k, v = pt.qkv(part, x, p)
    else:
        q = dense(x, p["wq"]).reshape(B, S, H, hd)
        k = dense(x, p["wk"]).reshape(B, S, KV, hd)
        v = dense(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cfg.learned_pos:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention_apply(p: Dict, cfg: ArchConfig, x, positions, *,
                     causal: bool, kv_override=None, part=None):
    """x (B,S,D) -> (B,S,D). ``kv_override``: (k, v) of a cross-attention,
    projected already; q then has no norm and no RoPE. With a sharded
    step's ``part``: x the gathered sequence, the attention over this
    rank's heads, wo row-parallel (its partial sums reduced over 'model',
    into the step's layout)."""
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _qkv(p, cfg, x, positions, part)
    else:
        q = dense(x, p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
        k, v = kv_override
    o = attn_mod.chunked_attention(q, k, v, causal=causal,
                                   window=cfg.sliding_window)
    if part is not None:
        return pt.row(part, pt.out_columns(part, o), p["wo"], "attn/wo")
    return dense(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"])


def cross_kv(p: Dict, cfg: ArchConfig, enc_out):
    """A cross-attention's k and v (B, Senc, KV, hd) from the encoder's
    output (B, Senc, D)."""
    B, Senc, _ = enc_out.shape
    shape = (B, Senc, cfg.n_kv_heads, cfg.hd)
    return (dense(enc_out, p["wk"]).reshape(shape),
            dense(enc_out, p["wv"]).reshape(shape))


def slot_apply(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x, positions,
               *, causal: bool = True, enc_out=None,
               part=None) -> Tuple[torch.Tensor, object]:
    """One layer over a whole sequence; an ``xattn`` layer also attends
    (non-causal) over ``enc_out`` (B, Senc, D), the encoder's output.
    Returns (x, aux): the MoE auxiliary loss times ``router_aux_coef``, a
    float32 tensor of one element, or the Python float 0.0 for a layer
    without experts (the JAX package's ``jnp.float32(0.0)``, with no tensor
    made for it).

    ``part``: a sharded step's context (``launch/partition.py``; an
    ``attn``, ``mamba``, ``mlstm`` or ``slstm`` mixer and a ``dense``,
    ``moe`` or no FFN): ``x`` is this rank's activation in the step's
    layout, each norm runs on it, the normed input is gathered over the
    sequence before the mixer and before a dense FFN (``part.gather_seq``;
    a MoE FFN takes its groups' tokens, ``partition.moe``), a recurrent
    mixer runs its pattern on this rank's channels and heads
    (``partition.MIXER_PATTERNS``), and the row-parallel products, the
    gathers of sLSTM's output and the MoE's reductions bring the outputs
    back into the step's layout."""
    check_slot(mixer, ffn)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if part is not None:
        h = part.gather_seq(h)
    if mixer in ("attn", "xattn"):
        mix_out = _attention_apply(p["attn"], cfg, h, positions,
                                   causal=causal, part=part)
    elif part is not None:
        mix_out = pt.MIXER_PATTERNS[mixer](part, h, p[mixer])
    elif mixer == "mamba":
        mix_out = ssm_mod.mamba_apply(p["mamba"], h, _mamba_dims(cfg),
                                      cfg.ssm_chunk)
    elif mixer == "mlstm":
        mix_out = xlstm_mod.mlstm_apply(p["mlstm"], h, _xlstm_dims(cfg),
                                        cfg.ssm_chunk)
    else:
        mix_out = xlstm_mod.slstm_apply(p["slstm"], h, _xlstm_dims(cfg),
                                        max(cfg.ssm_chunk, 16))

    def cross(x):
        hx = rms_norm(x, p["xnorm"], cfg.norm_eps)
        return x + _attention_apply(p["xattn"], cfg, hx, positions,
                                    causal=False,
                                    kv_override=cross_kv(p["xattn"], cfg,
                                                         enc_out))
    ffn_fn = _ffn_apply if part is None else functools.partial(
        _ffn_apply, part=part)
    return _residual(p, cfg, ffn, x, mix_out, h, ffn_fn,
                     cross if mixer == "xattn" else None)


def _residual(p: Dict, cfg: ArchConfig, ffn: str, x, mix_out, h, ffn_fn,
              cross=None):
    """(the layer's output, the FFN's aux) from its input ``x``, the mixer's
    output and the normed input ``h``: ``x + mix_out + ffn(h)`` in a
    parallel block (command-r, one norm), else ``x + mix_out``, then the
    cross-attention's ``cross(x)`` of an ``xattn`` layer, then its normed
    FFN added, in the JAX package's order of the adds.
    ``ffn_fn(p, cfg, kind, h)`` gives (the FFN's output, its aux)."""
    if cfg.parallel_block and ffn != "none":
        f_out, aux = ffn_fn(p, cfg, ffn, h)
        return x + mix_out + f_out, aux
    x = x + mix_out
    if cross is not None:
        x = cross(x)
    if ffn == "none":
        return x, 0.0
    f_out, aux = ffn_fn(p, cfg, ffn, rms_norm(x, p["norm2"], cfg.norm_eps))
    return x + f_out, aux


def _moe_kw(cfg: ArchConfig) -> Dict:
    return dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_tok,
                capacity_factor=cfg.capacity_factor,
                ws_rebalance=cfg.ws_rebalance, n_groups=cfg.moe_groups)


def _ffn_apply(p: Dict, cfg: ArchConfig, kind: str, h, part=None):
    """(the FFN's output, its aux: a MoE layer's loss times
    ``router_aux_coef``, 0.0 for a dense one). With a sharded step's
    ``part`` the dense FFN runs column- then row-parallel on the whole
    sequence: the normed input is gathered first, but in a parallel block,
    whose input the mixer's gather already holds. A MoE FFN runs on this
    rank's dispatch groups (``partition.moe``), its aux the mean over all
    of them."""
    if kind == "moe":
        if part is not None:
            y, aux, _stats = pt.moe(part, h, p["ffn"],
                                    gathered=cfg.parallel_block)
        else:
            y, aux, _stats = moe_mod.moe_apply(p["ffn"], h, **_moe_kw(cfg))
        return y, aux * cfg.router_aux_coef
    if part is not None and not cfg.parallel_block:
        h = part.gather_seq(h)
    return mlp_apply(p["ffn"], h, cfg.act, part), 0.0


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
    for ``attn``, and for ``xattn`` also xk and xv (B, encoder_seq_len, KV,
    hd), the cross-attention's keys and values; the recurrent state of the
    other mixers (float32, but Mamba's conv window, of ``dtype``), as in the
    JAX package."""
    check_slot(mixer, "none")
    if mixer == "mamba":
        return ssm_mod.mamba_cache_init(_mamba_dims(cfg), batch, dtype,
                                        device)
    if mixer == "mlstm":
        return xlstm_mod.mlstm_cache_init(_xlstm_dims(cfg), batch, device)
    if mixer == "slstm":
        return xlstm_mod.slstm_cache_init(_xlstm_dims(cfg), batch, device)
    rows = {"k": max_seq, "v": max_seq}
    if mixer == "xattn":
        rows.update(xk=cfg.encoder_seq_len, xv=cfg.encoder_seq_len)
    return {name: torch.zeros((batch, n, cfg.n_kv_heads, cfg.hd),
                              dtype=dtype, device=device)
            for name, n in rows.items()}


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
                cache: Dict, pos, cp_axes=None, *, kv_len=None,
                mesh=None) -> Tuple[torch.Tensor, Dict, object]:
    """x (B,1,D); pos the 0-based index of this token, as
    :func:`decode_position` takes it. ``Model.decode_step`` forms (pos,
    kv_len) once a step with :func:`decode_position` and passes both;
    without ``kv_len``, ``pos`` is given to it here.

    An ``attn`` layer writes the token's k and v into ``cache`` in place
    (cast to the cache's dtype) and attends over the cache's first ``pos +
    1`` positions; an ``xattn`` layer then also attends over all
    ``encoder_seq_len`` rows of its cross cache xk/xv; a recurrent layer
    writes its new state into ``cache`` in place. Returns (x, cache, aux),
    aux as :func:`slot_apply` gives it (a MoE layer routes the batch's B
    tokens as one group of its own).

    ``cp_axes`` = (seq_axes, batch_axes) with a live ``mesh``: the cache's k
    and v are this rank's shard of a KV cache split over ``seq_axes`` (and
    its batch over ``batch_axes``), and the attention is context-parallel
    (:func:`cp_attention`).
    """
    return _decode(p, cfg, mixer, ffn, x, cache, pos,
                   cp_attention(cp_axes, mesh), kv_len, _ffn_apply)


def cp_attention(cp_axes, mesh):
    """The context-parallel attention of ``cp_axes`` = (seq_axes,
    batch_axes) on ``mesh`` (``attention.make_cp_decode_attention``), or
    None without ``cp_axes``. ``Model.decode_step`` makes it once a step
    and hands it to every layer."""
    if not cp_axes:
        return None
    seq_axes, batch_axes = cp_axes
    return attn_mod.make_cp_decode_attention(tuple(seq_axes),
                                             tuple(batch_axes), mesh)


def slot_decode_output(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x,
                       cache: Dict, pos, *, kv_len=None,
                       cp_attn=None) -> Tuple[torch.Tensor, Dict]:
    """:func:`slot_decode`'s (x, cache), with no aux computed: what
    ``Model.decode_step`` runs, since it drops the aux (the JAX package's
    compiled step never runs that work; eager PyTorch would launch it).
    ``cp_attn``: the step's :func:`cp_attention`, or None."""
    x, cache, _ = _decode(p, cfg, mixer, ffn, x, cache, pos, cp_attn, kv_len,
                          _ffn_output)
    return x, cache


def _decode(p: Dict, cfg: ArchConfig, mixer: str, ffn: str, x, cache: Dict,
            pos, cp_attn, kv_len, ffn_fn):
    check_slot(mixer, ffn)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    B = x.shape[0]
    if mixer in ("attn", "xattn"):
        if kv_len is None:
            pos, kv_len = decode_position(pos, x.device)
        q, k, v = _qkv(p["attn"], cfg, h, pos.expand(B, 1))
        if cp_attn is not None:
            o, _, _ = cp_attn(q, cache["k"], cache["v"], k, v, pos, kv_len,
                              window=cfg.sliding_window)
        else:
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

    def cross(x):
        hx = rms_norm(x, p["xnorm"], cfg.norm_eps)
        q = dense(hx, p["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
        o = attn_mod.decode_attention(q, cache["xk"], cache["xv"],
                                      cfg.encoder_seq_len)
        return x + dense(o.reshape(B, 1, cfg.n_heads * cfg.hd),
                         p["xattn"]["wo"])
    x, aux = _residual(p, cfg, ffn, x, mix_out, h, ffn_fn,
                       cross if mixer == "xattn" else None)
    return x, cache, aux
