"""Selective SSM (Mamba) block in chunked SSD form.

The port of the JAX package's ``models/ssm.py``, operation for operation.
Jamba's Mamba layers are evaluated in the SSD / Mamba-2 formulation, as
there: a scalar decay a head, a chunked computation whose intra-chunk part
is an attention-like batched product and whose inter-chunk part carries the
chunk states in a loop (``lax.scan`` there, a Python loop over the chunks
here), and an O(1) decode step.

Shapes: d_inner = expand * d_model; heads Hm = d_inner / head_p;
x/v: (B, S, Hm, P), B/C projections: (B, S, N) shared across heads (G=1),
dt: (B, S, Hm), A: (Hm,) negative scalars. State: (B, Hm, P, N).

Dtypes follow the JAX code: projections in the parameter dtype; the scan,
dt, B, C and the state in float32; ``A_log``, ``D`` and ``dt_bias`` are
float32 leaves in every model; ``y`` is cast to x's dtype before
``out_proj``. The causal convolution accumulates in float32 over its taps
in order, then casts (not a bf16 ``F.conv1d``). softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus``, not ``F.softplus`` (which
returns x itself above a threshold of 20).

:func:`mamba_decode_step` writes the state ``h`` and the conv window into
the cache it is given, in place: ``Model.decode_step`` passes views into the
stacked cache tensors, which ``launch/steps.py::GraphedDecodeStep``'s graph
holds by address.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, device_of, init_dense


class MambaDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int        # Hm
    head_p: int         # P = d_inner / Hm
    d_state: int        # N
    d_conv: int         # K


def mamba_dims(d_model: int, expand: int = 2, head_p: int = 64,
               d_state: int = 16, d_conv: int = 4) -> MambaDims:
    d_inner = expand * d_model
    return MambaDims(d_model, d_inner, d_inner // head_p, head_p, d_state,
                     d_conv)


def config_dims(cfg) -> MambaDims:
    """The Mamba dims of an ``ArchConfig``."""
    return mamba_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_p,
                      cfg.ssm_state, cfg.ssm_conv)


def mamba_init(gen: Optional[torch.Generator], dims: MambaDims,
               dtype) -> dict:
    E, N, Hm, K = dims.d_inner, dims.d_state, dims.n_heads, dims.d_conv
    dev = device_of(gen)
    if gen is None:
        conv_w = torch.empty((K, E), dtype=dtype, device=dev)
    else:
        conv_w = (torch.randn((K, E), generator=gen, dtype=torch.float32,
                              device=dev) * (1.0 / math.sqrt(K))).to(dtype)
    return {
        "in_proj": init_dense(gen, dims.d_model, 2 * E, dtype),   # x, z
        "conv_w": conv_w,
        "bc_proj": init_dense(gen, E, 2 * N, dtype),              # B, C
        "dt_proj": init_dense(gen, E, Hm, dtype),
        "dt_bias": torch.zeros((Hm,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, Hm,
                                          dtype=torch.float32, device=dev)),
        "D": torch.ones((Hm,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, E, dims.d_model, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,E), w (K,E). Accumulated in float32
    over k in order, then cast to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * w[k].float()
    return out.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int):
    """Chunked SSD scan.

    xh (B,S,Hm,P), Bm/Cm (B,S,N), dt (B,S,Hm) >= 0, A (Hm,) < 0.
    Returns y (B,S,Hm,P) f32 and final state (B,Hm,P,N) f32.
    """
    Bsz, S, Hm, P = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nchunks = S // L
    assert nchunks * L == S, f"S={S} not divisible by chunk={L}"
    # the constant additive mask on the exponent: no where() on data
    mask = torch.full((L, L), -math.inf, device=xh.device).triu(1)
    mask = mask[None, :, :, None]
    h = torch.zeros((Bsz, Hm, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nchunks):
        sl = slice(c * L, (c + 1) * L)
        xk, bk, ck, dk = (xh[:, sl].float(), Bm[:, sl].float(),
                          Cm[:, sl].float(), dt[:, sl])
        la = dk * A                                          # (B,L,Hm) <= 0
        cs = torch.cumsum(la, dim=1)                         # (B,L,Hm)
        # intra-chunk: y[t] += sum_{s<=t} exp(cs_t - cs_s) (C_t.B_s) dt_s x_s
        seg = cs[:, :, None, :] - cs[:, None, :, :]          # (B,L,L,Hm)
        decay = torch.exp(seg + mask)
        scores = torch.einsum("btn,bsn->bts", ck, bk)        # (B,L,L)
        w = decay * scores[..., None] * dk[:, None, :, :]    # (B,L,L,Hm)
        y_diag = torch.einsum("btsh,bshp->bthp", w, xk)
        # inter-chunk: y[t] += (C_t . h) * exp(cs_t)
        y_off = torch.einsum("btn,bhpn->bthp", ck, h) * \
            torch.exp(cs)[..., None]
        # state: h' = exp(cs_last) h + sum_s exp(cs_last - cs_s) dt_s x_s B_s
        rem = torch.exp(cs[:, -1:, :] - cs)                  # (B,L,Hm)
        contrib = torch.einsum("blhp,bln->bhpn",
                               xk * (dk * rem)[..., None], bk)
        h = h * torch.exp(cs[:, -1, :])[..., None, None] + contrib
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), h


def conv_silu(xr: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """silu of the causal conv of ``xr`` (B, S, C) over ``conv_w`` (K, C),
    in ``xr``'s dtype: depthwise, so any C channels with their taps."""
    return F.silu(_causal_conv(xr, conv_w).float()).to(xr.dtype)


def scan_inputs(bc: torch.Tensor, dt_raw: torch.Tensor,
                dt_bias: torch.Tensor) -> tuple:
    """(B, C (B, S, N) and dt (B, S, Hm), float32) from the products of the
    conv's output with ``bc_proj`` and ``dt_proj``."""
    Bm, Cm = torch.chunk(bc.float(), 2, dim=-1)
    return Bm, Cm, _softplus(dt_raw.float() + dt_bias)


def ssd_heads(xr: torch.Tensor, Bm, Cm, dt, A_log, D, head_p: int,
              chunk: int) -> torch.Tensor:
    """The scan of the heads ``xr`` (B, S, Hl·P) holds, with their dt
    (B, S, Hl), ``A_log`` and ``D`` (Hl,) and the B, C every head shares,
    plus the D skip: y (B, S, Hl·P) float32."""
    B, S, C = xr.shape
    xh = xr.reshape(B, S, C // head_p, head_p)
    A = -torch.exp(A_log)                                      # (Hl,) < 0
    y, _ = _ssd_chunked(xh, Bm, Cm, dt, A, chunk)
    y = y + xh.float() * D[None, None, :, None]
    return y.reshape(B, S, C)


def gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y (float32) times silu(z), channel by channel."""
    return y * F.silu(z.float())


def mamba_apply(params: dict, x: torch.Tensor, dims: MambaDims,
                chunk: int = 128) -> torch.Tensor:
    """Full-sequence (prefill) forward. x: (B, S, D). The pieces
    (:func:`conv_silu`, :func:`scan_inputs`, :func:`ssd_heads`,
    :func:`gate`) are those the sharded step runs on a rank's channels
    and heads (``launch/partition.py::mamba``)."""
    E = dims.d_inner
    xz = dense(x, params["in_proj"])
    xr, z = xz[..., :E], xz[..., E:]                           # (B,S,E)
    xr = conv_silu(xr, params["conv_w"])
    Bm, Cm, dt = scan_inputs(dense(xr, params["bc_proj"]),
                             dense(xr, params["dt_proj"]), params["dt_bias"])
    y = ssd_heads(xr, Bm, Cm, dt, params["A_log"], params["D"],
                  dims.head_p, chunk)
    return dense(gate(y, z).to(x.dtype), params["out_proj"])


def mamba_cache_init(dims: MambaDims, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "h": torch.zeros((batch, dims.n_heads, dims.head_p, dims.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dims.d_conv - 1, dims.d_inner),
                            dtype=dtype, device=device),
    }


def mamba_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      dims: MambaDims) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D) -> (B, 1, D); O(1) state update,
    written into ``cache`` in place."""
    B = x.shape[0]
    E, Hm, P = dims.d_inner, dims.n_heads, dims.head_p
    xz = dense(x[:, 0], params["in_proj"])
    xr, z = xz[..., :E], xz[..., E:]                           # (B,E)
    # the window is formed in the promoted dtype, as jnp.concatenate does
    # (a float32 x beside a bf16 cache); the JAX package returns it as the
    # new cache, the port writes it back into the cache's own dtype
    conv = cache["conv"]
    wdt = torch.promote_types(conv.dtype, xr.dtype)
    window = torch.cat([conv.to(wdt), xr[:, None].to(wdt)], dim=1)  # (B,K,E)
    conv_out = torch.einsum("bke,ke->be", window.float(),
                            params["conv_w"].float())
    xr = F.silu(conv_out).to(x.dtype)
    bc = dense(xr, params["bc_proj"]).float()
    Bm, Cm = torch.chunk(bc, 2, dim=-1)                        # (B,N)
    dt = _softplus(dense(xr, params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xr.reshape(B, Hm, P).float()
    decay = torch.exp(dt * A)                                  # (B,Hm)
    h = cache["h"] * decay[..., None, None] + \
        torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(B, E) * F.silu(z.float())
    out = dense(y.to(x.dtype), params["out_proj"])
    # in place: the new window is a tensor of its own, so its shift by one
    # (window[:, 1:]) never reads what the copy has overwritten
    cache["h"].copy_(h)
    conv.copy_(window[:, 1:])
    return out[:, None], cache
