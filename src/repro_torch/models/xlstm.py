"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential).

The port of the JAX package's ``models/xlstm.py``, operation for operation.
The mLSTM recurrence ``C_t = f_t C_{t-1} + i_t v_t k_t^T`` with scalar
per-head gates is a linear attention with data-dependent decay, evaluated
with the chunked scheme of the SSD scan (``models/ssm.py``): an intra-chunk
(L, L) product and an inter-chunk state carry. The gates are sigmoids
(bounded), so the paper's exponential-gating stabiliser is left out, as in
the JAX package. sLSTM keeps its sequential semantics (its recurrent matrix
R makes it non-linearisable); decode is O(1) a token for both.

The JAX package scans with ``lax.scan`` under ``jax.checkpoint``; here a
Python loop runs over the chunks (mLSTM) and over the timesteps (sLSTM).
``jax.checkpoint`` only rematerialises for the backward pass, so it has no
counterpart in serving. The sLSTM timestep loop launches a few small
kernels a step from the host (12 layers x 2048 steps at a prefill of 2048
tokens); a persistent kernel is later performance work.

Dtypes follow the JAX code: projections in the parameter dtype; gates,
scans and states in float32; ``y`` cast to x's dtype before ``down_proj``
and ``out_proj``. The head dim of both mixers is ``d_model // n_heads``
(:func:`xlstm_dims`), not the config's ``hd``: at full width xlstm-350m's
mLSTM has 8 heads of 256 (E = 2048) and its sLSTM 4 heads of 256.

Decode steps write their state into the cache they are given, in place
(``copy_``): ``Model.decode_step`` passes views into the stacked cache
tensors, and ``launch/steps.py::GraphedDecodeStep`` replays a graph that
holds those tensors' addresses, so a state is never rebound in the dict.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, device_of, init_dense


class XlstmDims(NamedTuple):
    d_model: int
    n_heads: int
    head_dim: int
    proj_factor: float = 2.0


def xlstm_dims(d_model: int, n_heads: int) -> XlstmDims:
    return XlstmDims(d_model, n_heads, d_model // n_heads)


def config_dims(cfg) -> XlstmDims:
    """The xLSTM dims of an ``ArchConfig``: head dim d_model // n_heads."""
    return xlstm_dims(cfg.d_model, cfg.n_heads)


def _upper_mask(L: int, device) -> torch.Tensor:
    """(L, L) float32: 0 on and below the diagonal, -inf above it; added to
    an exponent, it masks the future with no ``where`` on data (the JAX
    package's constant additive mask)."""
    return torch.full((L, L), -math.inf, device=device).triu(1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: Optional[torch.Generator], dims: XlstmDims,
               dtype) -> dict:
    D, hd = dims.d_model, dims.head_dim
    E = int(dims.proj_factor * D)
    return {
        "up_proj": init_dense(gen, D, 2 * E, dtype),         # x, z gate
        "wq": init_dense(gen, E, E, dtype),
        "wk": init_dense(gen, E, E, dtype),
        "wv": init_dense(gen, E, E, dtype),
        "w_if": init_dense(gen, E, 2 * (E // hd), dtype),    # i, f per head
        "out_norm": torch.ones((E,), dtype=dtype, device=device_of(gen)),
        "down_proj": init_dense(gen, E, D, dtype),
    }


def _mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int):
    """q/k/v (B,S,H,P); i/f gates (B,S,H) in (0,1), float32. Returns y
    (B,S,H,P) float32 and the final (C (B,H,P,P), n (B,H,P))."""
    B, S, H, P = q.shape
    L = min(chunk, S)
    nchunks = S // L
    assert nchunks * L == S
    scale = P ** -0.5
    mask = _upper_mask(L, q.device)[None, :, :, None]
    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nchunks):
        sl = slice(c * L, (c + 1) * L)
        qk_, kk, vk = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ik, fk = i_gate[:, sl], f_gate[:, sl]
        lf = torch.log(fk + 1e-9)                  # (B,L,H) <= 0
        cs = torch.cumsum(lf, dim=1)
        seg = cs[:, :, None, :] - cs[:, None, :, :]             # (B,L,L,H)
        decay = torch.exp(seg + mask)
        scores = torch.einsum("blhp,bshp->blsh", qk_, kk) * scale
        w = scores * decay * ik[:, None, :, :]                 # (B,L,L,H)
        y_diag = torch.einsum("blsh,bshp->blhp", w, vk)
        n_diag = torch.einsum("blsh,bshp->blhp", decay * ik[:, None, :, :],
                              kk)
        dec_t = torch.exp(cs)                                  # (B,L,H)
        y_off = torch.einsum("blhp,bhpr->blhr", qk_ * scale,
                             C) * dec_t[..., None]
        n_off = n[:, None] * dec_t[..., None]                  # (B,L,H,P)
        y = y_diag + y_off
        n_t = n_diag + n_off
        denom = torch.abs(torch.einsum("blhp,blhp->blh", qk_ * scale, n_t))
        ys.append(y / torch.clamp_min(denom, 1.0)[..., None])
        # carry update
        rem = torch.exp(cs[:, -1:, :] - cs) * ik               # (B,L,H)
        C = C * torch.exp(cs[:, -1])[..., None, None] + \
            torch.einsum("blhp,blhr->bhpr", kk * rem[..., None], vk)
        n = n * torch.exp(cs[:, -1])[..., None] + \
            torch.einsum("blhp,blh->bhp", kk, rem)
    return torch.cat(ys, dim=1), (C, n)


def mlstm_gates(gif: torch.Tensor) -> tuple:
    """(i, f) gates (..., H) in float32 from the ``w_if`` product (..., 2H)."""
    i_gate, f_gate = torch.chunk(torch.sigmoid(gif.float()), 2, dim=-1)
    return i_gate, f_gate


def _mlstm_project(params: dict, x: torch.Tensor, dims: XlstmDims):
    """(q, k, v (..., E), z (..., E), i and f gates (..., E // hd) in
    float32) of x (..., D)."""
    E = int(dims.proj_factor * dims.d_model)
    xz = dense(x, params["up_proj"])
    xr, z = xz[..., :E], xz[..., E:]
    q = dense(xr, params["wq"])
    k = dense(xr, params["wk"])
    v = dense(xr, params["wv"])
    i_gate, f_gate = mlstm_gates(dense(xr, params["w_if"]))
    return q, k, v, z, i_gate, f_gate


def mlstm_heads(q, k, v, i_gate, f_gate, head_dim: int,
                chunk: int) -> torch.Tensor:
    """The chunked recurrence of the heads q, k, v (B, S, Hl·hd) hold, with
    their gates (B, S, Hl): y (B, S, Hl·hd) float32."""
    B, S, C = q.shape
    shape = (B, S, C // head_dim, head_dim)
    y, _ = _mlstm_chunked(q.reshape(shape), k.reshape(shape),
                          v.reshape(shape), i_gate, f_gate, chunk)
    return y.reshape(B, S, C)


def mlstm_gate(y: torch.Tensor, out_norm: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """y (float32, (..., C)) times the out-norm scale and silu(z), channel
    by channel: ``down_proj``'s input before its cast."""
    y = y * out_norm.float()
    return y * F.silu(z.float())


def _mlstm_out(params: dict, y: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``down_proj`` of y (float32, (..., E)) times the out-norm scale and
    silu(z), cast to x's dtype first."""
    return dense(mlstm_gate(y, params["out_norm"], z).to(x.dtype),
                 params["down_proj"])


def mlstm_apply(params: dict, x: torch.Tensor, dims: XlstmDims,
                chunk: int = 128) -> torch.Tensor:
    """Over a whole sequence. The pieces (:func:`mlstm_gates`,
    :func:`mlstm_heads`, :func:`mlstm_gate`) are those the sharded step runs
    on a rank's heads and channels (``launch/partition.py::mlstm``)."""
    q, k, v, z, i_gate, f_gate = _mlstm_project(params, x, dims)
    y = mlstm_heads(q, k, v, i_gate, f_gate, dims.head_dim, chunk)
    return _mlstm_out(params, y, z, x)


def mlstm_cache_init(dims: XlstmDims, batch: int, device=None) -> dict:
    E = int(dims.proj_factor * dims.d_model)
    H = E // dims.head_dim
    P = dims.head_dim
    return {"C": torch.zeros((batch, H, P, P), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, P), dtype=torch.float32,
                             device=device)}


def mlstm_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      dims: XlstmDims):
    """x (B, 1, D) -> ((B, 1, D), cache): C and n written into ``cache`` in
    place."""
    B = x.shape[0]
    E = int(dims.proj_factor * dims.d_model)
    hd = dims.head_dim
    H = E // hd
    scale = hd ** -0.5
    q, k, v, z, i_g, f_g = _mlstm_project(params, x[:, 0], dims)
    q = q.reshape(B, H, hd).float() * scale
    k = k.reshape(B, H, hd).float()
    v = v.reshape(B, H, hd).float()
    C = cache["C"] * f_g[..., None, None] + \
        i_g[..., None, None] * torch.einsum("bhp,bhr->bhpr", k, v)
    n = cache["n"] * f_g[..., None] + i_g[..., None] * k
    y = torch.einsum("bhp,bhpr->bhr", q, C)
    denom = torch.abs(torch.einsum("bhp,bhp->bh", q, n))
    y = y / torch.clamp_min(denom, 1.0)[..., None]
    out = _mlstm_out(params, y.reshape(B, E), z, x)
    # in place: the cache's tensors are views a captured graph holds
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    return out[:, None], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: Optional[torch.Generator], dims: XlstmDims,
               dtype) -> dict:
    """4 gates (i, f, z, o): input weights and block-diagonal recurrent
    weights a head; the bias is float32 in every model, as in the JAX
    package."""
    D, H, hd = dims.d_model, dims.n_heads, dims.head_dim
    dev = device_of(gen)
    if gen is None:
        r_rec = torch.empty((H, hd, 4 * hd), dtype=dtype, device=dev)
    else:
        r_rec = (torch.randn((H, hd, 4 * hd), generator=gen,
                             dtype=torch.float32, device=dev)
                 / math.sqrt(hd)).to(dtype)
    return {
        "w_in": init_dense(gen, D, 4 * D, dtype),
        "r_rec": r_rec,
        "bias": torch.zeros((4 * D,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, D, D, dtype),
    }


def _slstm_cell(x_t, state: dict, r_rec: torch.Tensor, bias: torch.Tensor):
    """x_t: (B, Hl·4hd) pre-activations from the input of the Hl heads
    ``r_rec`` (Hl, hd, 4hd), float32 (a sequence casts it once for all its
    steps), and ``bias`` (Hl·4hd,) hold; state: dict of (B, Hl, hd)
    float32. Returns (new state, h)."""
    H, hd = r_rec.shape[0], r_rec.shape[1]
    B = x_t.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", state["h"].float(), r_rec)  # (B,H,4hd)
    pre = x_t.reshape(B, H, 4 * hd).float() + rec + bias.reshape(H, 4 * hd)
    i, f, zc, o = torch.chunk(pre, 4, dim=-1)                   # (B,H,hd)
    i = torch.exp(torch.clamp_max(i, 10.0))  # exponential input gate
    f = torch.sigmoid(f)
    zc = torch.tanh(zc)
    o = torch.sigmoid(o)
    c = f * state["c"] + i * zc
    n = f * state["n"] + i
    h = o * c / torch.clamp_min(torch.abs(n), 1.0)
    return {"h": h, "c": c, "n": n}, h


def slstm_scan(pre: torch.Tensor, r_rec: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The recurrence, one timestep at a time, of the Hl heads whose
    pre-activations ``pre`` (B, S, Hl·4hd), recurrent weights ``r_rec``
    (Hl, hd, 4hd) and ``bias`` (Hl·4hd,) are given: h (B, S, Hl·hd)
    float32."""
    B, S, _ = pre.shape
    H, hd = r_rec.shape[0], r_rec.shape[1]
    r_rec = r_rec.float()
    state = {k: torch.zeros((B, H, hd), dtype=torch.float32,
                            device=pre.device) for k in ("h", "c", "n")}
    hs = []
    for t in range(S):
        state, h = _slstm_cell(pre[:, t], state, r_rec, bias)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(B, S, H * hd)


def slstm_apply(params: dict, x: torch.Tensor, dims: XlstmDims,
                chunk: int = 256) -> torch.Tensor:
    """Over a whole sequence, one timestep at a time (:func:`slstm_scan`,
    which the sharded step runs on a rank's heads). ``chunk`` is the JAX
    package's remat chunk: S must be a multiple of min(chunk, S), as
    there."""
    S = x.shape[1]
    pre = dense(x, params["w_in"])                              # (B,S,4D)
    L = min(chunk, S)
    assert (S // L) * L == S
    h = slstm_scan(pre, params["r_rec"], params["bias"])
    return dense(h.to(x.dtype), params["out_proj"])


def slstm_cache_init(dims: XlstmDims, batch: int, device=None) -> dict:
    H, hd = dims.n_heads, dims.head_dim
    return {k: torch.zeros((batch, H, hd), dtype=torch.float32,
                           device=device) for k in ("h", "c", "n")}


def slstm_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      dims: XlstmDims):
    """x (B, 1, D) -> ((B, 1, D), cache): h, c and n written into ``cache``
    in place."""
    pre = dense(x[:, 0], params["w_in"])
    new_state, h = _slstm_cell(pre, cache, params["r_rec"].float(),
                               params["bias"])
    B = x.shape[0]
    out = dense(h.reshape(B, -1).to(x.dtype), params["out_proj"])
    # in place, once every new value is formed from the old ones
    for key in ("h", "c", "n"):
        cache[key].copy_(new_state[key])
    return out[:, None], cache
