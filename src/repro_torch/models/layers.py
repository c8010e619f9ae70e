"""Basic layers: norms, projections, embeddings, rotary embeddings.

All layers are functions over explicit parameter dicts of tensors, as in the
JAX package. Parameters are stored in ``param_dtype`` (bf16 by default);
layer math upcasts to float32 where it matters (norms, softmax, rotary).
Dense weights are ``(d_in, d_out)`` and apply as ``x @ w``, so the JAX
package's weights carry across as they are.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, through the ``rms_norm`` kernel."""
    return ops.rms_norm(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (population variance), cast
    back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, cast back to x's dtype. cuBLAS
    accumulates bf16 products in float32; on the CPU the product of the
    float32 copies gives the same (every bf16 product is exact in float32)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def logits_f32(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x @ head in float32 from operands of any float type (the JAX
    package's ``preferred_element_type=float32``): a bf16 product would round
    the logits and make greedy ties that the reference does not have. On
    the card a bf16 product is written straight to float32 (cuBLAS, float32
    accumulation), with no float32 copy of the head, through
    :class:`_LogitsF32`; elsewhere the float32 copies are multiplied (every
    bf16 product is exact in float32)."""
    if x.dtype == head.dtype == torch.bfloat16 and x.is_cuda:
        out = _LogitsF32.apply(x.reshape(-1, x.shape[-1]), head)
        return out.reshape(*x.shape[:-1], head.shape[-1])
    return x.float() @ head.float()


class _LogitsF32(torch.autograd.Function):
    """bf16 (N, D) @ bf16 (D, V) -> float32 (N, V), with the gradient that
    ``torch.mm(..., out_dtype=)`` lacks: the forward is the product written
    straight to float32; the backward multiplies the float32 cotangent by
    the float32 copies of the operands, as the reference's transpose of a
    float32-preferring product does (and as the CPU path's autograd does),
    and rounds each gradient to bf16, its operand's type."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        gx = (g @ head.float().T).to(x2.dtype) \
            if ctx.needs_input_grad[0] else None
        gh = (x2.float().T @ g).to(head.dtype) \
            if ctx.needs_input_grad[1] else None
        return gx, gh


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Computed in
    float32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers: random weights from an explicit generator, on its device.
# ``gen=None`` gives tensors on the meta device: shapes, no allocation.
# ---------------------------------------------------------------------------

def device_of(gen: Optional[torch.Generator]) -> torch.device:
    return torch.device(gen.device) if gen is not None \
        else torch.device("meta")


def init_dense(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype, scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights times ``scale`` (default 1/sqrt(d_in)), drawn in
    float32 and cast to ``dtype``."""
    if gen is None:
        return torch.empty((d_in, d_out), dtype=dtype, device="meta")
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    if scale is None:
        return (w / math.sqrt(d_in)).to(dtype)
    return (w * scale).to(dtype)


def init_embed(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty((vocab, d), dtype=dtype, device="meta")
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def init_scale(d: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32; logits (B, S, V) of any
    float type, labels (B, S) integer ids; with ``mask`` the mean over the
    positions it keeps (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
