"""Flash attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu`` and its plain version.

It replaces ``flash_attention`` of the JAX package's
``kernels/flash_attention.py`` (the algorithm of
``models/attention.py::chunked_attention``): causal or sliding-window
grouped-query attention, q ``(B, Sq, H, hd)``, k and v ``(B, Skv, KV, hd)``,
query head ``h`` reading KV head ``h // (H // KV)``, masks ``kpos < Skv``,
``kpos <= qpos`` (causal) and ``kpos > qpos - window`` (window > 0), with
``qpos = q_offset + row``.

Two kernels, routed by the operands' dtype (never as a fallback):

- bfloat16 -> ``csrc/flash_attention_tc.cu`` (variant ``tc_bf16``): both
  products on the tensor cores (``wgmma``), copies by TMA, every head dim of
  ``HEAD_DIMS``; P is rounded to bf16 before P·V.
- float32 -> ``csrc/flash_attention.cu`` (variant ``simt_f32``): float32 FMAs
  on the CUDA cores, which the float32 tolerance (2e-5) needs.

The design of each, and what bounds it on this card, are written at the head
of its CUDA source. :func:`flash_attention` launches the kernel for tensors
on a CUDA device and raises if it cannot; only for tensors that lie on the
CPU does it run the plain version :func:`flash_attention_ref`. When autograd
records the call, the launch goes through ``_lm.KernelWithPlainBackward``,
whose backward is the plain version's gradient.
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_variant`` the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _lm

#: the kernel the main path runs (bf16 prefill)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_tc.cu"

#: variant -> its library under csrc/: bfloat16 operands take "tc_bf16",
#: float32 ones "simt_f32"
VARIANTS = {"tc_bf16": "flash_attention_tc", "simt_f32": "flash_attention"}

#: both launchers: q, k, v, out, B, Sq, Skv, H, KV, hd, q_offset, causal,
#: window, scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """The plain version: the whole (Sq, Skv) score matrix in float32, q
    scaled in float32 first as the kernel does, masked with -1e30, a
    softmax, the product with v; cast to q's dtype. As in the Pallas kernel,
    a window masks whether or not the attention is causal."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    s = torch.where(keep, s, _lm.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v, window: int, q_offset: int) -> None:
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _lm.check_dtype(t, f"flash_attention {what}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention {what}: expected 4 dims, got "
                             f"{tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} and q_offset "
                         f"{q_offset} must be >= 0")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Skv, KV, hd) -> (B, Sq, H, hd); q is
    scaled by hd ** -0.5."""
    _check(q, k, v, window, q_offset)
    dev = _lm.check_same_device("flash_attention", q, k, v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if _lm.wants_grad(q, k, v):
        return _lm.KernelWithPlainBackward.apply(
            lambda q, k, v: _launch(q, k, v, **kw),
            lambda q, k, v: flash_attention_ref(q, k, v, **kw), q, k, v)
    return _launch(q, k, v, **kw)


def _launch(q, k, v, *, causal: bool, window: int,
            q_offset: int) -> torch.Tensor:
    """The kernel of q's dtype on checked CUDA operands; counts the
    launch."""
    dev = q.device
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if hd not in _lm.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} is not one "
                         f"of {_lm.HEAD_DIMS}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _lm.check_kernel_operand(t, f"flash_attention {what}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no key to attend to (Skv = 0)")
    scale = hd ** -0.5
    variant = "tc_bf16" if q.dtype == torch.bfloat16 else "simt_f32"
    name = VARIANTS[variant]
    lib = _lm.bind(name, _ARGTYPES)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, hd, int(q_offset), int(bool(causal)), int(window),
            float(scale), _lm.stream_of(dev))
    _lm.raise_on_error(lib, name, err,
                       f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


#: kernel launches made by this process through :func:`flash_attention`
flash_attention.launches = 0
#: the same launches by kernel (``VARIANTS``)
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
