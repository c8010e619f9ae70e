"""Flash decode: the wrapper of the hand-written Hopper kernel
``csrc/decode_attention.cu`` and its plain version.

It replaces ``flash_decode`` of the JAX package's
``kernels/decode_attention.py`` (the function of
``models/attention.py::decode_attention``): one query token, q ``(B, 1, H,
hd)``, against caches ``(B, Smax, KV, hd)`` whose first ``kv_len`` positions
are valid (with a window, only the last ``window`` of them). q and the caches
may differ in dtype (float32 activations beside a bfloat16 cache); the
result has q's dtype and is computed in float32. The design, and what bounds
the kernel on this card, are written at the head of the CUDA source.

:func:`flash_decode` launches the kernel for tensors on a CUDA device and
raises if it cannot; only for tensors that lie on the CPU does it run the
plain version :func:`decode_attention_ref`. ``flash_decode.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _lm

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def decode_attention_ref(q, k_cache, v_cache, kv_len: int, *,
                         window: int = 0) -> torch.Tensor:
    """The plain version, as ``models/attention.py::decode_attention`` of the
    JAX package: grouped-query scores against the whole cache in float32,
    positions outside the valid range masked with -1e30, a softmax, the
    product with v; cast to q's dtype."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = (q.float()[:, 0] * scale).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    keep = pos < kv_len
    if window > 0:
        keep &= pos >= kv_len - window
    s = torch.where(keep, s, _lm.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _check(q, k_cache, v_cache, kv_len, window: int) -> None:
    for t, what in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        _lm.check_dtype(t, f"flash_decode {what}")
        if t.ndim != 4:
            raise ValueError(f"flash_decode {what}: expected 4 dims, got "
                             f"{tuple(t.shape)}")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError(f"flash_decode: caches are {k_cache.dtype} and "
                        f"{v_cache.dtype}")
    B, one, H, hd = q.shape
    if one != 1 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or H % k_cache.shape[2]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)} do "
                         f"not fit")
    if not isinstance(kv_len, int) or not 1 <= kv_len <= k_cache.shape[1]:
        raise ValueError(f"flash_decode: kv_len must be an int in [1, "
                         f"{k_cache.shape[1]}], got {kv_len!r}")
    if window < 0:
        raise ValueError(f"flash_decode: window {window} must be >= 0")


def flash_decode(q, k_cache, v_cache, kv_len: int, *,
                 window: int = 0) -> torch.Tensor:
    """q (B, 1, H, hd); caches (B, Smax, KV, hd); kv_len a Python int; q is
    scaled by hd ** -0.5.

    Returns (B, 1, H, hd) of q's dtype.
    """
    _check(q, k_cache, v_cache, kv_len, window)
    dev = _lm.check_same_device("flash_decode", q, k_cache, v_cache)
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len,
                                    window=window)
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if hd not in _lm.HEAD_DIMS:
        raise ValueError(f"flash_decode kernel: head_dim {hd} is not one of "
                         f"{_lm.HEAD_DIMS}")
    for t, what in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        _lm.check_kernel_operand(t, f"flash_decode {what}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = hd ** -0.5
    lib = _lm.bind("decode_attention", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), B, Smax, H, KV, hd, kv_len, int(window),
            float(scale), _lm.DTYPE_CODES[q.dtype],
            _lm.DTYPE_CODES[k_cache.dtype], _lm.stream_of(dev))
    _lm.raise_on_error(lib, "decode_attention", err,
                       f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                       f"kv_len={kv_len}, {q.dtype}/{k_cache.dtype}")
    flash_decode.launches += 1
    return out


#: kernel launches made by this process through :func:`flash_decode`
flash_decode.launches = 0
