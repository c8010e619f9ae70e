"""Flash decode: the wrapper of the hand-written Hopper kernel
``csrc/decode_attention.cu`` and its plain version.

It replaces ``flash_decode`` of the JAX package's
``kernels/decode_attention.py`` (the function of
``models/attention.py::decode_attention``): one query token, q ``(B, 1, H,
hd)``, against caches ``(B, Smax, KV, hd)`` whose first ``kv_len`` positions
are valid (with a window, only the last ``window`` of them). q and the caches
may differ in dtype (float32 activations beside a bfloat16 cache); the
result has q's dtype and is computed in float32.

``kv_len`` is a Python int, checked on the host to lie in ``[1, Smax]``, or,
as the Pallas kernel takes it, an int32 tensor of one element on q's device.
A tensor is never read on the host (no ``.item()``, no copy), so a launch
captured in a CUDA graph reads each replay's value; the kernel clamps it to
``[1, Smax]``, so a value outside that range is outside the contract but
never reads out of bounds. The launch shape depends on the shapes alone.

The kernel reads each KV head once for all the query heads that share it and
cuts a long cache into splits (:func:`num_splits`): one split is variant
``single`` (the kernel writes the output), more are variant ``split`` (each
block writes a float32 partial to a workspace allocated here, and a merge
kernel in the same launcher combines the splits in a fixed order, so results
repeat bit for bit). The design, and what bounds the kernel on this card,
are written at the head of the CUDA source.

:func:`flash_decode` launches the kernel for tensors on a CUDA device and
raises if it cannot; only for tensors that lie on the CPU does it run the
plain version :func:`decode_attention_ref`. When autograd records the call,
the launch goes through ``_lm.KernelWithPlainBackward``, whose backward is
the plain version's gradient. ``flash_decode.launches`` counts launches,
``flash_decode.launches_by_variant`` the launches of each variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import _lm

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

VARIANTS = ("single", "split")
#: limits of the kernel (``MAX_SPLITS``, ``MAX_HEADS_PER_BLOCK`` in
#: ``csrc/decode_attention.cu``)
MAX_SPLITS = 128
MAX_HEADS_PER_BLOCK = 4
#: the split rule: no split holds fewer rows than this, and the sequence is
#: cut only as far as it takes the grid to reach SPLIT_WAVES blocks an SM
SPLIT_MIN_ROWS = 256
SPLIT_WAVES = 4

KvLen = Union[int, torch.Tensor]


def heads_per_block(G: int) -> int:
    """Query heads a block serves (``heads_per_block`` of the CUDA source):
    G itself up to 2, else MAX_HEADS_PER_BLOCK (several blocks a KV head)."""
    return G if G <= 2 else MAX_HEADS_PER_BLOCK


def num_splits(B: int, H: int, KV: int, Smax: int,
               sm_count: int) -> tuple:
    """(splits, rows a split) of a cache of Smax rows. It depends on the
    shapes alone, never on kv_len, so a captured launch serves every kv_len.
    Every split holds at least one row of the cache."""
    G = H // KV
    blocks = B * KV * -(-G // heads_per_block(G))
    n = max(1, min(-(-SPLIT_WAVES * sm_count // blocks),
                   Smax // SPLIT_MIN_ROWS, MAX_SPLITS))
    rows = -(-Smax // n)
    return -(-Smax // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_ref(q, k_cache, v_cache, kv_len: KvLen, *,
                         window: int = 0) -> torch.Tensor:
    """The plain version, as ``models/attention.py::decode_attention`` of the
    JAX package: grouped-query scores against the whole cache in float32,
    positions outside the valid range masked with -1e30, a softmax, the
    product with v; cast to q's dtype. ``kv_len`` an int or a tensor of one
    element (compared on its device, never read on the host)."""
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
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32:
            raise TypeError(f"flash_decode: a kv_len tensor must be int32, "
                            f"got {kv_len.dtype}")
        if kv_len.numel() != 1 or kv_len.device != q.device:
            raise ValueError(f"flash_decode: a kv_len tensor must hold one "
                             f"element on {q.device}, got "
                             f"{tuple(kv_len.shape)} on {kv_len.device}")
    elif not isinstance(kv_len, int) or not 1 <= kv_len <= k_cache.shape[1]:
        raise ValueError(f"flash_decode: kv_len must be an int in [1, "
                         f"{k_cache.shape[1]}] or an int32 tensor, got "
                         f"{kv_len!r}")
    if window < 0:
        raise ValueError(f"flash_decode: window {window} must be >= 0")


def flash_decode(q, k_cache, v_cache, kv_len: KvLen, *,
                 window: int = 0) -> torch.Tensor:
    """q (B, 1, H, hd); caches (B, Smax, KV, hd); kv_len a Python int or an
    int32 tensor of one element on q's device; q is scaled by hd ** -0.5.

    Returns (B, 1, H, hd) of q's dtype.
    """
    _check(q, k_cache, v_cache, kv_len, window)
    dev = _lm.check_same_device("flash_decode", q, k_cache, v_cache)
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len,
                                    window=window)
    if _lm.wants_grad(q, k_cache, v_cache):
        return _lm.KernelWithPlainBackward.apply(
            lambda q, kc, vc: _launch(q, kc, vc, kv_len, window),
            lambda q, kc, vc: decode_attention_ref(q, kc, vc, kv_len,
                                                   window=window),
            q, k_cache, v_cache)
    return _launch(q, k_cache, v_cache, kv_len, window)


def _launch(q, k_cache, v_cache, kv_len: KvLen,
            window: int) -> torch.Tensor:
    """The kernel on checked CUDA operands; counts the launch."""
    dev = q.device
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
    n_split, rows = num_splits(B, H, KV, Smax, _sm_count(dev.index))
    ws = (torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                      device=dev) if n_split > 1 else None)
    on_device = isinstance(kv_len, torch.Tensor)
    lib = _lm.bind("decode_attention", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            kv_len.data_ptr() if on_device else None, B, Smax, H, KV, hd,
            0 if on_device else kv_len, n_split, rows, int(window),
            float(hd ** -0.5), _lm.DTYPE_CODES[q.dtype],
            _lm.DTYPE_CODES[k_cache.dtype], _lm.stream_of(dev))
    _lm.raise_on_error(
        lib, "decode_attention", err,
        f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, kv_len="
        f"{'on the device' if on_device else kv_len}, {n_split} splits, "
        f"{q.dtype}/{k_cache.dtype}")
    flash_decode.launches += 1
    flash_decode.launches_by_variant[VARIANTS[n_split > 1]] += 1
    return out


#: launches made by this process through :func:`flash_decode`
flash_decode.launches = 0
#: the same launches by variant (``VARIANTS``)
flash_decode.launches_by_variant = dict.fromkeys(VARIANTS, 0)
