"""Fused RMSNorm: the wrapper of the hand-written Hopper kernel
``csrc/rmsnorm.cu`` and its plain version.

It replaces ``rms_norm`` of the JAX package's ``kernels/rmsnorm.py`` (the
function of ``models/layers.py::rms_norm``): ``x * rsqrt(mean(x²) + eps) *
scale`` over the last axis, statistics in float32, cast back to ``x``'s type.
The design, and what bounds the kernel on this card, are written at the head
of the CUDA source: for the row widths of ``REG_WIDTHS`` a kernel that keeps
the row in registers (variant ``row_in_registers``; the launcher picks the
threads a row, which :func:`threads_per_row` reports), for any other width a
generic one.

:func:`rms_norm` launches the kernel for tensors on a CUDA device and raises
if it cannot; only for tensors that lie on the CPU does it run the plain
version :func:`rms_norm_ref`. When autograd records the call, the launch
goes through ``_lm.KernelWithPlainBackward``, whose backward is the plain
version's gradient. ``rms_norm.launches`` counts kernel launches,
``rms_norm.launches_by_variant`` the launches of each variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lm

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]

#: row widths whose kernel keeps the row in registers (the cases of
#: ``csrc/rmsnorm.cu::with_width``)
REG_WIDTHS = (128, 256, 512, 1024, 1280, 2048, 3072, 4096, 8192)
VARIANTS = ("row_in_registers", "generic")


def threads_per_row(rows: int, D: int, dtype: torch.dtype) -> int:
    """The threads a row that the kernel's launcher gives ``rows`` rows of
    width ``D`` in ``dtype`` on the current CUDA device, 0 for the generic
    kernel. The rule lives in ``csrc/rmsnorm.cu``; this asks its library."""
    lib = _lm.bind("rmsnorm", _ARGTYPES)
    query = lib.rmsnorm_threads_per_row
    query.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    query.restype = ctypes.c_int
    return query(rows, D, _lm.DTYPE_CODES[dtype])


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """The plain version: the same arithmetic in PyTorch operations."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., D); scale (D,) of x's dtype (float32 or bfloat16)."""
    _lm.check_dtype(x, "rms_norm x")
    if scale.dtype != x.dtype:
        raise TypeError(f"rms_norm: scale is {scale.dtype}, x is {x.dtype}")
    D = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or tuple(scale.shape) != (D,):
        raise ValueError(f"rms_norm: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit")
    dev = _lm.check_same_device("rms_norm", x, scale)
    if dev.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    if _lm.wants_grad(x, scale):
        return _lm.KernelWithPlainBackward.apply(
            lambda x, s: _launch(x, s, eps),
            lambda x, s: rms_norm_ref(x, s, eps), x, scale)
    return _launch(x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on checked CUDA operands; counts the launch."""
    D, dev = x.shape[-1], x.device
    _lm.check_kernel_operand(x, "rms_norm x")
    _lm.check_kernel_operand(scale, "rms_norm scale")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _lm.bind("rmsnorm", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), rows, D, float(eps),
                                 _lm.DTYPE_CODES[x.dtype], _lm.stream_of(dev))
    _lm.raise_on_error(lib, "rmsnorm", err, f"rows={rows}, D={D}, {x.dtype}")
    rms_norm.launches += 1
    rms_norm.launches_by_variant[
        VARIANTS[0] if D in REG_WIDTHS else VARIANTS[1]] += 1
    return out


#: kernel launches made by this process through :func:`rms_norm`
rms_norm.launches = 0
#: the same launches by variant (``VARIANTS``)
rms_norm.launches_by_variant = dict.fromkeys(VARIANTS, 0)
