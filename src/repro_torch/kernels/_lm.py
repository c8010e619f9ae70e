"""What the three language-model kernel wrappers (``rmsnorm.py``,
``flash_attention.py``, ``decode_attention.py``) share: their element types,
the checks an operand passes before its pointer reaches a kernel, the
binding of a launcher from its library, and the gradient of a launch
(:class:`KernelWithPlainBackward`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: element types the kernels take, and their codes (``lm::DType`` in
#: ``csrc/lm_common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 96, 128)

NEG_INF = -1e30


def check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: expected float32 or bfloat16, got {t.dtype}")


def check_same_device(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: operands lie on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} runs on CUDA devices (or the CPU's plain "
                           f"version), got {dev}")
    return dev


def check_kernel_operand(t: torch.Tensor, what: str) -> None:
    """A CUDA operand must be contiguous and 16-byte aligned: the kernels
    index it by its logical shape and read it with vector loads."""
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} is not 16-byte aligned")


def bind(name: str, argtypes: list) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``<name>_launch`` and
    ``<name>_error_string`` declared; built at first use."""
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, err: int, detail: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed ({detail}): CUDA "
                           f"error {err}: {msg}")


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def wants_grad(*ts: torch.Tensor) -> bool:
    """True when autograd records this call: grad mode is on and an operand
    requires a gradient. Only then does a wrapper route its launch through
    :class:`KernelWithPlainBackward`; otherwise it launches directly, so a
    decode step (grad mode off) runs and counts exactly as before."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class KernelWithPlainBackward(torch.autograd.Function):
    """A kernel launch with the gradient of its plain version.

    ``apply(launch, plain, *inputs)``: the forward is ``launch(*inputs)``,
    the kernel, exactly as without autograd (its launch counts too). The
    backward recomputes ``plain(*inputs)`` under autograd from the saved
    inputs and returns ``torch.autograd.grad`` of it: the hand-written
    kernels write their outputs through ``ctypes``, which autograd cannot
    see, so without this a backward on the card would stop at every kernel
    without an error. Non-tensor arguments (eps, window, kv_len) reach both
    callables through their closures. The backward kernels themselves are
    later work; this one is the plain version's arithmetic, on the card.
    """

    @staticmethod
    def forward(ctx, launch, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], grad_out))
        return (None, None) + tuple(next(grads) if need else None
                                    for need in needs)
