"""What the three language-model kernel wrappers (``rmsnorm.py``,
``flash_attention.py``, ``decode_attention.py``) share: their element types,
the checks an operand passes before its pointer reaches a kernel, and the
binding of a launcher from its library."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: element types the kernels take, and their codes (``lm::DType`` in
#: ``csrc/lm_common.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)

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
