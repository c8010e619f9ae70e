"""The device rule of every entry point of the port, shared by the simulator
(``core/``, ``service/``) and the language-model path (``models/``,
``launch/``): ``None`` means the card, and raises without one; the CPU is
used only when asked for by name."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device rule of every entry point: ``None`` means the card, and
    raises without one; the CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this entry point runs on the GPU unless "
                "device='cpu' is passed explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
