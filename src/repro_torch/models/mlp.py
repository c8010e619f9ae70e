"""Feed-forward layers: SwiGLU / GeLU MLP."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, init_dense


def mlp_apply(params: dict, x: torch.Tensor,
              act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        g = dense(x, params["w_gate"])
        u = dense(x, params["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
        return dense(h, params["w_down"])
    if act == "gelu":
        h = dense(x, params["w_up"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return dense(h, params["w_down"])
    raise ValueError(act)


def mlp_init(gen: Optional[torch.Generator], d_model: int, d_ff: int, dtype,
             act: str = "swiglu") -> dict:
    if act == "swiglu":
        return {
            "w_gate": init_dense(gen, d_model, d_ff, dtype),
            "w_up": init_dense(gen, d_model, d_ff, dtype),
            "w_down": init_dense(gen, d_ff, d_model, dtype),
        }
    return {
        "w_up": init_dense(gen, d_model, d_ff, dtype),
        "w_down": init_dense(gen, d_ff, d_model, dtype),
    }
