"""Feed-forward layers: SwiGLU / GeLU MLP."""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import partition as pt
from repro_torch.models.layers import dense, init_dense


def mlp_apply(params: dict, x: torch.Tensor, act: str = "swiglu",
              part=None) -> torch.Tensor:
    """The FFN of ``x``. With a sharded step's ``part``
    (``launch/partition.py``), ``x`` holds the gathered sequence, the up
    projections are column-parallel (this rank's d_ff columns) and the down
    projection row-parallel (its partial sums reduced over 'model')."""
    if part is None:
        col = row = lambda x, w, _key: dense(x, w)
    else:
        col = functools.partial(pt.column, part)
        row = functools.partial(pt.row, part)
    if act == "swiglu":
        g = col(x, params["w_gate"], "ffn/w_gate")
        u = col(x, params["w_up"], "ffn/w_up")
        h = F.silu(g.float()).to(x.dtype) * u
        return row(h, params["w_down"], "ffn/w_down")
    if act == "gelu":
        h = col(x, params["w_up"], "ffn/w_up")
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return row(h, params["w_down"], "ffn/w_down")
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
