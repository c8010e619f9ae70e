"""Error-feedback int8 gradient compression (the JAX package's
``optim/compression.py``).

Each gradient tensor is quantized to int8 with one float32 scale a tensor
before the (cross-pod) reduction, and the quantization residual is kept in
an error-feedback buffer (EF-SGD), which restores convergence to the
uncompressed trajectory. As in the JAX package, the compression is the
quantize -> dequantize sandwich of the unsharded training entry point
(``launch/train.py``) on its gradients, so the numerics are those of the
compressed wire; the sharded train step (``launch/steps.py::
build_train_step`` on a mesh) does not compress its reductions, as the JAX
package's does not.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.optim import adamw


class EFState(NamedTuple):
    error: Any          # tree like grads, float32


def init_ef(params) -> EFState:
    """Zero residuals (``adamw.zeros``, as the moments: no memory until the
    first step writes new tensors)."""
    return EFState(error=tr.tree_map(adamw.zeros, params))


def ef_shapes(param_shapes) -> EFState:
    """The state's (shape, dtype) leaves for a tree of parameter (shape,
    dtype) leaves, allocating nothing: the JAX package's ``abstract_ef``."""
    return EFState(error=tr.tree_map(
        lambda leaf: (tuple(leaf[0]), torch.float32), param_shapes))


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tensor -> (int8 payload, float32 scale): ``round`` half to even,
    as ``jnp.round``, clipped to [-127, 127]."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def ef_compress_tree(grads, ef: EFState) -> Tuple[Any, EFState]:
    """Quantize (grads + error); the new error is the input minus the
    dequantized output. New tensors; ``grads`` and ``ef`` are not written."""
    def one(g, e):
        target = g.to(torch.float32) + e
        q, s = compress(target)
        deq = decompress(q, s)
        return deq.to(g.dtype), target - deq

    outs = tr.tree_map(one, grads, ef.error)
    new_g, new_e = (tr.tree_map(lambda o, i=i: o[i], outs) for i in (0, 1))
    return new_g, EFState(error=new_e)


def wire_bytes(params) -> Tuple[int, int]:
    """(uncompressed, compressed) cross-pod bytes per step for a tree of
    tensors or of (shape, dtype) leaves."""
    shapes = [p[0] if isinstance(p, tuple) else p.shape
              for p in tr.leaves(params)]
    n = sum(int(math.prod(s)) for s in shapes)
    return 4 * n, 1 * n + 4 * len(shapes)
