"""Carrying the JAX package's model parameters into the port.

:func:`params_from_jax` takes the JAX package's parameter tree as numpy
arrays — ``jax.tree.map(np.asarray, params)``, leaves stacked over the
``repeats`` axis as ``Model.init_params`` makes them — and returns the
port's tree of tensors: the same keys, the same shapes, the same values,
bit for bit. Nothing here imports JAX.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses. Their bits are reinterpreted as int16 and
viewed as ``torch.bfloat16``: the same 16 bits, no rounding and no float32
copy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.model import Model


def _leaf(x, path: str, want_shape: tuple, want_dtype: torch.dtype,
          device) -> torch.Tensor:
    a = np.array(x, order="C")         # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.float32:
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"params_from_jax: {path} is {a.dtype}; expected "
                        f"float32 or bfloat16")
    if tuple(t.shape) != want_shape or t.dtype != want_dtype:
        raise ValueError(f"params_from_jax: {path} is {tuple(t.shape)} "
                         f"{t.dtype}; the port expects {want_shape} "
                         f"{want_dtype}")
    return t.to(device)


def _convert(tree, want, path: str, device):
    if isinstance(want, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"params_from_jax: {path or 'root'} is a leaf; "
                             f"the port expects {sorted(want)}")
        missing = sorted(set(want) - set(tree))
        extra = sorted(set(tree) - set(want))
        if missing or extra:
            raise ValueError(f"params_from_jax: at {path or 'root'}, leaves "
                             f"missing {missing}, not expected {extra}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}", device)
                for k in want}
    if isinstance(tree, dict):
        raise ValueError(f"params_from_jax: {path} is a subtree; the port "
                         f"expects a leaf")
    shape, dtype = want
    return _leaf(tree, path, shape, dtype, device)


def params_from_jax(tree: Dict, model: Model) -> Dict:
    """The port's parameters, on ``model.device``, from the JAX package's
    parameter tree as numpy arrays. Raises on any missing or extra leaf and
    on any leaf whose shape or dtype differs from ``model``'s."""
    return _convert(tree, model.param_shapes(), "", model.device)
