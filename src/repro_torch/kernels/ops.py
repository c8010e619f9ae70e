"""The public wrappers of the port's language-model kernels (the JAX
package's ``kernels/ops.py``), and their launch counts.

The model calls its kernels through these names. Each wrapper checks its
operands' device, dtype, shape and contiguity; on CUDA tensors it launches its
kernel or raises (there is no fallback), and only for tensors that lie on the
CPU does it run its plain version. Each is differentiable: when grad mode is
on and an operand requires a gradient, the launch goes through
``_lm.KernelWithPlainBackward``, whose backward recomputes the plain version
under autograd (the plain version's own gradient, on the card); otherwise it
launches directly. Each keeps an integer ``launches`` count
and a ``launches_by_variant`` dict (``rms_norm``: register or generic kernel;
``flash_attention``: tensor cores or float32; ``flash_decode``: one split or
several).

A CUDA graph replays launches that the wrappers counted once, while it was
captured; :func:`counts_since` and :func:`add_counts` let its runner move
those counts to the replays (``launch/steps.py::GraphedDecodeStep``).
The simulator's kernel is ``kernels/ws_sim.py::ws_sim_cuda``.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rms_norm

__all__ = ["flash_attention", "flash_decode", "rms_norm", "add_counts",
           "counts_since", "launch_counts", "reset_counts", "variant_counts"]

_LM_WRAPPERS = (rms_norm, flash_attention, flash_decode)


def launch_counts() -> dict:
    """Kernel launches of the three wrappers since the last reset, by
    name."""
    return {fn.__name__: fn.launches for fn in _LM_WRAPPERS}


def variant_counts() -> dict:
    """Kernel launches since the last reset, by wrapper and variant."""
    return {fn.__name__: dict(fn.launches_by_variant)
            for fn in _LM_WRAPPERS}


def counts_since(before: tuple) -> tuple:
    """(launches, launches by variant) made since ``before``, a
    ``(launch_counts(), variant_counts())`` pair."""
    launches, variants = before
    return ({k: n - launches[k] for k, n in launch_counts().items()},
            {fn: {v: n - variants[fn][v] for v, n in by.items()}
             for fn, by in variant_counts().items()})


def add_counts(delta: tuple, times: int = 1) -> None:
    """Add ``times`` x a ``counts_since`` result to the counts (a negative
    ``times`` takes it back out)."""
    launches, variants = delta
    for fn in _LM_WRAPPERS:
        fn.launches += times * launches.get(fn.__name__, 0)
        for v, n in variants.get(fn.__name__, {}).items():
            fn.launches_by_variant[v] += times * n


def reset_counts() -> None:
    """Set the three wrappers' launch counts, variants too, to 0."""
    for fn in _LM_WRAPPERS:
        fn.launches = 0
        for variant in fn.launches_by_variant:
            fn.launches_by_variant[variant] = 0
