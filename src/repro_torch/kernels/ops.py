"""The public wrappers of the port's language-model kernels (the JAX
package's ``kernels/ops.py``), and their launch counts.

The model calls its kernels through these names. Each wrapper checks its
operands' device, dtype, shape and contiguity; on CUDA tensors it launches its
kernel or raises (there is no fallback), and only for tensors that lie on the
CPU does it run its plain version. Each keeps an integer ``launches`` count;
``rms_norm`` and ``flash_attention``, which choose between kernels, also a
``launches_by_variant`` dict.
The simulator's kernel is ``kernels/ws_sim.py::ws_sim_cuda``.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rms_norm

__all__ = ["flash_attention", "flash_decode", "rms_norm", "launch_counts",
           "reset_counts", "variant_counts"]

_LM_WRAPPERS = (rms_norm, flash_attention, flash_decode)


def launch_counts() -> dict:
    """Kernel launches of the three wrappers since the last reset, by
    name."""
    return {fn.__name__: fn.launches for fn in _LM_WRAPPERS}


def variant_counts() -> dict:
    """Kernel launches since the last reset, by wrapper and variant."""
    return {fn.__name__: dict(fn.launches_by_variant) for fn in _LM_WRAPPERS
            if hasattr(fn, "launches_by_variant")}


def reset_counts() -> None:
    """Set the three wrappers' launch counts, variants too, to 0."""
    for fn in _LM_WRAPPERS:
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", ()):
            fn.launches_by_variant[variant] = 0
