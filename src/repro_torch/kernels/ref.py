"""Plain PyTorch versions of the kernels in this package (the ``ref.py``
contract): each kernel is held against the function of the same name here.

* ``ws_sim_ref``           -> the batched event loop of
                              ``repro_torch.core.engine`` under any of the
                              three task models (bit-exact vs the serial
                              numpy oracles in ``repro_torch.core.oracle``)
* ``rms_norm_ref``         -> float32 RMSNorm (``kernels/rmsnorm.py``)
* ``flash_attention_ref``  -> full-materialization attention
                              (``kernels/flash_attention.py``)
* ``decode_attention_ref`` -> dense single-query attention
                              (``kernels/decode_attention.py``)

The three language-model versions live beside their wrappers and are
re-exported here.
"""
from __future__ import annotations

from repro_torch.core import engine as _eng
from repro_torch.core.sweep import as_model as _as_model
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_ref)
from repro_torch.kernels.rmsnorm import rms_norm_ref  # noqa: F401


def ws_sim_ref(model, scn: _eng.Scenario):
    """``model`` is a task model or any engine config (divisible, DAG,
    adaptive); runs on the device the scenario's tensors lie on and returns
    the model's result NamedTuple."""
    return _eng.simulate_batch(_as_model(model), scn)
