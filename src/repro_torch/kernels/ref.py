"""Plain PyTorch versions of the kernels in this package (the ``ref.py``
contract): each kernel is held against the function of the same name here.

* ``ws_sim_ref`` -> the batched event loop of ``repro_torch.core.engine``
                    (bit-exact vs the serial numpy oracle in
                    ``repro_torch.core.oracle``)
"""
from __future__ import annotations

from repro_torch.core import divisible as _dv
from repro_torch.core import engine as _eng


def ws_sim_ref(model, scn: _dv.Scenario) -> _dv.SimResult:
    """``model`` is a task model or an :class:`EngineConfig`; runs on the
    device the scenario's tensors lie on."""
    if isinstance(model, _dv.EngineConfig):
        model = _dv.DivisibleModel(model)
    return _eng.simulate_batch(model, scn)
