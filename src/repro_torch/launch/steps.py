"""Step builders: prefill and decode of the serving path.

The JAX package's ``launch/steps.py`` also builds the train step and plans
and lowers (arch × shape × mesh) cells with activation and context-parallel
shardings; those come with the training and mesh slices.
"""
from __future__ import annotations

from repro_torch.device import resolve_device


def check_model_device(model, device) -> None:
    """The device rule of the serving entry points: ``device=None`` means
    the card (and raises without one); the model must live there."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"the model lives on {model.device}, the caller "
                         f"asked for {dev}")


def build_prefill_step(model, device=None):
    """``prefill_step(params, batch)`` -> next-token logits (B, 1, Vpad) in
    float32: ``Model.forward`` over the whole prompt, the head applied to the
    last position only (the JAX package slices the full logits; the other
    positions' logits are never read). ``device=None`` means the card."""
    check_model_device(model, device)

    def prefill_step(params, batch):
        x = model.hidden_states(params, batch)
        return model.head(params, x[:, -1:])
    return prefill_step


def build_decode_step(model, device=None):
    """``decode_step(params, cache, tokens, pos)`` -> (logits, cache), the
    cache updated in place. ``device=None`` means the card."""
    check_model_device(model, device)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode_step
