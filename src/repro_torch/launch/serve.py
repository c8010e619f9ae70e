"""Serving: batched prefill + greedy decode of same-length requests.

The JAX package's ``serve.main()`` first plans the stealing policy by
simulating the fleet (``sched/planner.py``) and schedules the requests with
``sched/ws_scheduler.py``; that command line comes with the query-path slice.
This module holds the part that runs the model: :class:`Request` and
:func:`decode_batch`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.launch.steps import check_model_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int


def decode_batch(model, params, reqs: List[Request],
                 device=None) -> np.ndarray:
    """Prefill + greedy-decode a batch of same-length requests; returns the
    new tokens (B, max_new) int32. Greedy takes the first maximal logit, as
    ``jnp.argmax`` does. (The JAX package's ``decode_batch`` also takes a
    ``vocab`` that it never reads; the port leaves it out.) ``device=None`` means the card (and raises without
    one); the model must live on the same device."""
    check_model_device(model, device)
    S = len(reqs[0].prompt)
    if any(len(r.prompt) != S for r in reqs):
        raise ValueError("decode_batch serves requests of one prompt length")
    max_new = max(r.max_new for r in reqs)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             dtype=torch.int64, device=model.device)
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  max_seq=S + max_new)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    outs = []
    for i in range(max_new):
        outs.append(tok[:, 0])
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
