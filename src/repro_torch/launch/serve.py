"""Serving: batched prefill + greedy decode of same-length requests.

The JAX package's ``serve.main()`` first plans the stealing policy by
simulating the fleet (``sched/planner.py``) and schedules the requests with
``sched/ws_scheduler.py``; that command line comes with the query-path slice.
This module holds the part that runs the model: :class:`Request` and
:func:`decode_batch`. On the card every step of the call (prefill's and
decode's) after the first is a replay of one CUDA graph
(``launch/steps.py::GraphedDecodeStep``); on the CPU the steps run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.launch.steps import GraphedDecodeStep, check_model_device


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
    ``vocab`` that it never reads; the port leaves it out.) ``device=None``
    means the card (and raises without one); the model must live on the
    same device. On the card the steps replay one CUDA graph; a failed
    capture or replay raises."""
    check_model_device(model, device)
    S = len(reqs[0].prompt)
    if any(len(r.prompt) != S for r in reqs):
        raise ValueError("decode_batch serves requests of one prompt length")
    max_new = max(r.max_new for r in reqs)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             dtype=torch.int64, device=model.device)
    # the graph is captured once a call: it holds this call's cache
    step = GraphedDecodeStep(model) if model.device.type == "cuda" \
        else model.decode_step
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  max_seq=S + max_new, step=step)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    outs = []
    for i in range(max_new):
        outs.append(tok[:, 0])
        logits, cache = step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    decode_batch.last_graph = (step.stats() if isinstance(
        step, GraphedDecodeStep) else None)
    return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()


#: the graph of the last call on the card (``GraphedDecodeStep.stats()``:
#: warm-up and capture seconds, replays, launches a replay); None on the CPU
decode_batch.last_graph = None
