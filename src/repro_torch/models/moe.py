"""Mixture-of-Experts layer: top-k routing, capacity, WS overflow rebalance.

Dispatch is scatter-based (no (T, E, C) one-hot tensors): each token computes
its (expert, slot) coordinates; tokens are scattered into a per-expert buffer
``(E, C, D)``, run through batched expert FFNs, and gathered back.

**Work-stealing overflow rebalance** (the JAX package's DESIGN.md §3): with
``ws_rebalance=True``, tokens that overflow an expert's capacity are not
dropped; idle capacity in other experts "steals" them (the o-th overflowing
assignment takes the o-th free slot, walking the experts in order of their
index), mirroring the paper's idle-processor steal. This trades routing
fidelity for fewer dropped tokens.

The port of the JAX package's ``models/moe.py``, operation for operation, so
that routing (experts, slots, keep masks) and the ``dropped``/``stolen``
fractions are equal to it, not merely close. Every step is a fixed-shape
tensor operation on the device: no boolean-mask indexing, no read of a
device value on the host, so a decode step that runs it can be captured in
a CUDA graph. The layout hints (:func:`set_shard_hints`, set by
``launch/steps.py::plan_cell``) pin the dispatch groups' layout at the JAX
package's four places on a DTensor; on a rank-local tensor they are the
identity. A sharded step on a live mesh does not run :func:`moe_apply`: it
routes each rank's groups with the same :func:`_route`, :func:`dispatch`
and :func:`combine`, and moves the buffers between groups and experts with
explicit collectives (``launch/partition.py::moe``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, init_dense


class MoEStats(NamedTuple):
    dropped: torch.Tensor      # fraction of (token, k) assignments dropped
    stolen: torch.Tensor       # fraction rebalanced by WS overflow stealing
    load_std: torch.Tensor     # std of per-expert load (balance metric)


# Launch-level layout hints (set by repro_torch.launch.steps.plan_cell; None
# outside a planned cell). Module-level so model code stays mesh-agnostic:
# specs are tuples of axis-name entries for the leading dims.
_SHARD_HINTS = {"tokens": None, "experts": None}


def set_shard_hints(tokens=None, experts=None):
    _SHARD_HINTS["tokens"] = tokens
    _SHARD_HINTS["experts"] = experts


def _hint(x, kind):
    """``x`` laid out by the ``kind`` hint: a DTensor redistributed to the
    hint's spec on its own mesh; a rank-local tensor (or no hint) as it
    is."""
    spec = _SHARD_HINTS.get(kind)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import NamedSharding
    full = tuple(spec) + (None,) * (x.ndim - len(spec))
    return x.redistribute(x.device_mesh, NamedSharding(
        x.device_mesh, full).placements())


def moe_init(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             n_experts: int, dtype) -> dict:
    """The router (float32, scale 0.02) and each expert's SwiGLU weights,
    stacked over the experts: ``(E, d_model, d_ff)`` and ``(E, d_ff,
    d_model)``, as in the JAX package."""
    def experts(d_in, d_out):
        return torch.stack([init_dense(gen, d_in, d_out, dtype)
                            for _ in range(n_experts)])
    return {
        "router": init_dense(gen, d_model, n_experts, torch.float32,
                             scale=0.02),
        "w_gate": experts(d_model, d_ff),
        "w_up": experts(d_model, d_ff),
        "w_down": experts(d_ff, d_model),
    }


def _expert_ffn(params: dict, xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, D) -> (E, C, D) via per-expert SwiGLU: ``layers.dense``
    takes (E, C, D) @ (E, D, F) as one batched product, an expert each."""
    def mm(a, w):
        return dense(a, w.to(a.dtype))
    g = mm(xb, params["w_gate"])
    u = mm(xb, params["w_up"])
    h = F.silu(g.float()).to(xb.dtype) * u
    return mm(h, params["w_down"])


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of ``idx`` by comparison with ``arange(n)``."""
    classes = torch.arange(n, device=idx.device)
    return (idx[..., None] == classes).to(dtype)


class _Route(NamedTuple):
    """One group's routing: what the dispatch reads, then what only the
    statistics read."""
    flat_e: torch.Tensor      # (Tg*k,) int64 expert, after stealing
    slot_c: torch.Tensor      # (Tg*k,) int64 slot, clipped into [0, C)
    keep: torch.Tensor        # (Tg*k,) bool: the assignment is not dropped
    gates: torch.Tensor       # (Tg*k,) float32, 0 where dropped
    probs: torch.Tensor       # (Tg, E) float32 router probabilities
    expert_idx: torch.Tensor  # (Tg, k) int64 top-k experts, largest first
    steal: Optional[torch.Tensor]  # (Tg*k,) bool stolen; None: no rebalance
    load: torch.Tensor        # (E,) int64 assignments before stealing


def _top_k(xt, router, top_k: int):
    """xt (Tg, D) -> (probs (Tg, E), gate_vals (Tg, k) normalised,
    expert_idx (Tg, k)), all from the float32 router product."""
    logits = dense(xt.float(), router)                              # (Tg, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the largest first, the lower index first on a tie. A
    # stable sort in descending order gives exactly that order.
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :top_k], expert_idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _slots(expert_idx, n_experts: int, C: int, ws_rebalance: bool):
    """The integer half of the routing: expert_idx (Tg, k) -> (flat_e,
    slot_c, keep, steal, load), as :class:`_Route` holds them."""
    flat_e = expert_idx.reshape(-1)                                 # (Tg*k,)
    onehot = _one_hot(flat_e, n_experts, torch.int64)
    ranks = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(ranks, 1, flat_e[:, None])[:, 0]
    load = onehot.sum(dim=0)                                        # (E,)
    overflow = slot >= C
    steal = None
    if ws_rebalance:
        # Idle capacity steals overflow tokens: the o-th overflow assignment
        # goes to the o-th free slot, walking experts by spare capacity.
        spare = torch.clamp_min(C - load, 0)
        spare_end = torch.cumsum(spare, dim=0)
        free_starts = spare_end - spare
        total_free = spare.sum()
        ov_rank = torch.cumsum(overflow.long(), dim=0) - 1
        tgt_expert = torch.searchsorted(spare_end, ov_rank, right=True)
        tgt_expert = torch.clamp(tgt_expert, 0, n_experts - 1)
        tgt_slot = C - spare[tgt_expert] + (ov_rank - free_starts[tgt_expert])
        steal = overflow & (ov_rank < total_free)
        flat_e = torch.where(steal, tgt_expert, flat_e)
        slot = torch.where(steal, tgt_slot, slot)
        overflow = overflow & ~steal
    return flat_e, torch.clamp(slot, 0, C - 1), ~overflow, steal, load


def _route(xt, router, n_experts: int, top_k: int, C: int,
           ws_rebalance: bool) -> _Route:
    probs, gate_vals, expert_idx = _top_k(xt, router, top_k)
    flat_e, slot_c, keep, steal, load = _slots(expert_idx, n_experts, C,
                                               ws_rebalance)
    gates = gate_vals.reshape(-1) * keep.to(gate_vals.dtype)
    return _Route(flat_e, slot_c, keep, gates, probs, expert_idx, steal,
                  load)


def _route_stats(r: _Route, n_experts: int):
    """(aux, dropped, stolen) of one group: the Switch-style load-balancing
    loss and the fractions of assignments dropped and stolen."""
    me = torch.mean(r.probs, dim=0)
    ce = torch.mean(_one_hot(r.expert_idx[:, 0], n_experts, torch.float32),
                    dim=0)
    aux = n_experts * torch.sum(me * ce)
    dropped = (~r.keep).float().mean()
    stolen = (r.steal.float().mean() if r.steal is not None else
              torch.zeros((), dtype=torch.float32, device=r.keep.device))
    return aux, dropped, stolen


def _route_group(xt, router, n_experts: int, top_k: int, C: int,
                 ws_rebalance: bool):
    """Per-group routing: xt (Tg, D) -> dispatch coords + gates + stats:
    (flat_e, slot_c, keep, gates, aux, dropped, stolen, load), indices
    int64, ``keep`` bool, the rest float32 (``load`` int64), as the JAX
    package's."""
    r = _route(xt, router, n_experts, top_k, C, ws_rebalance)
    aux, dropped, stolen = _route_stats(r, n_experts)
    return r.flat_e, r.slot_c, r.keep, r.gates, aux, dropped, stolen, r.load


def capacity(n_tokens: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots an expert of a group of ``n_tokens`` tokens: the JAX package's
    expression, with Python's ``round`` (half to even: 7.5 -> 8)."""
    return int(max(1, round(n_tokens * top_k * capacity_factor / n_experts)))


def dispatch(xg: torch.Tensor, routes, n_experts: int,
             C: int) -> torch.Tensor:
    """xg (G, Tg, D) scattered by each group's :class:`_Route` into (G, E,
    C, D): each kept (expert, slot) is written by one assignment; dropped
    ones go to a spare last row, never read."""
    G, Tg, D = xg.shape
    top_k = routes[0].flat_e.numel() // Tg
    tok_idx = torch.arange(Tg, device=xg.device).repeat_interleave(top_k)
    spare_row = n_experts * C
    buf = torch.zeros((G, spare_row + 1, D), dtype=xg.dtype, device=xg.device)
    for g, r in enumerate(routes):
        rows = torch.where(r.keep, r.flat_e * C + r.slot_c, spare_row)
        buf[g].index_copy_(0, rows, xg[g][tok_idx])
    return buf[:, :spare_row].reshape(G, n_experts, C, D)


def combine(out_buf: torch.Tensor, routes, top_k: int) -> torch.Tensor:
    """(G, Tg, D): token t of each group sums its k contributions from
    ``out_buf`` (G, E, C, D) in order, in its dtype (the JAX package's
    scatter-add applies them in index order on the CPU)."""
    ys = []
    for g, r in enumerate(routes):
        contrib = out_buf[g][r.flat_e, r.slot_c] \
            * r.gates[:, None].to(out_buf.dtype)                  # (Tg*k, D)
        contrib = contrib.reshape(-1, top_k, out_buf.shape[-1])
        y = contrib[:, 0]
        for j in range(1, top_k):
            y = y + contrib[:, j]
        ys.append(y)
    return torch.stack(ys)


def _moe(params: dict, x: torch.Tensor, n_experts: int, top_k: int,
         capacity_factor: float, ws_rebalance: bool, n_groups: int):
    """The layer's output (B, S, D) and each group's :class:`_Route`."""
    B, S, D = x.shape
    T = B * S
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    C = capacity(Tg, top_k, capacity_factor, n_experts)
    xg = _hint(x.reshape(G, Tg, D), "tokens")
    routes = [_route(xg[g], params["router"], n_experts, top_k, C,
                     ws_rebalance) for g in range(G)]
    buf = _hint(dispatch(xg, routes, n_experts, C), "experts")

    # expert FFN over all groups: the groups' slots side by side, per expert
    xb = buf.transpose(0, 1).reshape(n_experts, G * C, D)
    out_buf = _hint(_expert_ffn(params, xb).reshape(n_experts, G, C, D)
                    .transpose(0, 1), "experts")                 # (G,E,C,D)
    return _hint(combine(out_buf, routes, top_k), "tokens").reshape(
        B, S, D), routes


def group_stats(routes, n_experts: int):
    """(aux, dropped, stolen, load) of each group, each a list, as
    :func:`_route_stats` and :class:`_Route` give them."""
    aux, dropped, stolen = (list(v) for v in zip(
        *(_route_stats(r, n_experts) for r in routes)))
    return aux, dropped, stolen, [r.load for r in routes]


def moe_apply(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, ws_rebalance: bool = False,
              n_groups: int = 1):
    """x: (B, S, D) -> (y, aux_loss, MoEStats).

    GShard-style grouped dispatch: tokens split into ``n_groups``
    independent routing groups (one group when ``n_groups`` does not divide
    the tokens), each with its own capacity. The groups are routed one after
    the other and their buffers stacked; the expert FFNs take every group's
    slots in one product an expert. ``aux`` and the statistics are the means
    over the groups.
    """
    y, routes = _moe(params, x, n_experts, top_k, capacity_factor,
                     ws_rebalance, n_groups)
    aux, dropped, stolen, load = group_stats(routes, n_experts)
    aux, dropped, stolen = (torch.stack(v).mean()
                            for v in (aux, dropped, stolen))
    load = torch.stack(load).sum(0)
    stats = MoEStats(dropped=dropped, stolen=stolen,
                     load_std=torch.std(load.float(), correction=0))
    return y, aux, stats


def moe_output(params: dict, x: torch.Tensor, *, n_experts: int,
               top_k: int, capacity_factor: float = 1.25,
               ws_rebalance: bool = False, n_groups: int = 1) -> torch.Tensor:
    """:func:`moe_apply`'s y alone, with neither the aux loss nor the
    statistics computed: what a caller that drops them runs (the decode
    step; in the JAX package XLA removes that work, eager PyTorch would
    launch it)."""
    return _moe(params, x, n_experts, top_k, capacity_factor, ws_rebalance,
                n_groups)[0]
