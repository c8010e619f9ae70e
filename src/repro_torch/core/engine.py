"""Unified Work-Stealing discrete-event core, as plain batched PyTorch.

The paper's architecture is one event/processor engine parameterized by a
pluggable *task engine* (§2.1, §3). This module is that engine: every piece
of machinery that is independent of the task model lives here —

* the one-pending-event-per-processor state (:class:`CoreState`): the global
  event heap of the serial simulator collapses to an argmin over a dense
  ``ev_time`` vector per scenario;
* the three-state processor machine (``ACTIVE`` / ``REQ_FLIGHT`` /
  ``ANS_FLIGHT``) and the event dispatch on it;
* SWT/MWT answer-channel policy (:func:`chan_free`, paper §2.4.1) and the
  bookkeeping shared by every steal answer (:func:`deliver_answer`);
* victim-selection dispatch over the topology strategies (§2.3/§3.3) and the
  per-processor xorshift32 PRNG lanes;
* trace logging (the log engine, §3.5) and result accumulation.

**Batched form.** Every state tensor carries a leading scenario axis ``G``:
vectors are ``[G, p]``, counters ``[G]``. One step of :func:`run_loop` takes
each row's argmin event and applies *all three* handlers, each under the mask
of the rows whose event is of its kind; rows that are done, at their event
budget or halted are masked out of everything, so no leaf of theirs changes.
State is updated **in place** (tensors of the :class:`CoreState` tuple are
mutated, the tuple itself is not rebuilt): every helper below takes the row
mask ``m`` it acts under and returns nothing.

**Types.** Everything is int32 and wraps as int32, except values that are
uint32 in the event semantics (PRNG lanes, seeds, the ``remote_prob``
threshold): torch has no shifts on uint32, so these are int64 tensors holding
0 .. 2**32-1 and every compare/modulo on them is therefore unsigned.

This loop is the plain version of the CUDA kernel in
``repro_torch.kernels.ws_sim``: the kernel is held against it leaf for leaf.

A *task model* supplies what the paper calls the task engine. It is a
hashable (frozen-dataclass) object implementing:

``static_arrays(device) -> tuple``
    the model's constant arrays (a DAG's durations and edges) as tensors on
    ``device``; built once per batch into :attr:`StaticTables.arrays`;
``init(scn, core) -> ms``
    patch the freshly built :class:`CoreState`, return the model state;
``on_idle / on_request / on_answer (tabs, scn, core, ms, ev, m)``
    the three event handlers, applied to the rows selected by ``m``;
    ``on_idle`` and ``on_answer`` return the mask of the rows whose
    processor must now steal, and :func:`run_loop` makes one
    :func:`start_stealing` call for both;
``on_steal(core, ms, ev, m)``
    after that call: what the model does once the new victim is known
    (the retry's trace row);
``results(core, ms)``
    fold the final state into the model's public result NamedTuple.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import topology as topo_mod
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device  # noqa: F401

INF32 = np.int32(2**31 - 1)

#: Version of the event-loop semantics. Bumped whenever a change alters any
#: result a simulation can produce (event ordering, PRNG, accounting); part
#: of the content-addressed key of the service result store
#: (``repro_torch.service.store``), so stale cached sweeps can never be
#: replayed against a newer engine.
ENGINE_VERSION = 2

# Processor states.
ACTIVE = 0
REQ_FLIGHT = 1
ANS_FLIGHT = 2

# Trace event kinds (log engine).
EV_IDLE = 0          # aux = 0
EV_REQ_FAIL = 1      # aux = victim
EV_REQ_OK = 2        # aux = victim (stolen amount recoverable from ANS_OK)
EV_ANS_FAIL = 3      # aux = next victim chosen
EV_ANS_OK = 4        # aux = stolen amount

I32 = torch.int32
I64 = torch.int64


class Scenario(NamedTuple):
    """Per-simulation parameters; every leaf is a ``[G]`` tensor (or 0-d for
    a single simulation).

    ``W`` is the divisible workload. ``max_events`` is a *per-scenario* event
    budget: the loop stops at ``min(model.max_events, scn.max_events)``
    events, so a row dispatched under a relaxed static cap reproduces its
    smaller-budget run bit for bit. ``INF32`` (the default) defers entirely
    to the model cap.
    """
    W: torch.Tensor            # int32 total unit tasks
    seed: torch.Tensor         # int64 holding the uint32 scenario seed
    lam_local: torch.Tensor    # int32 intra-cluster delay
    lam_remote: torch.Tensor   # int32 per-hop inter-cluster delay
    theta_static: torch.Tensor  # int32 steal-threshold constant
    theta_comm: torch.Tensor    # int32 steal-threshold per unit of distance
    remote_prob: torch.Tensor   # int64 holding the uint32 fixed-point P(remote)
    max_events: torch.Tensor    # int32 per-row event budget (INF32: model cap)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)


def _u32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.uint32).astype(np.int64),
                           device=device)


def make_scenario(W, seed, lam=1, lam_local=None, lam_remote=None,
                  theta_static=0, theta_comm=0, remote_prob=0.25,
                  max_events=None, device: DeviceLike = None) -> Scenario:
    """Convenience constructor. ``lam`` sets both latencies (one-cluster use)."""
    dev = resolve_device(device)
    ll = lam if lam_local is None else lam_local
    lr = lam if lam_remote is None else lam_remote
    budget = INF32 if max_events is None else max_events
    return Scenario(
        W=_i32(W, dev),
        seed=_u32(seed, dev),
        lam_local=_i32(ll, dev),
        lam_remote=_i32(lr, dev),
        theta_static=_i32(theta_static, dev),
        theta_comm=_i32(theta_comm, dev),
        remote_prob=_u32(topo_mod.remote_prob_u32(remote_prob), dev),
        max_events=_i32(budget, dev),
    )


def batch_scenarios(W, seeds, lam=1, device: DeviceLike = None,
                    **kw) -> Scenario:
    """Broadcast scalars against a seed vector into a batched Scenario."""
    dev = resolve_device(device)
    seeds = _u32(seeds, dev)
    n = seeds.shape[0]
    base = make_scenario(W, 0, lam=lam, device=dev, **kw)

    def bcast(x):
        return x.expand(n).contiguous() if x.ndim == 0 else x

    return Scenario(*(seeds if name == "seed" else bcast(leaf)
                      for name, leaf in zip(Scenario._fields, base)))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration shared by every task model."""
    topology: Topology
    mwt: bool = False                 # multiple work transfers (paper §2.4.1)
    max_events: int = 1 << 20
    log_trace: bool = False
    max_trace: int = 0                # rows kept when log_trace

    @property
    def p(self) -> int:
        return self.topology.p


class CoreState(NamedTuple):
    """Model-independent engine state (one pending event per processor),
    batched over ``G`` scenarios and mutated in place by the helpers."""
    t: torch.Tensor           # int32[G]
    state: torch.Tensor       # int32[G, p] ACTIVE / REQ_FLIGHT / ANS_FLIGHT
    idle_at: torch.Tensor     # int32[G, p] completion time of running work
    ev_time: torch.Tensor     # int32[G, p] the pending event per processor
    victim: torch.Tensor      # int32[G, p]
    stolen: torch.Tensor      # int32[G, p] in-flight payload (model-defined)
    busy_until: torch.Tensor  # int32[G, p] SWT answer-channel horizon
    rng: torch.Tensor         # int64[G, p] xorshift32 lanes (uint32 values)
    rr_aux: torch.Tensor      # int32[G, p] round-robin cursor
    idle_since: torch.Tensor  # int32[G, p]
    executed: torch.Tensor    # int32[G, p] work executed per processor
    active_count: torch.Tensor   # int32[G]
    n_events: torch.Tensor
    n_requests: torch.Tensor
    n_success: torch.Tensor
    n_fail: torch.Tensor
    total_idle: torch.Tensor
    startup_end: torch.Tensor  # first time all p procs active (-1: never)
    makespan: torch.Tensor
    done: torch.Tensor         # bool[G]
    halt: torch.Tensor         # bool[G] model-signaled abnormal stop
    trace: torch.Tensor        # int32[G, max_trace, 4] (t, proc, kind, aux)
    n_trace: torch.Tensor


class TaskModel:
    """Base class for task models: forwards static config from ``self.cfg``.

    Subclasses are frozen dataclasses with a single ``cfg`` field (hashable)
    implementing the hook methods documented in the module docstring.
    """

    @property
    def topology(self) -> Topology:
        return self.cfg.topology

    @property
    def p(self) -> int:
        return self.cfg.topology.p

    @property
    def mwt(self) -> bool:
        return self.cfg.mwt

    @property
    def max_events(self) -> int:
        return self.cfg.max_events

    @property
    def log_trace(self) -> bool:
        return getattr(self.cfg, "log_trace", False)

    @property
    def max_trace(self) -> int:
        return getattr(self.cfg, "max_trace", 0)

    def static_arrays(self, device) -> tuple:
        return ()


# ---------------------------------------------------------------------------
# Masked indexed access: x[g, idx[g]] reads and writes, one element per row.
# ---------------------------------------------------------------------------

class Event(NamedTuple):
    """The event each row handles in this step."""
    i: torch.Tensor      # int32[G] the processor whose event is earliest
    t: torch.Tensor      # int32[G] its time
    is_i: torch.Tensor   # bool[G, p] one-hot of i
    lane: torch.Tensor   # int32[1, p]

    def onehot(self, idx: torch.Tensor) -> torch.Tensor:
        return self.lane == idx.unsqueeze(1)


def at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[g, idx[g]]`` for every row g."""
    return x.gather(1, idx.to(I64).unsqueeze(1)).squeeze(1)


def assign(x: torch.Tensor, val, m: torch.Tensor) -> None:
    """``x[...] = val`` where ``m`` (same shape as x, or broadcastable val);
    in place. A tensor takes x's dtype on the way in: int64 -> int32 keeps
    the low bits, which is the wrap the engine wants."""
    if isinstance(val, torch.Tensor):
        torch.where(m, val.to(x.dtype), x, out=x)
    else:
        x.masked_fill_(m, val)


def put(x: torch.Tensor, onehot: torch.Tensor, val, m: torch.Tensor) -> None:
    """``x[g, idx[g]] = val[g]`` for the rows where ``m``, ``onehot`` being
    the one-hot of ``idx``; in place."""
    if isinstance(val, torch.Tensor):
        val = val.unsqueeze(1)
    assign(x, val, onehot & m.unsqueeze(1))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[g, idx[g]]`` with ``idx`` clamped into ``[0, x.shape[1])``: the
    reference's gathers clamp an index that is out of range, and a row
    outside a handler's mask may hold any index."""
    return at(x, idx.clamp(0, x.shape[1] - 1))


def store(x: torch.Tensor, idx: torch.Tensor, val, m: torch.Tensor) -> None:
    """``x[g, idx[g]] = val[g]`` for the rows where ``m``; in place, for a
    ``[G, n]`` tensor too wide for the one-hot of :func:`put`. ``idx`` is
    clamped; the rows outside ``m`` write back what they read."""
    i = idx.clamp(0, x.shape[1] - 1).to(I64).unsqueeze(1)
    cur = x.gather(1, i)
    if not isinstance(val, torch.Tensor):
        val = torch.full_like(cur, val)
    x.scatter_(1, i, torch.where(m.unsqueeze(1), val.to(x.dtype).view(-1, 1),
                                 cur))


def bump(x: torch.Tensor, val, m: torch.Tensor) -> None:
    """``x[g] += val[g]`` for the rows where ``m``; in place, wraps as x's
    dtype."""
    x.add_(torch.where(m, val, 0))


def first_true_monotone(le: torch.Tensor) -> torch.Tensor:
    """First index along dim 1 at which a *monotone* predicate turns true,
    given its complement ``le`` (true, ..., true, false, ..., false); 0 when
    it never does — the value an argmax over an all-false mask takes. Counting
    instead of calling argmax keeps the tie order out of the device's hands.
    """
    n = le.sum(dim=1, dtype=I32)
    return torch.where(n == le.shape[1], torch.zeros_like(n), n)


# ---------------------------------------------------------------------------
# Shared machinery: distance, victim selection, stealing, answers, logging.
# ---------------------------------------------------------------------------

class StaticTables(NamedTuple):
    """Per-batch constants on the batch's device."""
    cid: torch.Tensor      # int32[p]
    hops: torch.Tensor     # int32[p, p]
    lane: torch.Tensor     # int32[p] = arange(p)
    inv_cum: Optional[torch.Tensor]  # float32[G, p, p] INV_DISTANCE prefix sums
    arrays: tuple = ()     # the model's static_arrays(device)


def dist(tabs: StaticTables, scn: Scenario, i, j) -> torch.Tensor:
    """Distance d(i, j) per row under the scenario's latency scalars."""
    i64, j64 = i.to(I64), j.to(I64)
    same = tabs.cid[i64] == tabs.cid[j64]
    d = torch.where(same, scn.lam_local, scn.lam_remote * tabs.hops[i64, j64])
    return torch.where(i == j, torch.zeros_like(d), d)


def inv_distance_table(cid, hops, scn: Scenario) -> torch.Tensor:
    """``c[g, i, :]``: the float32 prefix sums of the INV_DISTANCE weights
    ``1 / max(d(i, j), 1)`` (0 at j == i) for every thief i.

    The weights depend only on the row's latency scalars and on i, never on
    the running state, so they are summed once per batch. The sum runs
    **left to right, one lane at a time**, in float32: a parallel scan (what
    ``torch.cumsum`` is on a GPU) associates differently and flips victims.
    """
    p = cid.shape[0]
    same = cid.unsqueeze(1) == cid.unsqueeze(0)                       # [p, p]
    ll = scn.lam_local.view(-1, 1, 1)
    lr = scn.lam_remote.view(-1, 1, 1)
    d = torch.where(same.unsqueeze(0), ll, lr * hops.unsqueeze(0))    # int32
    d = d.to(torch.float32)
    w = 1.0 / torch.clamp(d, min=1.0)
    eye = torch.eye(p, dtype=torch.bool, device=cid.device)
    w = torch.where(eye.unsqueeze(0), torch.zeros_like(w), w)
    c = torch.empty_like(w)
    acc = torch.zeros_like(w[:, :, 0])
    for j in range(p):
        acc = acc + w[:, :, j]
        c[:, :, j] = acc
    return c


def select_victim(strategy: int, p: int, tabs: StaticTables, scn: Scenario,
                  rng_i, rr_i, i):
    """Victim selection (topology engine §3.3) for every row at once;
    returns (victim int32[G], rng' int64[G], rr' int32[G])."""
    if strategy == topo_mod.UNIFORM:
        rng_i = topo_mod.xorshift32(rng_i)
        v = (rng_i % (p - 1)).to(I32)
        v = v + (v >= i).to(I32)
        return v, rng_i, rr_i
    if strategy == topo_mod.LOCAL_FIRST:
        rng_i = topo_mod.xorshift32(rng_i)
        go_remote = rng_i < scn.remote_prob
        rng_i = topo_mod.xorshift32(rng_i)
        my = tabs.cid[i.to(I64)].unsqueeze(1)
        cid = tabs.cid.unsqueeze(0)
        local_mask = (cid == my) & (tabs.lane.unsqueeze(0) != i.unsqueeze(1))
        remote_mask = cid != my
        mask = torch.where(go_remote.unsqueeze(1), remote_mask, local_mask)
        n = mask.sum(dim=1).clamp(min=1)                      # int64
        k = (rng_i % n).unsqueeze(1)
        csum = torch.cumsum(mask.to(I64), dim=1)              # exact: integers
        v = first_true_monotone(csum <= k)
        v = torch.where(v == i, (i + 1) % p, v)  # only if both masks empty
        return v, rng_i, rr_i
    if strategy == topo_mod.INV_DISTANCE:
        G = i.shape[0]
        c = tabs.inv_cum[torch.arange(G, device=i.device), i.to(I64)]  # [G, p]
        rng_i = topo_mod.xorshift32(rng_i)
        u = (rng_i.to(torch.float32) / float(2**32)) * c[:, -1]
        v = first_true_monotone(c <= u.unsqueeze(1))
        v = torch.where(v == i, (i + 1) % p, v)
        return v, rng_i, rr_i
    if strategy == topo_mod.ROUND_ROBIN:
        nxt = (rr_i + 1) % p
        nxt = torch.where(nxt == i, (nxt + 1) % p, nxt)
        return nxt, rng_i, nxt
    raise ValueError(f"unknown strategy {strategy}")


def start_stealing(model: TaskModel, tabs: StaticTables, scn: Scenario,
                   core: CoreState, ev: Event, m) -> None:
    """processor engine start_stealing(): pick victim, emit request event."""
    i, t = ev.i, ev.t
    strategy = model.topology.strategy
    v, rng_i, rr_i = select_victim(strategy, model.p, tabs, scn,
                                   at(core.rng, i), at(core.rr_aux, i), i)
    d = dist(tabs, scn, i, v)
    put(core.state, ev.is_i, REQ_FLIGHT, m)
    put(core.victim, ev.is_i, v, m)
    put(core.ev_time, ev.is_i, t + d, m)
    if strategy == topo_mod.ROUND_ROBIN:
        put(core.rr_aux, ev.is_i, rr_i, m)   # the only strategy that moves it
    else:
        put(core.rng, ev.is_i, rng_i, m)     # round robin draws nothing


def enter_idle(core: CoreState, ev: Event, m) -> None:
    """Bookkeeping when processor i runs out of work (before it steals)."""
    bump(core.active_count, -1, m)
    put(core.idle_since, ev.is_i, ev.t, m)


def chan_free(model: TaskModel, core: CoreState, v, t) -> torch.Tensor:
    """SWT/MWT answer-channel policy (paper §2.4.1): under SWT a victim
    refuses while a previous answer is still in flight."""
    if model.mwt:
        return torch.ones_like(t, dtype=torch.bool)
    return t >= at(core.busy_until, v)


def steal_threshold(scn: Scenario, d_vi) -> torch.Tensor:
    """Steal threshold of §2.4.2: θ_static + θ_comm · d(v, i)."""
    return scn.theta_static + scn.theta_comm * d_vi


def deliver_answer(core: CoreState, ev: Event, is_v, d_vi, ok, payload,
                   m) -> None:
    """Answer bookkeeping shared by every model's on_request: occupy the
    victim's answer channel on success, put ``payload`` in flight toward the
    thief, and account the request."""
    arrive = ev.t + d_vi
    put(core.busy_until, is_v, arrive, m & ok)
    put(core.stolen, ev.is_i, payload, m)
    put(core.state, ev.is_i, ANS_FLIGHT, m)
    put(core.ev_time, ev.is_i, arrive, m)
    bump(core.n_requests, 1, m)
    bump(core.n_success, 1, m & ok)
    bump(core.n_fail, 1, m & ~ok)


def acquire_work(model: TaskModel, core: CoreState, ev: Event, end, exec_add,
                 stolen_reset, m) -> None:
    """Thief i becomes ACTIVE until ``end``: shared part of every model's
    successful on_answer (idle-time and startup accounting)."""
    i, t = ev.i, ev.t
    new_active = core.active_count + 1
    first_full = (new_active == model.p) & (core.startup_end < 0)
    put(core.state, ev.is_i, ACTIVE, m)
    put(core.idle_at, ev.is_i, end, m)
    put(core.ev_time, ev.is_i, end, m)
    put(core.stolen, ev.is_i, stolen_reset, m)
    put(core.executed, ev.is_i, at(core.executed, i) + exec_add, m)
    bump(core.active_count, 1, m)
    bump(core.total_idle, t - at(core.idle_since, i), m)
    assign(core.startup_end, t, m & first_full)


def finish(model: TaskModel, core: CoreState, t, idle_now, m) -> None:
    """Terminate: freeze the event vector and account terminal idle time
    (``idle_now`` is the model's int32[G, p] per-processor idle
    contribution)."""
    core.done.logical_or_(m)
    assign(core.makespan, t, m)
    core.ev_time.masked_fill_(m.unsqueeze(1), int(INF32))
    bump(core.total_idle, idle_now.sum(dim=1, dtype=I32), m)


def log(model: TaskModel, core: CoreState, t, proc, kind, aux, m) -> None:
    """Append one row to the trace ring (log engine); no-op when disabled.
    Rows stop at ``max_trace`` and ``n_trace`` saturates there."""
    if not model.log_trace:
        return
    G = t.shape[0]
    as_i32 = lambda x: torch.as_tensor(x, dtype=I32, device=t.device).expand(G)
    row = torch.stack([t, proc, as_i32(kind), as_i32(aux)], dim=1)    # [G, 4]
    keep = m & (core.n_trace < model.max_trace)
    slot = torch.arange(core.trace.shape[1], dtype=I32, device=t.device)
    here = (slot.unsqueeze(0) == core.n_trace.unsqueeze(1)) & keep.unsqueeze(1)
    torch.where(here.unsqueeze(2), row.unsqueeze(1), core.trace,
                out=core.trace)
    bump(core.n_trace, 1, keep)


# ---------------------------------------------------------------------------
# The event loop.
# ---------------------------------------------------------------------------

def init_core(model: TaskModel, scn: Scenario) -> CoreState:
    """Generic initial state; the model patches proc 0 (all work starts
    there) and its own payload conventions in ``init``."""
    p = model.p
    G = scn.W.shape[0]
    dev = scn.W.device
    lanes = torch.arange(p, dtype=I64, device=dev)
    rng = topo_mod.seed_state(scn.seed.unsqueeze(1), lanes.unsqueeze(0))
    max_trace = max(model.max_trace, 1) if model.log_trace else 1

    def vec(fill=0):
        return torch.full((G, p), fill, dtype=I32, device=dev)

    def scalar(fill=0, dtype=I32):
        return torch.full((G,), fill, dtype=dtype, device=dev)

    return CoreState(
        t=scalar(),
        state=vec(ACTIVE),
        idle_at=vec(),
        ev_time=vec(),
        victim=vec(),
        stolen=vec(),
        busy_until=vec(),
        rng=rng,
        rr_aux=lanes.to(I32).unsqueeze(0).expand(G, p).contiguous(),
        idle_since=vec(),
        executed=vec(),
        active_count=scalar(p),
        n_events=scalar(),
        n_requests=scalar(),
        n_success=scalar(),
        n_fail=scalar(),
        total_idle=scalar(),
        startup_end=scalar(-1),
        makespan=scalar(-1),
        done=scalar(False, torch.bool),
        halt=scalar(False, torch.bool),
        trace=torch.zeros((G, max_trace, 4), dtype=I32, device=dev),
        n_trace=scalar(),
    )


def static_tables(model: TaskModel, scn: Scenario) -> StaticTables:
    dev = scn.W.device
    topo = model.topology
    cid = torch.as_tensor(np.asarray(topo.cluster_id, np.int32), device=dev)
    hops = torch.as_tensor(np.asarray(topo.hops, np.int32), device=dev)
    inv_cum = (inv_distance_table(cid, hops, scn)
               if topo.strategy == topo_mod.INV_DISTANCE else None)
    return StaticTables(cid, hops,
                        torch.arange(model.p, dtype=I32, device=dev), inv_cum,
                        model.static_arrays(dev))


class Loop(NamedTuple):
    """The state of a batched event loop between steps: everything a row of
    the batch owns (``scn``, ``core``, ``ms``, ``budget`` and the per-row
    table ``tabs.inv_cum``) has a leading G axis."""
    tabs: StaticTables
    scn: Scenario
    core: CoreState
    ms: tuple
    budget: torch.Tensor    # int32[G] min(scenario budget, model cap)


def start_loop(model: TaskModel, scn: Scenario) -> Loop:
    """A fresh loop over the ``[G]`` scenario leaves."""
    tabs = static_tables(model, scn)
    core = init_core(model, scn)
    ms = model.init(scn, core)
    # Per-row event budget: the static model cap bounds every row, the
    # scenario budget truncates each row on its own.
    budget = torch.clamp(scn.max_events, max=int(min(model.max_events,
                                                     int(INF32))))
    return Loop(tabs, scn, core, ms, budget)


def finished(loop: Loop) -> torch.Tensor:
    """bool[G]: the rows that will run no further event."""
    c = loop.core
    return c.done | (c.n_events >= loop.budget) | c.halt


def advance(model: TaskModel, loop: Loop, max_steps: Optional[int] = None
            ) -> int:
    """Run the loop's rows until each is finished or, with ``max_steps``,
    has run that many further events; returns the steps taken (the batch's
    iterations, which is the most events a row ran).

    A step takes each row's argmin event and applies *all three* handlers,
    each under the mask of the rows whose event is of its kind; a row outside
    the live mask changes no leaf. Every live row runs one event a step, so
    a per-row segment budget of ``max_steps`` is the step count itself.
    """
    p = model.p
    tabs, scn, core, ms = loop.tabs, loop.scn, loop.core, loop.ms
    lane = tabs.lane.unsqueeze(0)
    lane64 = lane.to(I64)
    steps = 0
    while max_steps is None or steps < max_steps:
        live = ~finished(loop)
        if not bool(live.any()):
            break
        steps += 1
        # Lexicographic (time, lane) minimum: ties break to the lowest lane
        # whatever the device's argmin does. Exact for every int32 time and
        # p <= 2**31.
        key = core.ev_time.to(I64) * p + lane64
        i = (key.min(dim=1).values % p).to(I32)
        t = at(core.ev_time, i)
        ev = Event(i, t, lane == i.unsqueeze(1), lane)
        assign(core.t, t, live)
        bump(core.n_events, 1, live)
        st = at(core.state, i)
        # A row's event has exactly one kind, and a handler touches only the
        # rows of its mask, so the order of the three calls is immaterial —
        # and the steal that an idle event or an empty answer ends in can be
        # one call for both.
        steal = model.on_idle(tabs, scn, core, ms, ev, live & (st == ACTIVE))
        model.on_request(tabs, scn, core, ms, ev, live & (st == REQ_FLIGHT))
        retry = model.on_answer(tabs, scn, core, ms, ev,
                                live & (st == ANS_FLIGHT))
        start_stealing(model, tabs, scn, core, ev, steal | retry)
        model.on_steal(core, ms, ev, retry)
    return steps


def run_loop(model: TaskModel, scn: Scenario):
    """The batched event loop over ``[G]`` scenario leaves (see the module
    docstring); returns the model's result NamedTuple with a leading G axis.
    """
    loop = start_loop(model, scn)
    advance(model, loop)
    return model.results(loop.core, loop.ms)


#: ``inv_distance_table`` holds G * p * p floats; batches are split so that it
#: stays under this many elements.
_INV_TABLE_MAX_ELEMS = 1 << 26


def batch_rows(model: TaskModel, G: int) -> int:
    """The most rows of one loop: ``G``, or fewer where the INV_DISTANCE
    table would pass :data:`_INV_TABLE_MAX_ELEMS`."""
    if model.topology.strategy == topo_mod.INV_DISTANCE:
        return min(G, max(1, _INV_TABLE_MAX_ELEMS // (model.p * model.p)))
    return G


def split_rows(scn: Scenario, rows: int) -> list:
    """``scn`` cut into consecutive batches of at most ``rows`` rows."""
    G = int(scn.W.shape[0])
    return [Scenario(*(x[lo:lo + rows] for x in scn))
            for lo in range(0, G, rows)]


def cat_results(parts: list):
    """One result NamedTuple from several, concatenated along the rows."""
    return type(parts[0])(*(torch.cat(leaves) for leaves in zip(*parts)))


def simulate_batch(model: TaskModel, scn: Scenario):
    """Run a batch: every leaf of ``scn`` has a leading batch axis. Runs on
    the device the scenario's tensors lie on."""
    G = int(scn.W.shape[0])
    rows = batch_rows(model, G)
    if G <= rows:
        return run_loop(model, scn)
    return cat_results([run_loop(model, part)
                        for part in split_rows(scn, rows)])


def simulate(model: TaskModel, scn: Scenario):
    """Run one simulation: every leaf of ``scn`` is 0-d."""
    res = simulate_batch(model, Scenario(*(x.reshape(1) for x in scn)))
    return type(res)(*(x[0] for x in res))


# ---------------------------------------------------------------------------
# Segmented execution: the same event loop (:func:`advance`), cut into
# segments of at most ``seg_len`` events a row, with the finished rows
# harvested between segments and the batch compacted to a power of two.
#
# The plain loop steps every row of its batch until the last row is done, so
# a batch costs n_rows x max(events) row-steps instead of sum(events). Between
# segments the host takes the finished rows out and gathers the survivors
# into a smaller batch. Each row's event sequence is untouched (the step is
# :func:`advance`'s, and rows are independent), so the results are
# bit-identical to :func:`simulate_batch` and the statistics
# (:class:`SegmentStats`) equal the JAX package's segmented driver's on the
# same rows and segment length.
# ---------------------------------------------------------------------------


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def default_segment_len(max_events: int, ev_budget=None) -> int:
    """Segment length for the segmented driver, derived from the static
    model cap and (when present) the per-row event budgets: small caps run
    as a single exact segment, large caps use short segments so finished
    lanes are harvested (and the batch compacted) long before the stragglers
    finish."""
    base = int(max_events)
    if ev_budget is not None:
        b = np.asarray(ev_budget, np.int64)
        pos = b[b > 0]
        if pos.size:
            base = int(min(base, int(pos.min())))
    return int(max(32, min(128, _pow2ceil(base))))


@dataclasses.dataclass
class SegmentStats:
    """Telemetry of one segmented run (the wasted-lane accounting the
    backend-matrix bench reports)."""
    n_segments: int = 0
    n_compactions: int = 0
    lane_cycles: int = 0      # sum over segments of batch_width * iterations
    events_executed: int = 0  # useful events actually run
    max_width: int = 0
    final_width: int = 0

    @property
    def wasted_frac(self) -> float:
        """Fraction of lane-iterations spent on finished/padded lanes."""
        if self.lane_cycles <= 0:
            return 0.0
        return 1.0 - self.events_executed / self.lane_cycles

    def merge(self, other: "SegmentStats") -> "SegmentStats":
        return SegmentStats(
            n_segments=self.n_segments + other.n_segments,
            n_compactions=self.n_compactions + other.n_compactions,
            lane_cycles=self.lane_cycles + other.lane_cycles,
            events_executed=self.events_executed + other.events_executed,
            max_width=max(self.max_width, other.max_width),
            final_width=max(self.final_width, other.final_width))


_sanitize_impl = None


def _sanitize(site: str, **ctx):
    """Lazy bridge to the opt-in determinism sanitizer
    (``repro_torch.check.sanitizer.probe``), the same shape as the bridges in
    ``core/backend.py``: core never imports the checker at module level, and
    a disabled probe costs one env read per segment."""
    global _sanitize_impl
    if _sanitize_impl is None:
        from repro_torch.check.sanitizer import probe
        _sanitize_impl = probe
    return _sanitize_impl(site, **ctx)


def _gather_loop(loop: Loop, gidx: torch.Tensor, n_real: int) -> Loop:
    """Rows ``gidx`` of every per-row leaf of the loop (the scenario, the
    core and model state, the budgets, the INV_DISTANCE table), in one
    gather each; positions >= ``n_real`` are padding (copies of a row) and
    are marked done, so they never run another event."""
    def take(x):
        return x.index_select(0, gidx)

    core = CoreState(*(take(x) for x in loop.core))
    core.done[n_real:] = True
    tabs = loop.tabs
    if tabs.inv_cum is not None:
        tabs = tabs._replace(inv_cum=take(tabs.inv_cum))
    return Loop(tabs, Scenario(*(take(x) for x in loop.scn)), core,
                type(loop.ms)(*(take(x) for x in loop.ms)),
                take(loop.budget))


class SegmentedRun:
    """Host-side driver of one segmented batched simulation, on the device
    of its scenario.

    ``step()`` runs one segment and harvests the rows it finished; when the
    count of survivors drops to half a power of two below the current batch
    width, the batch is compacted (gathered into a dense pow2 prefix, the
    padding rows marked done). Drive to completion with
    :func:`simulate_segmented`, or interleave several runs via
    :func:`run_segmented_chunks`. ``loop`` is the live batch, ``idx`` its
    rows' original positions (-1: harvested or padding).
    """

    def __init__(self, model: TaskModel, scn: Scenario,
                 seg_len: Optional[int] = None):
        n = int(scn.W.shape[0])
        if n == 0:
            raise ValueError("segmented run needs at least one scenario row")
        if seg_len is None:
            seg_len = default_segment_len(model.max_events)
        self.model = model
        self.seg_len = int(seg_len)
        self.loop = start_loop(model, scn)
        self.idx = np.arange(n)
        self.n = n
        self._parts: list = []
        self._part_idx: list = []
        self.stats = SegmentStats(max_width=n, final_width=n)
        self.done = False

    def step(self):
        """Run one segment; harvest finished rows; maybe compact.

        A segment boundary is where the engine's span (``engine.segment``)
        and metrics land."""
        if self.done:
            return
        with obs.span("engine.segment", width=len(self.idx),
                      seg_len=self.seg_len) as sp:
            self._step(sp)
        m = obs.REGISTRY
        m.counter("engine.segments").inc()
        if self.done:
            m.counter("engine.lane_cycles").inc(self.stats.lane_cycles)
            m.counter("engine.events_executed").inc(
                self.stats.events_executed)
            m.gauge("engine.wasted_frac").set(
                round(self.stats.wasted_frac, 4))

    def _step(self, sp):
        loop = self.loop
        before = loop.core.n_events.clone()
        k_max = advance(self.model, loop, self.seg_len)
        fin_d = finished(loop)
        k_sum = (loop.core.n_events - before).sum(dtype=I64)
        # the one read of a segment: the finished mask and the events run
        host = torch.cat([fin_d.to(I64), k_sum.view(1)]).cpu().numpy()
        fin = host[:-1].astype(bool)
        width = fin.shape[0]
        self.stats.n_segments += 1
        self.stats.lane_cycles += width * k_max
        self.stats.events_executed += int(host[-1])
        # Sanitizer tick: idx still maps every lane to its original row
        # (harvest below rewrites it), the state is post-segment: the
        # boundary the monotonicity/conservation invariants quantify over.
        _sanitize("engine.segment", run=self, fin=fin)
        real = self.idx >= 0
        newly = fin & real
        if newly.any():
            res = self.model.results(loop.core, loop.ms)
            pick = torch.as_tensor(newly, device=fin_d.device)
            self._parts.append(type(res)(*(x[pick] for x in res)))
            self._part_idx.append(self.idx[newly])
            self.idx = np.where(newly, -1, self.idx)
            real = self.idx >= 0
        sp.set(n_finished=int(newly.sum()))
        k = int(real.sum())
        if k == 0:
            self.done = True
            return
        new_width = _pow2ceil(k)
        if new_width <= width // 2:
            keep = np.flatnonzero(real)
            gidx = np.concatenate([keep, np.zeros(new_width - k, np.int64)])
            self.loop = _gather_loop(
                loop, torch.as_tensor(gidx, device=fin_d.device), k)
            self.idx = np.concatenate(
                [self.idx[keep], np.full(new_width - k, -1)])
            self.stats.n_compactions += 1
            self.stats.final_width = new_width
            sp.set(compacted_to=new_width)
            obs.REGISTRY.counter("engine.compactions").inc()

    def result(self):
        """The model's result NamedTuple, rows in their original order, on
        the scenario's device."""
        if not self.done:
            raise RuntimeError("segmented run not finished; call step()")
        order = np.argsort(np.concatenate(self._part_idx), kind="stable")
        res = cat_results(self._parts)
        pick = torch.as_tensor(order, device=res.makespan.device)
        return type(res)(*(x[pick] for x in res))


def simulate_segmented(model: TaskModel, scn: Scenario,
                       seg_len: Optional[int] = None):
    """Segmented batched simulation -> (results, :class:`SegmentStats`).

    Bit-identical to :func:`simulate_batch` on the same scenario batch
    (``tests/test_torch_segmented.py`` holds both, and the statistics, to the
    JAX package's ``simulate_segmented``)."""
    run = SegmentedRun(model, scn, seg_len=seg_len)
    while not run.done:
        run.step()
    return run.result(), run.stats


def run_segmented_chunks(model: TaskModel, scns, seg_len: Optional[int] = None):
    """Drive one :class:`SegmentedRun` per scenario chunk (each on the device
    its tensors lie on) with round-robin stepping, so each device's next
    segment is issued while the others still compute. Returns (results
    list, stats list)."""
    runs = [SegmentedRun(model, s, seg_len=seg_len) for s in scns]
    while True:
        live = [r for r in runs if not r.done]
        if not live:
            break
        for r in live:
            r.step()
    return [r.result() for r in runs], [r.stats for r in runs]
