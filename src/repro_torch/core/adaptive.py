"""Adaptive-task task model (paper §2.1.3) over the unified event core, as
plain batched PyTorch.

The whole workload starts as one big task on processor 0. A successful steal
*splits* the victim's running task: the thief receives half the remaining
work as a new task, and a **merge task** is created that becomes ready when
both halves complete (``pred = 2``); its processing time is
``merge_alpha + merge_beta · stolen``. Merge tasks are pushed to the deque of
the processor that completed their second predecessor, can be stolen like DAG
tasks, but cannot themselves be split. Each split chains the victim's
merge-parent pointer, so the merges form the binary "bring together" tree of
prefix-style adaptive algorithms.

Event machinery, victim selection, SWT/MWT and steal-threshold semantics are
shared through ``repro_torch.core.engine``; this module defines only the
adaptive :class:`TaskModel` and its public types. The simulation ends when
the number of *created* tasks equals the number of *completed* tasks.

Batched form: the task pool ``tdur/mpar/tpred/is_merge`` is ``[G, pool_cap]``,
the deques ``[G, p, deque_cap]``. A pool that is full refuses further splits
(not an overflow); a push at ``tail == deque_cap`` sets ``halt``.

Work/time are int32; bit-exact against
``repro_torch.core.oracle.simulate_adaptive_oracle`` wherever no cap binds,
and field for field against the JAX package's adaptive model everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import engine as eng
from repro_torch.core.engine import (ACTIVE, EV_ANS_FAIL, EV_ANS_OK, EV_IDLE,
                                     EV_REQ_FAIL, EV_REQ_OK, I32, Scenario)
from repro_torch.core.topology import Topology


class AdaptiveSimResult(NamedTuple):
    makespan: torch.Tensor
    n_events: torch.Tensor
    n_requests: torch.Tensor
    n_success: torch.Tensor
    n_fail: torch.Tensor
    n_splits: torch.Tensor       # successful splits (== merge tasks created)
    total_idle: torch.Tensor
    startup_end: torch.Tensor
    executed: torch.Tensor       # int32[p]
    total_merge_work: torch.Tensor
    n_created: torch.Tensor
    n_completed: torch.Tensor
    overflow: torch.Tensor
    trace: torch.Tensor          # int32[max_trace, 4] (t, proc, kind, aux)
    n_trace: torch.Tensor


class AdaptiveState(NamedTuple):
    """Per-model state, batched over G and mutated in place."""
    cur_task: torch.Tensor     # int32[G, p] pool id; -1 none
    # task pool
    tdur: torch.Tensor         # int32[G, cap] merge dur / thief-task size
    mpar: torch.Tensor         # int32[G, cap] merge parent (-1 root)
    tpred: torch.Tensor        # int32[G, cap] remaining preds (merges: 2)
    is_merge: torch.Tensor     # bool[G, cap]
    next_free: torch.Tensor    # int32[G]
    # deques (ready merge tasks)
    buf: torch.Tensor          # int32[G, p, deque_cap]
    head: torch.Tensor         # int32[G, p]
    tail: torch.Tensor         # int32[G, p]
    # counters
    n_created: torch.Tensor
    n_completed: torch.Tensor
    n_splits: torch.Tensor
    total_merge_work: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaptiveEngineConfig:
    topology: Topology
    mwt: bool = False
    merge_alpha: int = 1          # merge dur = alpha + beta * stolen_size
    merge_beta_num: int = 0       # beta as a rational num/den (int arithmetic)
    merge_beta_den: int = 16
    pool_cap: int = 4096          # >= 1 + 2 * max_splits
    deque_cap: int = 256
    max_events: int = 1 << 20
    log_trace: bool = False
    max_trace: int = 0

    @property
    def p(self) -> int:
        return self.topology.p

    def merge_dur(self, s: torch.Tensor) -> torch.Tensor:
        """``alpha + (s * beta_num) // beta_den`` in int32, wrapping, with a
        floor division."""
        return self.merge_alpha + torch.div(
            s.to(I32) * self.merge_beta_num, self.merge_beta_den,
            rounding_mode="floor").to(I32)


@dataclasses.dataclass(frozen=True)
class AdaptiveModel(eng.TaskModel):
    """Adaptive task engine: splittable work + a binary merge-task tree."""
    cfg: AdaptiveEngineConfig

    def init(self, scn: Scenario, core: eng.CoreState) -> AdaptiveState:
        G, p = core.state.shape
        dev = core.state.device
        cap = self.cfg.pool_cap
        core.idle_at[:, 0] = scn.W
        core.ev_time.copy_(core.idle_at)
        core.stolen.fill_(-1)
        core.executed[:, 0] = scn.W

        def full(shape, fill):
            return torch.full(shape, fill, dtype=I32, device=dev)

        cur = full((G, p), -1)
        cur[:, 0] = 0
        tdur = full((G, cap), 0)
        tdur[:, 0] = scn.W
        return AdaptiveState(
            cur_task=cur, tdur=tdur, mpar=full((G, cap), -1),
            tpred=full((G, cap), 0),
            is_merge=torch.zeros((G, cap), dtype=torch.bool, device=dev),
            next_free=full((G,), 1),
            buf=full((G, p, self.cfg.deque_cap), 0),
            head=full((G, p), 0), tail=full((G, p), 0),
            n_created=full((G,), 1), n_completed=full((G,), 0),
            n_splits=full((G,), 0), total_merge_work=full((G,), 0))

    def _complete_task(self, core, ms: AdaptiveState, ev, c, m):
        """Task c completes on proc i: decrement its merge parent and push
        the parent to i's deque tail once both halves are done (a push at
        capacity halts the row)."""
        eng.bump(ms.n_completed, 1, m)
        par = eng.take(ms.mpar, c)
        has_parent = m & (par >= 0)
        pc = eng.take(ms.tpred, par) - 1
        eng.store(ms.tpred, par, pc, has_parent)
        ready = has_parent & (pc == 0)
        cap = self.cfg.deque_cap
        tl = eng.at(ms.tail, ev.i)
        ok = tl < cap
        flat = ms.buf.view(ms.buf.shape[0], -1)
        eng.store(flat, ev.i * cap + tl, par, ready & ok)
        eng.put(ms.tail, ev.is_i, tl + 1, ready & ok)
        core.halt.logical_or_(ready & ~ok)

    def on_idle(self, tabs, scn, core, ms: AdaptiveState, ev, m):
        """idle event: the running task completes; then finish, pop a ready
        merge (LIFO), or steal. Returns the rows that steal."""
        i, t = ev.i, ev.t
        c = eng.at(ms.cur_task, i)
        self._complete_task(core, ms, ev, c, m & (c >= 0))
        eng.put(ms.cur_task, ev.is_i, -1, m)

        finished = m & (ms.n_completed >= ms.n_created)
        idle_now = torch.where((ms.cur_task >= 0) | ev.is_i, 0,
                               t.unsqueeze(1) - core.idle_since)
        eng.finish(self, core, t, idle_now, finished)

        go = m & ~finished
        tl = eng.at(ms.tail, i)
        empty = eng.at(ms.head, i) >= tl
        pop = go & ~empty
        flat = ms.buf.view(ms.buf.shape[0], -1)
        task = eng.take(flat, i * self.cfg.deque_cap + tl - 1)
        d = eng.take(ms.tdur, task)
        end = t + d
        eng.put(ms.tail, ev.is_i, tl - 1, pop)
        eng.put(ms.cur_task, ev.is_i, task, pop)
        eng.put(core.idle_at, ev.is_i, end, pop)
        eng.put(core.ev_time, ev.is_i, end, pop)
        eng.put(core.executed, ev.is_i, eng.at(core.executed, i) + d, pop)

        steal = go & empty
        eng.enter_idle(core, ev, steal)
        eng.log(self, core, t, i, EV_IDLE, 0, steal)
        return steal

    def on_request(self, tabs, scn, core, ms: AdaptiveState, ev, m):
        """steal request reaches victim v, in priority order: the head of
        v's deque; else a split of v's running work task; else fail."""
        i, t = ev.i, ev.t
        v = eng.at(core.victim, i)
        is_v = ev.onehot(v)
        d_vi = eng.dist(tabs, scn, v, i)
        free = eng.chan_free(self, core, v, t)

        hd = eng.at(ms.head, v)
        can_queue = ((eng.at(ms.tail, v) - hd) > 0) & free

        c_v = eng.at(ms.cur_task, v)
        running_work = ((eng.at(core.state, v) == ACTIVE) & (c_v >= 0)
                        & ~eng.take(ms.is_merge, c_v))
        w_v = torch.where(running_work, eng.at(core.idle_at, v) - t, 0)
        thr = eng.steal_threshold(scn, d_vi)
        amt = torch.div(w_v, 2, rounding_mode="floor")
        room = ms.next_free + 2 <= self.cfg.pool_cap
        can_split = running_work & (amt >= 1) & (w_v > thr) & free & room

        # queue steal
        q = m & can_queue
        flat = ms.buf.view(ms.buf.shape[0], -1)
        task = eng.take(flat, v * self.cfg.deque_cap + hd)
        eng.put(ms.head, is_v, hd + 1, q)

        # split: the thief gets amt as a new task, a merge joins the halves
        s = m & ~can_queue & can_split
        m_id = ms.next_free
        t_id = m_id + 1
        mdur = self.cfg.merge_dur(amt)
        par_v = eng.take(ms.mpar, c_v)            # read before it is written
        eng.store(ms.tdur, m_id, mdur, s)
        eng.store(ms.tdur, t_id, amt, s)
        eng.store(ms.mpar, m_id, par_v, s)
        eng.store(ms.mpar, t_id, m_id, s)
        eng.store(ms.mpar, c_v, m_id, s)
        eng.store(ms.tpred, m_id, 2, s)
        eng.store(ms.tpred, t_id, 0, s)
        eng.store(ms.is_merge, m_id, True, s)
        eng.store(ms.is_merge, t_id, False, s)
        eng.bump(ms.next_free, 2, s)
        eng.bump(ms.n_created, 2, s)
        eng.bump(ms.n_splits, 1, s)
        eng.bump(ms.total_merge_work, mdur, s)
        new_idle_v = t + (w_v - amt)
        eng.put(core.idle_at, is_v, new_idle_v, s)
        eng.put(core.ev_time, is_v, new_idle_v, s)
        eng.put(core.executed, is_v, eng.at(core.executed, v) - amt, s)

        ok = can_queue | can_split
        payload = torch.where(can_queue, task, torch.where(can_split, t_id, -1))
        eng.deliver_answer(core, ev, is_v, d_vi, ok, payload, m)
        if self.log_trace:
            eng.log(self, core, t, i, torch.where(ok, EV_REQ_OK, EV_REQ_FAIL),
                    v, m)

    def on_answer(self, tabs, scn, core, ms: AdaptiveState, ev, m):
        """the (possibly empty) answer reaches thief i. Returns the rows
        where i must steal again."""
        i, t = ev.i, ev.t
        task = eng.at(core.stolen, i)
        ok = task >= 0
        got = m & ok
        d = eng.take(ms.tdur, task)
        eng.acquire_work(self, core, ev, t + d, d, -1, got)
        eng.put(ms.cur_task, ev.is_i, task, got)
        eng.log(self, core, t, i, EV_ANS_OK, task, got)
        return m & ~ok

    def on_steal(self, core, ms, ev, retry):
        """After start_stealing: the retry logs the victim chosen just now."""
        if self.log_trace:
            eng.log(self, core, ev.t, ev.i, EV_ANS_FAIL,
                    eng.at(core.victim, ev.i), retry)

    def results(self, core: eng.CoreState,
                ms: AdaptiveState) -> AdaptiveSimResult:
        return AdaptiveSimResult(
            makespan=core.makespan, n_events=core.n_events,
            n_requests=core.n_requests, n_success=core.n_success,
            n_fail=core.n_fail, n_splits=ms.n_splits,
            total_idle=core.total_idle, startup_end=core.startup_end,
            executed=core.executed, total_merge_work=ms.total_merge_work,
            n_created=ms.n_created, n_completed=ms.n_completed,
            overflow=(~core.done) | core.halt,
            trace=core.trace, n_trace=core.n_trace,
        )


def simulate_adaptive(cfg: AdaptiveEngineConfig,
                      scn: Scenario) -> AdaptiveSimResult:
    """Run one simulation on the device of ``scn``."""
    return eng.simulate(AdaptiveModel(cfg), scn)


def simulate_adaptive_batch(cfg: AdaptiveEngineConfig,
                            scn: Scenario) -> AdaptiveSimResult:
    """Run a batch: every leaf of ``scn`` has a leading batch axis."""
    return eng.simulate_batch(AdaptiveModel(cfg), scn)
