"""DAG-of-tasks task model (paper §2.1.2) over the unified event core, as
plain batched PyTorch.

Each processor keeps a deque of *activated* tasks. An active processor runs
one task; completion decrements the children's predecessor counts and pushes
newly-ready tasks to its own deque end. Idle processors pop locally
(``owner_lifo=True`` = classic ABP: owner pops the newest end, thieves steal
the oldest end, which holds the activated task with the **largest height** —
exactly the steal rule of the paper) or FIFO (``owner_lifo=False``, the
literal reading of the paper's text); steals always take the head.

Event machinery, victim selection, SWT/MWT and steal-threshold semantics are
shared with every other task model through ``repro_torch.core.engine``; this
module defines only the DAG :class:`TaskModel` and its public types. For DAGs
the steal threshold is a queue-length threshold: a steal fails unless
``len(queue) > theta_static`` (there is no divisible work to meter).

Batched form: the deques are ``buf[G, p, cap]`` with ``head``/``tail``
positions that never reset (``head`` only grows; a push at ``tail == cap``
sets ``halt``), the predecessor counts ``pred[G, n]``. A completion's children
are visited in CSR order, one child position per pass over the batch, because
the push order fixes deque positions.

All int32; bit-exact against ``repro_torch.core.oracle.simulate_dag_oracle``
and, field for field, against the JAX package's DAG model.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core.dag_gen import TaskDag
from repro_torch.core.engine import (EV_ANS_FAIL, EV_ANS_OK, EV_IDLE,
                                     EV_REQ_FAIL, EV_REQ_OK, I32, I64,
                                     Scenario)
from repro_torch.core.topology import Topology


class DagSimResult(NamedTuple):
    makespan: torch.Tensor
    n_events: torch.Tensor
    n_requests: torch.Tensor
    n_success: torch.Tensor
    n_fail: torch.Tensor
    total_idle: torch.Tensor
    startup_end: torch.Tensor
    executed: torch.Tensor     # int32[p] work time executed per processor
    tasks_run: torch.Tensor    # int32[p] number of tasks run per processor
    n_completed: torch.Tensor
    overflow: torch.Tensor     # hit max_events or deque overflow
    trace: torch.Tensor        # int32[max_trace, 4] (t, proc, kind, aux)
    n_trace: torch.Tensor


class DagState(NamedTuple):
    """Per-model state, batched over G and mutated in place."""
    cur_task: torch.Tensor     # int32[G, p]; -1 = no running task
    pred: torch.Tensor         # int32[G, n] remaining predecessor counts
    buf: torch.Tensor          # int32[G, p, cap] deques
    head: torch.Tensor         # int32[G, p]
    tail: torch.Tensor         # int32[G, p]
    tasks_run: torch.Tensor    # int32[G, p]
    n_completed: torch.Tensor  # int32[G]


@dataclasses.dataclass(frozen=True)
class DagEngineConfig:
    topology: Topology
    dag: TaskDag
    mwt: bool = False
    owner_lifo: bool = True       # ABP discipline (steal-largest-height)
    deque_cap: Optional[int] = None  # default: n tasks (always sufficient)
    max_events: int = 1 << 20
    log_trace: bool = False
    max_trace: int = 0

    @property
    def p(self) -> int:
        return self.topology.p

    @property
    def cap(self) -> int:
        return self.dag.n if self.deque_cap is None else self.deque_cap


@dataclasses.dataclass(frozen=True)
class DagModel(eng.TaskModel):
    """DAG task engine: work is a static precedence graph of unit tasks."""
    cfg: DagEngineConfig

    def static_arrays(self, device):
        """(dur, child_ptr, child_idx, pred_count) as int32 tensors;
        ``child_idx`` holds one 0 for a DAG without edges (never read)."""
        dag = self.cfg.dag
        cidx = dag.child_idx if dag.child_idx.shape[0] else np.zeros(1)
        return tuple(torch.as_tensor(np.asarray(a, np.int32), device=device)
                     for a in (dag.dur, dag.child_ptr, cidx, dag.pred_count))

    @property
    def max_out_degree(self) -> int:
        cptr = np.asarray(self.cfg.dag.child_ptr)
        return int(np.diff(cptr).max()) if cptr.shape[0] > 1 else 0

    def init(self, scn: Scenario, core: eng.CoreState) -> DagState:
        G, p = core.state.shape
        dev = core.state.device
        dag = self.cfg.dag
        src = int(dag.sources[0])
        core.ev_time[:, 0] = int(dag.dur[src])
        core.stolen.fill_(-1)
        cur = torch.full((G, p), -1, dtype=I32, device=dev)
        cur[:, 0] = src
        # a copy: the loop decrements it in place, and a one-row batch's
        # contiguous() below would otherwise alias the DAG's own array
        pred = torch.tensor(np.asarray(dag.pred_count, np.int32), device=dev)

        def vec():
            return torch.zeros((G, p), dtype=I32, device=dev)

        return DagState(
            cur_task=cur,
            pred=pred.unsqueeze(0).expand(G, -1).contiguous(),
            buf=torch.zeros((G, p, self.cfg.cap), dtype=I32, device=dev),
            head=vec(), tail=vec(), tasks_run=vec(),
            n_completed=torch.zeros((G,), dtype=I32, device=dev))

    def _activate_children(self, tabs, core, ms: DagState, ev, c, m):
        """end_execute_task(): decrement the preds of c's children; push the
        ready ones to i's own deque tail (a push at capacity halts the
        row). Children are taken in CSR order, one position at a time."""
        _, cptr, cidx, _ = tabs.arrays
        cap = self.cfg.cap
        c64 = c.clamp(min=0).to(I64)
        lo, hi = cptr[c64], cptr[c64 + 1]
        flat = ms.buf.view(ms.buf.shape[0], -1)
        base = ev.i * cap
        for k in range(self.max_out_degree):
            e = lo + k
            valid = m & (e < hi)
            child = cidx[e.clamp(max=cidx.shape[0] - 1).to(I64)]
            pc = eng.take(ms.pred, child) - 1
            eng.store(ms.pred, child, pc, valid)
            ready = valid & (pc == 0)
            tl = eng.at(ms.tail, ev.i)
            ok = tl < cap
            eng.store(flat, base + tl, child, ready & ok)
            eng.put(ms.tail, ev.is_i, tl + 1, ready & ok)
            core.halt.logical_or_(ready & ~ok)

    def on_idle(self, tabs, scn, core, ms: DagState, ev, m):
        """idle event: task completion (or the initial empty kick); then
        finish, pop locally, or steal. Returns the rows that steal."""
        dur = tabs.arrays[0]
        i, t = ev.i, ev.t
        c = eng.at(ms.cur_task, i)
        has = m & (c >= 0)
        dur_c = dur[c.clamp(min=0).to(I64)]
        eng.bump(ms.n_completed, 1, has)
        eng.put(ms.tasks_run, ev.is_i, eng.at(ms.tasks_run, i) + 1, has)
        eng.put(core.executed, ev.is_i, eng.at(core.executed, i) + dur_c, has)
        self._activate_children(tabs, core, ms, ev, c, has)
        eng.put(ms.cur_task, ev.is_i, -1, m)

        finished = m & (ms.n_completed >= self.cfg.dag.n)
        idle_now = torch.where((ms.cur_task >= 0) | ev.is_i, 0,
                               t.unsqueeze(1) - core.idle_since)
        eng.finish(self, core, t, idle_now, finished)

        go = m & ~finished
        hd, tl = eng.at(ms.head, i), eng.at(ms.tail, i)
        empty = hd >= tl
        pop = go & ~empty
        if self.cfg.owner_lifo:
            pos = tl - 1
            eng.put(ms.tail, ev.is_i, pos, pop)
        else:
            pos = hd
            eng.put(ms.head, ev.is_i, hd + 1, pop)
        flat = ms.buf.view(ms.buf.shape[0], -1)
        task = eng.take(flat, i * self.cfg.cap + pos)
        eng.put(ms.cur_task, ev.is_i, task, pop)
        eng.put(core.ev_time, ev.is_i, t + dur[task.clamp(min=0).to(I64)],
                pop)

        steal = go & empty
        eng.enter_idle(core, ev, steal)
        eng.log(self, core, t, i, EV_IDLE, 0, steal)
        return steal

    def on_request(self, tabs, scn, core, ms: DagState, ev, m):
        """steal request reaches victim v: take the head of v's deque if it
        holds more than theta_static tasks and v's channel is free."""
        i, t = ev.i, ev.t
        v = eng.at(core.victim, i)
        is_v = ev.onehot(v)
        hd = eng.at(ms.head, v)
        qlen = eng.at(ms.tail, v) - hd
        d_vi = eng.dist(tabs, scn, v, i)
        free = eng.chan_free(self, core, v, t)
        ok = (qlen > scn.theta_static) & free
        cap = self.cfg.cap
        flat = ms.buf.view(ms.buf.shape[0], -1)
        task = eng.take(flat, v * cap + hd.clamp(max=cap - 1))
        task = torch.where(ok, task, -1)
        eng.put(ms.head, is_v, hd + 1, m & ok)
        eng.deliver_answer(core, ev, is_v, d_vi, ok, task, m)
        if self.log_trace:
            eng.log(self, core, t, i, torch.where(ok, EV_REQ_OK, EV_REQ_FAIL),
                    v, m)

    def on_answer(self, tabs, scn, core, ms: DagState, ev, m):
        """the (possibly empty) answer reaches thief i. Returns the rows
        where i must steal again."""
        dur = tabs.arrays[0]
        i, t = ev.i, ev.t
        task = eng.at(core.stolen, i)
        ok = task >= 0
        got = m & ok
        end = t + dur[task.clamp(min=0).to(I64)]
        eng.acquire_work(self, core, ev, end, 0, -1, got)
        eng.put(ms.cur_task, ev.is_i, task, got)
        eng.log(self, core, t, i, EV_ANS_OK, task, got)
        return m & ~ok

    def on_steal(self, core, ms, ev, retry):
        """After start_stealing: the retry logs the victim chosen just now."""
        if self.log_trace:
            eng.log(self, core, ev.t, ev.i, EV_ANS_FAIL,
                    eng.at(core.victim, ev.i), retry)

    def results(self, core: eng.CoreState, ms: DagState) -> DagSimResult:
        return DagSimResult(
            makespan=core.makespan, n_events=core.n_events,
            n_requests=core.n_requests, n_success=core.n_success,
            n_fail=core.n_fail, total_idle=core.total_idle,
            startup_end=core.startup_end, executed=core.executed,
            tasks_run=ms.tasks_run, n_completed=ms.n_completed,
            overflow=(~core.done) | core.halt,
            trace=core.trace, n_trace=core.n_trace,
        )


def simulate_dag(cfg: DagEngineConfig, scn: Scenario) -> DagSimResult:
    """Run one simulation on the device of ``scn``."""
    return eng.simulate(DagModel(cfg), scn)


def simulate_dag_batch(cfg: DagEngineConfig, scn: Scenario) -> DagSimResult:
    """Run a batch: every leaf of ``scn`` has a leading batch axis."""
    return eng.simulate_batch(DagModel(cfg), scn)
