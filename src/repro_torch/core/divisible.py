"""Divisible-load task model (paper §2.1.1, §3) over the unified event core.

This is the task model the paper uses for all of its §4 experiments: ``W``
unit tasks start on processor 0; an idle processor steals; a successful steal
transfers floor(w/2) of the victim's remaining work. All event machinery —
one pending event per processor, argmin event selection, SWT/MWT answer
policies, steal thresholds, victim-selection dispatch, xorshift32 PRNG lanes,
trace logging — lives in ``repro_torch.core.engine``; this module defines only
the divisible :class:`TaskModel` and its public types.

Steal-answer policies (paper §2.4): ``mwt=True`` allows simultaneous answers
(requests arriving at the same instant are serialized by processor index,
each taking half of what remains — exactly Fig 2); ``mwt=False`` (SWT) makes a
victim refuse while a previous answer is still in flight. ``theta_static`` /
``theta_comm`` implement the steal threshold of §2.4.2: a steal fails unless
the victim's remaining work exceeds ``theta_static + theta_comm·d(v,i)``.

All quantities are int32 (unit tasks, integer latencies); the engine is
bit-exact reproducible and matches the numpy oracle in
``repro_torch.core.oracle`` event-for-event.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core.engine import (  # noqa: F401
    ACTIVE, ANS_FLIGHT, EV_ANS_FAIL, EV_ANS_OK, EV_IDLE, EV_REQ_FAIL,
    EV_REQ_OK, INF32, REQ_FLIGHT, EngineConfig, Scenario, batch_scenarios,
    make_scenario)


class SimResult(NamedTuple):
    makespan: torch.Tensor       # int32; valid iff ~overflow
    n_events: torch.Tensor       # int32 events processed
    n_requests: torch.Tensor     # int32 steal requests answered (paper metric)
    n_success: torch.Tensor      # int32 successful steals
    n_fail: torch.Tensor         # int32 failed steals
    total_idle: torch.Tensor     # int32 summed idle time over processors
    startup_end: torch.Tensor    # int32 first time all p procs active (-1: never)
    executed: torch.Tensor       # int32[p] work executed per processor
    overflow: torch.Tensor       # bool: hit max_events before termination
    trace: torch.Tensor          # int32[max_trace, 4] (t, proc, kind, aux)
    n_trace: torch.Tensor        # int32 valid trace rows


@dataclasses.dataclass(frozen=True)
class DivisibleModel(eng.TaskModel):
    """Divisible-load task engine: work is a splittable int32 amount."""
    cfg: EngineConfig

    def init(self, scn: Scenario, core: eng.CoreState):
        core.idle_at[:, 0] = scn.W
        core.ev_time.copy_(core.idle_at)  # everyone's first event is its idle event
        core.executed[:, 0] = scn.W
        return ()

    def on_idle(self, tabs, scn, core, ms, ev, m):
        """idle event: processor i's running work is exhausted (paper idle()).
        Returns the rows where i must now steal."""
        t = ev.t
        # No remaining work anywhere, neither running nor in flight, with
        # processor i tentatively not active. This reads the state *before*
        # enter_idle changes it; the terminal idle accounting reads
        # idle_since *after*, where idle_since[i] equals t (contribution 0).
        active2 = (core.state == ACTIVE) & ~ev.is_i
        t_col = t.unsqueeze(1)
        rem_active = torch.where(active2, core.idle_at - t_col, 0).sum(
            dim=1, dtype=eng.I32)
        rem_flight = torch.where(core.state == ANS_FLIGHT, core.stolen,
                                 0).sum(dim=1, dtype=eng.I32)
        finished = (rem_active + rem_flight) == 0

        eng.enter_idle(core, ev, m)
        eng.log(self, core, t, ev.i, EV_IDLE, 0, m)

        # Account terminal idle time of every non-active processor.
        idle_now = torch.where(active2, 0, t_col - core.idle_since)
        eng.finish(self, core, t, idle_now, m & finished)
        return m & ~finished

    def on_request(self, tabs, scn, core, ms, ev, m):
        """steal-request event: thief i's request reaches victim v
        (paper answer_steal_request() + get_part_of_work_if_exist())."""
        i, t = ev.i, ev.t
        v = eng.at(core.victim, i)
        is_v = ev.onehot(v)
        w_v = torch.where(eng.at(core.state, v) == ACTIVE,
                          eng.at(core.idle_at, v) - t, 0)
        d_vi = eng.dist(tabs, scn, v, i)
        thr = eng.steal_threshold(scn, d_vi)
        free = eng.chan_free(self, core, v, t)
        amt = torch.div(w_v, 2, rounding_mode="floor")
        ok = (amt >= 1) & (w_v > thr) & free
        amt = torch.where(ok, amt, 0)

        new_idle_v = t + (w_v - amt)
        eng.put(core.idle_at, is_v, new_idle_v, m & ok)
        eng.put(core.ev_time, is_v, new_idle_v, m & ok)
        # executed[v] -= amt on every request; amt is 0 unless ok
        eng.put(core.executed, is_v, eng.at(core.executed, v) - amt, m & ok)
        eng.deliver_answer(core, ev, is_v, d_vi, ok, amt, m)
        if self.log_trace:
            kind = torch.where(ok, EV_REQ_OK, EV_REQ_FAIL)
            eng.log(self, core, t, i, kind, v, m)

    def on_answer(self, tabs, scn, core, ms, ev, m):
        """steal-answer event: the (possibly empty) answer reaches thief i
        (paper steal_answer()). Returns the rows where i must steal again."""
        amt = eng.at(core.stolen, ev.i)
        ok = amt > 0
        eng.acquire_work(self, core, ev, ev.t + amt, amt, 0, m & ok)
        eng.log(self, core, ev.t, ev.i, EV_ANS_OK, amt, m & ok)
        return m & ~ok

    def on_steal(self, core, ms, ev, retry):
        """After start_stealing: the retry logs the victim chosen just now."""
        if self.log_trace:
            eng.log(self, core, ev.t, ev.i, EV_ANS_FAIL,
                    eng.at(core.victim, ev.i), retry)

    def results(self, core: eng.CoreState, ms) -> SimResult:
        return SimResult(
            makespan=core.makespan,
            n_events=core.n_events,
            n_requests=core.n_requests,
            n_success=core.n_success,
            n_fail=core.n_fail,
            total_idle=core.total_idle,
            startup_end=core.startup_end,
            executed=core.executed,
            overflow=(~core.done) | core.halt,
            trace=core.trace,
            n_trace=core.n_trace,
        )


def simulate(cfg: EngineConfig, scn: Scenario) -> SimResult:
    """Run one simulation on the device of ``scn``."""
    return eng.simulate(DivisibleModel(cfg), scn)


def simulate_batch(cfg: EngineConfig, scn: Scenario) -> SimResult:
    """Run a batch: every leaf of ``scn`` has a leading batch axis."""
    return eng.simulate_batch(DivisibleModel(cfg), scn)


# ---------------------------------------------------------------------------
# Helpers for callers.
# ---------------------------------------------------------------------------

def default_max_events(W: int, p: int, lam: int) -> int:
    """Heuristic event-count cap.

    Event census: ≤ 2·p idle events for real work intervals plus steal cycles.
    Each steal cycle of an idle processor occupies ≥ 2·lam time, and the
    execution spans ≈ W/p + O(lam·log W) time, so cycles per processor are
    ≈ makespan / (2·lam). 3 events per cycle, ×p processors, ×4 safety.
    """
    lam = max(int(lam), 1)
    makespan_est = W / max(p, 1) + 16.0 * lam * max(np.log2(max(W, 2) / lam), 1.0)
    cycles = makespan_est / (2.0 * lam) + 8.0
    return int(min(12 * p * cycles + 64, 2**31 - 1))
