"""Serial numpy oracle for the divisible-load WS engine.

This is a faithful, heap-free transcription of the paper's serial simulator
(one pending event per processor, nearest-event-first with index tie-break).
It must match ``repro_torch.core.divisible.simulate`` **bit-exactly** — the tests
compare makespan, steal counts and executed-work vectors event-for-event.

Kept deliberately simple and slow (pure Python loop) — it is the ground truth
for both the batched PyTorch engine and the CUDA kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import topology as topo_mod
from repro_torch.core.topology import Topology

INF = 2**31 - 1
ACTIVE, REQ_FLIGHT, ANS_FLIGHT = 0, 1, 2


@dataclasses.dataclass
class OracleResult:
    makespan: int
    n_events: int
    n_requests: int
    n_success: int
    n_fail: int
    total_idle: int
    startup_end: int
    executed: np.ndarray
    overflow: bool


def _dist(topo: Topology, lam_local: int, lam_remote: int, i: int, j: int) -> int:
    if i == j:
        return 0
    if topo.cluster_id[i] == topo.cluster_id[j]:
        return int(lam_local)
    return int(lam_remote) * int(topo.hops[i, j])


def _select_victim(topo: Topology, lam_local, lam_remote, remote_prob_u32, i, rng, rr):
    p = topo.p
    strat = topo.strategy
    if strat == topo_mod.UNIFORM:
        rng = topo_mod.np_xorshift32(rng)
        v = int(rng) % (p - 1)
        if v >= i:
            v += 1
        return v, rng, rr
    if strat == topo_mod.LOCAL_FIRST:
        rng = topo_mod.np_xorshift32(rng)
        go_remote = int(rng) < int(remote_prob_u32)
        rng = topo_mod.np_xorshift32(rng)
        cid = np.asarray(topo.cluster_id)
        if go_remote:
            cand = np.nonzero(cid != cid[i])[0]
        else:
            cand = np.nonzero((cid == cid[i]) & (np.arange(p) != i))[0]
        if len(cand) == 0:
            return (i + 1) % p, rng, rr
        v = int(cand[int(rng) % len(cand)])
        return v, rng, rr
    if strat == topo_mod.INV_DISTANCE:
        cid = np.asarray(topo.cluster_id)
        idx = np.arange(p)
        d = np.where(cid == cid[i], float(lam_local),
                     float(lam_remote) * topo.hops[i].astype(np.float64)).astype(np.float32)
        w = np.where(idx == i, np.float32(0.0),
                     np.float32(1.0) / np.maximum(d, np.float32(1.0)))
        c = np.cumsum(w, dtype=np.float32)
        rng = topo_mod.np_xorshift32(rng)
        u = np.float32(np.float32(int(rng)) / np.float32(2**32)) * c[-1]
        nz = np.nonzero(c > u)[0]
        v = int(nz[0]) if len(nz) else p - 1
        if v == i:
            v = (i + 1) % p
        return v, rng, rr
    if strat == topo_mod.ROUND_ROBIN:
        nxt = (rr + 1) % p
        if nxt == i:
            nxt = (nxt + 1) % p
        return nxt, rng, nxt
    raise ValueError(strat)


def simulate_oracle(
    topo: Topology,
    W: int,
    seed: int,
    lam_local: Optional[int] = None,
    lam_remote: Optional[int] = None,
    theta_static: int = 0,
    theta_comm: int = 0,
    mwt: bool = False,
    remote_prob: float = 0.25,
    max_events: int = 1 << 22,
) -> OracleResult:
    p = topo.p
    ll = topo.lam_local if lam_local is None else int(lam_local)
    lr = topo.lam_remote if lam_remote is None else int(lam_remote)
    rp_u32 = topo_mod.remote_prob_u32(remote_prob)

    state = np.full(p, ACTIVE, np.int64)
    idle_at = np.zeros(p, np.int64)
    idle_at[0] = W
    ev_time = idle_at.copy()
    victim = np.zeros(p, np.int64)
    stolen = np.zeros(p, np.int64)
    busy_until = np.zeros(p, np.int64)
    rng = np.array([topo_mod.np_seed_state(seed, i) for i in range(p)], np.uint32)
    rr = np.arange(p, dtype=np.int64)
    idle_since = np.zeros(p, np.int64)
    executed = np.zeros(p, np.int64)
    executed[0] = W

    active_count = p
    n_events = n_requests = n_success = n_fail = 0
    total_idle = 0
    startup_end = -1
    makespan = -1
    done = False

    def start_stealing(i, t):
        nonlocal rng, rr
        v, r, rr_i = _select_victim(topo, ll, lr, rp_u32, i, rng[i], rr[i])
        rng[i] = r
        rr[i] = rr_i
        victim[i] = v
        state[i] = REQ_FLIGHT
        ev_time[i] = t + _dist(topo, ll, lr, i, v)

    while not done and n_events < max_events:
        i = int(np.argmin(ev_time))
        t = int(ev_time[i])
        if t >= INF:
            break
        n_events += 1
        st = state[i]

        if st == ACTIVE:  # idle event
            state[i] = REQ_FLIGHT
            active_count -= 1
            idle_since[i] = t
            rem = 0
            for j in range(p):
                if state[j] == ACTIVE:
                    rem += idle_at[j] - t
                elif state[j] == ANS_FLIGHT:
                    rem += stolen[j]
            if rem == 0:
                done = True
                makespan = t
                for j in range(p):
                    if state[j] != ACTIVE:
                        total_idle += t - idle_since[j]
                break
            start_stealing(i, t)

        elif st == REQ_FLIGHT:  # request arrives at victim
            v = int(victim[i])
            w_v = int(idle_at[v] - t) if state[v] == ACTIVE else 0
            d_vi = _dist(topo, ll, lr, v, i)
            thr = theta_static + theta_comm * d_vi
            chan_free = mwt or (t >= busy_until[v])
            amt = w_v // 2
            ok = (amt >= 1) and (w_v > thr) and chan_free
            amt = amt if ok else 0
            n_requests += 1
            if ok:
                n_success += 1
                idle_at[v] = t + (w_v - amt)
                ev_time[v] = idle_at[v]
                executed[v] -= amt
                busy_until[v] = t + d_vi
            else:
                n_fail += 1
            stolen[i] = amt
            state[i] = ANS_FLIGHT
            ev_time[i] = t + d_vi

        else:  # ANS_FLIGHT: answer arrives at thief
            amt = int(stolen[i])
            if amt > 0:
                state[i] = ACTIVE
                idle_at[i] = t + amt
                ev_time[i] = t + amt
                stolen[i] = 0
                executed[i] += amt
                active_count += 1
                total_idle += t - idle_since[i]
                if active_count == p and startup_end < 0:
                    startup_end = t
            else:
                start_stealing(i, t)

    return OracleResult(
        makespan=makespan,
        n_events=n_events,
        n_requests=n_requests,
        n_success=n_success,
        n_fail=n_fail,
        total_idle=total_idle,
        startup_end=startup_end,
        executed=executed,
        overflow=not done,
    )


# ---------------------------------------------------------------------------
# DAG-of-tasks oracle (twin of repro_torch.core.dag).
# ---------------------------------------------------------------------------

