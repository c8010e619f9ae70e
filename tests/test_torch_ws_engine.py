"""The event engine of the ``ws_sim`` kernel, checked on
the CPU: a CUDA kernel has no interpret mode, so what runs on the card is
checked here through numpy emulations of its rules, held against the
reference (``np.argmin``, Python's ``%``, the numpy oracle, the JAX engine).

* the argmin: lane l holds processors l*K .. l*K + K - 1; a tree of strict
  compares over a lane's K slots, the warp's minimum, the lowest lane that
  holds it — that is ``np.argmin``, ties and padding included;
* the divisible body's running sums (remaining work and idle time from three
  uint32 sums instead of a pass over the p processors), with the victim
  selection the kernel makes (a multiply-high divisor for UNIFORM, a
  host-made table of candidate counts for LOCAL_FIRST, a compare for
  ROUND_ROBIN): an emulation of that event loop, leaf for leaf against the
  numpy oracle and the JAX engine;
* the UNIFORM divisor of p - 1 against ``%`` for every p the kernel takes;
* the wrapper's p -> variant rule, and the C launcher's cases beside it.

Tolerance: none; every comparison is exact.
"""
import re

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import divisible as jdv
from repro.core import engine as jeng
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro_torch.core import oracle as porc
from repro_torch.kernels import _build
from repro_torch.kernels import ws_sim as ws
from test_torch_common import STRATEGIES, port_topology, to_numpy

INF32 = 2**31 - 1
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The argmin rule.
# ---------------------------------------------------------------------------

def warp_argmin(ev: np.ndarray) -> int:
    """The kernel's argmin over ``ev`` (int32[p]): per lane a tree of strict
    compares over its K slots (padding at INF32), then the warp's minimum
    and the lowest lane that holds it, then that lane's slot."""
    p = len(ev)
    K = ws.variant(p)[1]
    slots = np.full(32 * K, INF32, dtype=np.int64)
    slots[:p] = ev
    slots = slots.reshape(32, K)                 # lane l: l*K .. l*K + K - 1
    best, bk = [], []
    for lane in range(32):
        tv, tk = list(slots[lane]), list(range(K))
        w = 1
        while w < K:
            for q in range(0, K, 2 * w):
                if tv[q + w] < tv[q]:
                    tv[q], tk[q] = tv[q + w], tk[q + w]
            w *= 2
        best.append(tv[0])
        bk.append(tk[0])
    t = min(best)
    lane = best.index(t)                         # __ffs of the ballot
    return lane * K + bk[lane]


@settings(max_examples=300, deadline=None)
@given(p=st.integers(2, 1024), data=st.data())
def test_warp_argmin_is_np_argmin(p, data):
    """Few distinct times (ties everywhere), INF32 among them."""
    values = data.draw(st.lists(
        st.sampled_from([0, 1, 5, 7, INF32 - 1, INF32, -3, -(2**31)]),
        min_size=1, max_size=4, unique=True))
    idx = data.draw(st.lists(st.integers(0, len(values) - 1), min_size=p,
                             max_size=p))
    ev = np.asarray([values[k] for k in idx], dtype=np.int64)
    i = warp_argmin(ev)
    assert i == int(np.argmin(ev)) and ev[i] == ev.min()


@pytest.mark.parametrize("p", [2, 31, 32, 33, 63, 64, 65, 128, 129, 256, 257,
                               512, 513, 1024])
def test_warp_argmin_at_every_slot_count(p):
    rng = np.random.default_rng(p)
    for _ in range(50):
        ev = rng.integers(0, 4, size=p) * rng.choice([1, INF32 // 3], size=p)
        ev[rng.random(p) < 0.2] = INF32
        assert warp_argmin(ev) == int(np.argmin(ev))
    assert warp_argmin(np.full(p, INF32)) == 0


# ---------------------------------------------------------------------------
# The UNIFORM divisor, and the LOCAL_FIRST table.
# ---------------------------------------------------------------------------

def test_magic_mod_is_python_mod_for_every_p():
    rng = np.random.default_rng(0)
    random = rng.integers(0, 2**32, size=10_000, dtype=np.uint64)
    for p in range(2, ws.MAX_P + 1):
        d = p - 1
        edge = np.asarray([0, 1, p - 2, p - 1, 2**31, 2**32 - 1],
                          dtype=np.uint64)
        n = np.concatenate([edge, random])
        np.testing.assert_array_equal(ws.magic_mod(n, d), n % np.uint64(d),
                                      err_msg=f"d={d}")
        m, s1, s2 = ws.divisor_magic(d)
        assert 0 < m < 2**32 and s1 in (0, 1) and 0 <= s2 < 16


def test_divisor_encoding_fits_the_kernel():
    for d in (1, 2, 3, 255, 1023, 2**16 - 1):
        enc, m = ws._encode_divisor(d)
        m_u = m & U32
        assert enc & 0xFFFF == d
        assert (m_u, (enc >> 16) & 0xF, (enc >> 20) & 0xF) == \
            ws.divisor_magic(d)
        assert -(2**31) <= m < 2**31
    with pytest.raises(ValueError):
        ws.divisor_magic(0)


def test_local_first_table_counts_candidates():
    cid = np.asarray([0, 0, 1, 1, 1, 2, 0])
    tab = ws.local_first_table(cid)
    assert tab.shape == (7, 4) and tab.dtype == np.int32
    for j in range(7):
        local = int(((cid == cid[j]) & (np.arange(7) != j)).sum())
        remote = int((cid != cid[j]).sum())
        assert tab[j, 0] & 0xFFFF == max(local, 1)
        assert tab[j, 2] & 0xFFFF == max(remote, 1)
    # a cluster of one processor: no local candidate, count 1 (k = 0)
    assert tab[5, 0] & 0xFFFF == 1


# ---------------------------------------------------------------------------
# The divisible body with running sums, emulated.
# ---------------------------------------------------------------------------

def xorshift32(s: int) -> int:
    s ^= (s << 13) & U32
    s ^= s >> 17
    s ^= (s << 5) & U32
    return s


def i32(x: int) -> int:
    """The int32 a wrapping uint32/int sum leaves."""
    x &= U32
    return x - (1 << 32) if x >= 1 << 31 else x


def emulate_divisible(topo, mwt: bool, row: dict, max_events: int,
                      max_trace: int = 0) -> dict:
    """One scenario through the kernel's divisible loop: the
    warp's argmin, the running sums, the kernel's victim selection. int32
    values wrap; the sums are uint32."""
    p = topo.p
    cid = np.asarray(topo.cluster_id)
    hops = np.asarray(topo.hops)
    ll, lr = int(row["lam_local"]), int(row["lam_remote"])
    th_s, th_c = int(row["theta_static"]), int(row["theta_comm"])
    rp = int(row["remote_prob"])
    W = int(row["W"])
    lf = ws.local_first_table(cid).astype(np.int64)

    def dist(a, b):
        if a == b:
            return 0
        return ll if cid[a] == cid[b] else i32(lr * int(hops[a, b]))

    def victim(i, rng):
        s = topo.strategy
        if s == JT.UNIFORM:
            rng = xorshift32(rng)
            v = int(ws.magic_mod(np.uint64(rng), p - 1))
            return v + (v >= i), rng
        if s == JT.ROUND_ROBIN:                        # rng: the cursor
            nxt = rng + 1
            nxt = 0 if nxt == p else nxt
            if nxt == i:
                nxt = 0 if nxt + 1 == p else nxt + 1
            return nxt, nxt
        if s == JT.LOCAL_FIRST:
            rng = xorshift32(rng)
            remote = rng < rp
            rng = xorshift32(rng)
            col = 2 if remote else 0
            k = int(ws.magic_mod(np.uint64(rng), int(lf[i, col]) & 0xFFFF))
            cand = np.nonzero((cid != cid[i]) if remote else
                              ((cid == cid[i]) & (np.arange(p) != i)))[0]
            v = int(cand[k]) if k < len(cand) else 0
            return ((0 if i + 1 == p else i + 1) if v == i else v), rng
        # INV_DISTANCE: float32 weights, summed left to right
        w = np.zeros(p, np.float32)
        for j in range(p):
            if j != i:
                w[j] = np.float32(1.0) / max(np.float32(dist(i, j)),
                                             np.float32(1.0))
        total = np.float32(0.0)
        for j in range(p):
            total = np.float32(total + w[j])
        rng = xorshift32(rng)
        u = np.float32(np.float32(rng) / np.float32(2**32)) * total
        v, c = 0, np.float32(0.0)
        for j in range(p):
            c = np.float32(c + w[j])
            if c > u:
                v = j
                break
        return ((i + 1) % p if v == i else v), rng

    st_ = [porc.ACTIVE] * p
    ev = [0] * p
    ev[0] = W
    vic, stolen, busy, since = [0] * p, [0] * p, [0] * p, [0] * p
    exe = [0] * p
    exe[0] = W
    rng = [j if topo.strategy == JT.ROUND_ROBIN else
           int(JT.np_seed_state(int(row["seed"]), j)) for j in range(p)]
    active, n_ev, n_req, n_ok, n_fail = p, 0, 0, 0, 0
    idle, startup, makespan, done = 0, -1, -1, False
    s_active_at, s_flight, s_since = W & U32, 0, 0
    wraps = 0                  # sums whose exact value left 0 .. 2**32 - 1
    trace = []

    def u32(x: int) -> int:
        nonlocal wraps
        wraps += not 0 <= x <= U32
        return x & U32
    budget = min(int(row["max_events"]), max_events)

    def steal(i, t):
        v, rng[i] = victim(i, rng[i])
        st_[i], vic[i], ev[i] = porc.REQ_FLIGHT, v, i32(t + dist(i, v))
        return v

    while not done and n_ev < budget:
        i = warp_argmin(np.asarray(ev, np.int64))
        t = ev[i]
        n_ev = i32(n_ev + 1)
        if st_[i] == porc.ACTIVE:
            rem = u32(u32(s_active_at - u32(active * t)) + s_flight)
            idle_sum = u32(u32((p - active) * t) - s_since)
            active -= 1
            s_active_at = u32(s_active_at - t)
            s_since = u32(s_since + t)
            since[i] = t
            kind, aux = jeng.EV_IDLE, 0
            if rem == 0:
                done, makespan, idle = True, t, i32(idle + idle_sum)
            else:
                steal(i, t)
        elif st_[i] == porc.REQ_FLIGHT:
            v = vic[i]
            d_vi = dist(v, i)
            free = mwt or t >= busy[v]
            w_v = i32(ev[v] - t) if st_[v] == porc.ACTIVE else 0
            amt = w_v >> 1
            ok = amt >= 1 and w_v > i32(th_s + th_c * d_vi) and free
            amt = amt if ok else 0
            if ok:
                ev[v] = i32(t + w_v - amt)
                exe[v] = i32(exe[v] - amt)
                busy[v] = i32(t + d_vi)
                s_active_at = u32(s_active_at - amt)
            s_flight = u32(s_flight + amt)
            stolen[i], st_[i], ev[i] = amt, porc.ANS_FLIGHT, i32(t + d_vi)
            n_req += 1
            n_ok += ok
            n_fail += not ok
            kind, aux = (jeng.EV_REQ_OK if ok else jeng.EV_REQ_FAIL), v
        else:
            got = stolen[i]
            s_flight = u32(s_flight - got)
            if got > 0:
                end = i32(t + got)
                st_[i], ev[i], stolen[i] = porc.ACTIVE, end, 0
                exe[i] = i32(exe[i] + got)
                s_active_at = u32(s_active_at + end)
                s_since = u32(s_since - since[i])
                active += 1
                idle = i32(idle + t - since[i])
                if active == p and startup < 0:
                    startup = t
                kind, aux = jeng.EV_ANS_OK, got
            else:
                kind, aux = jeng.EV_ANS_FAIL, steal(i, t)
        if len(trace) < max_trace:
            trace.append((t, i, kind, aux))
    return dict(makespan=makespan, n_events=n_ev, n_requests=n_req,
                n_success=n_ok, n_fail=n_fail, total_idle=idle,
                startup_end=startup, executed=np.asarray(exe, np.int32),
                overflow=not done, trace=trace, wraps=wraps)


def _rows(scn) -> list:
    leaves = {k: np.asarray(v) for k, v in scn._asdict().items()}
    return [{k: v[r] for k, v in leaves.items()}
            for r in range(len(leaves["W"]))]


PLATFORMS = {
    "one_cluster": lambda: JT.one_cluster(8, 3),
    "two_clusters": lambda: JT.two_clusters(16, 9, lam_local=2),
}
#: (W, lam_local, lam_remote) per case: small work at the platform's own
#: latencies, then W near 2**31 at latencies of 2**26, where the times
#: grow to ~2**30 and the uint32 running sums wrap
LOADS = ((1500, None, None), (2**31 - 2**22, 2**26, 2**26))


@pytest.mark.parametrize("platform", sorted(PLATFORMS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_running_sums_loop_vs_oracle_and_jax(platform, strategy):
    """Per platform, two strategies run SWT and two MWT, so that each
    strategy meets both; one row of four stops at its own budget."""
    mwt = (strategy % 2 == 1) == (platform == "one_cluster")
    topo = PLATFORMS[platform]().with_strategy(strategy, 0.3)
    ptopo = port_topology(topo)
    cfg = jdv.EngineConfig(topology=topo, mwt=mwt, max_events=1 << 16,
                           log_trace=True, max_trace=24)
    budgets = np.asarray([INF32, 40, INF32, INF32])
    # LOCAL_FIRST on one cluster has no remote candidate: the JAX engine
    # then draws victim 0, the numpy oracle (i + 1) % p (a reference-side
    # difference the port keeps); the oracle is held where the two agree
    by_oracle = not (platform == "one_cluster" and strategy == JT.LOCAL_FIRST)
    seeds = np.random.default_rng(7 + strategy).integers(
        0, 2**32, size=4, dtype=np.uint64).astype(np.uint32)
    for W, ll, lr in LOADS:
        scn = jdv.batch_scenarios(
            W, seeds, lam_local=ll or topo.lam_local,
            lam_remote=lr or topo.lam_remote, theta_static=2, theta_comm=1,
            remote_prob=0.3, max_events=budgets)
        expect = jeng.simulate_batch(jsw.as_model(cfg), scn)
        wraps = oracle_rows = 0
        for r, row in enumerate(_rows(scn)):
            got = emulate_divisible(ptopo, mwt, row, cfg.max_events, 24)
            wraps += got["wraps"]
            msg = f"{platform} s={strategy} mwt={mwt} W={W} row {r}"
            for f in ("makespan", "n_events", "n_requests", "n_success",
                      "n_fail", "total_idle", "startup_end", "executed",
                      "overflow", "n_trace"):
                want = to_numpy(getattr(expect, f))[r]
                have = len(got["trace"]) if f == "n_trace" else got[f]
                np.testing.assert_array_equal(have, want, err_msg=f"{msg} {f}")
            tr = to_numpy(expect.trace)[r][:len(got["trace"])]
            np.testing.assert_array_equal(
                np.asarray(got["trace"], np.int32).reshape(-1, 4), tr,
                err_msg=f"{msg} trace")
            if by_oracle and int(row["max_events"]) == INF32:
                want = porc.simulate_oracle(
                    ptopo, int(row["W"]), int(row["seed"]),
                    lam_local=int(row["lam_local"]),
                    lam_remote=int(row["lam_remote"]),
                    theta_static=int(row["theta_static"]),
                    theta_comm=int(row["theta_comm"]), mwt=mwt,
                    remote_prob=0.3, max_events=cfg.max_events)
                # the oracle keeps Python ints where the engine wraps int32:
                # it answers the rows whose values all fit (where the sums
                # wrap, total_idle passes 2**31 and the two part)
                fields = ("makespan", "n_events", "n_requests", "n_success",
                          "n_fail", "total_idle", "startup_end", "executed",
                          "overflow")
                if all(np.all(np.abs(np.asarray(getattr(want, f),
                                                np.int64)) < 2**31)
                       for f in fields):
                    oracle_rows += 1
                    for f in fields:
                        np.testing.assert_array_equal(
                            got[f], getattr(want, f),
                            err_msg=f"{msg} oracle {f}")
        if W > 2**30:
            assert wraps > 0, "no running sum wrapped: the case is too small"
        else:
            assert oracle_rows == (3 if by_oracle else 0)


# ---------------------------------------------------------------------------
# The variant rule.
# ---------------------------------------------------------------------------

def test_variant_rule():
    for p in range(2, ws.MAX_P + 1):
        name, k = ws.variant(p)
        assert name == "registers" and k in ws.REG_SLOTS
        assert 32 * k >= p and (k == 1 or 16 * k < p)
    for p in (0, 1, ws.MAX_P + 1):
        with pytest.raises(ValueError):
            ws.variant(p)
    assert ws.MAX_P == 1024 and ws.VARIANTS == ("registers",)


def test_launcher_instantiates_every_slot_count():
    """The C launcher has a case for each K of REG_SLOTS, each launching the
    kernel at that K, and no other case."""
    text = (_build.CSRC / "ws_sim.cu").read_text()
    reg = re.findall(r"case (\d+): return launch_kernel\("
                     r"ws_sim_reg_kernel<MODEL, (\d+)>", text)
    assert all(a == b for a, b in reg)
    assert sorted(int(a) for a, _ in reg) == sorted(ws.REG_SLOTS)
    assert len(re.findall(r"\bcase \d+:", text)) == len(ws.REG_SLOTS)


def test_variant_counts_and_slab_layout():
    ws.reset_counts()
    assert ws.ws_sim_cuda.launches_by_variant == {"registers": 0}
    from repro_torch.core import adaptive as pad
    from repro_torch.core import topology as PT
    model = pad.AdaptiveModel(pad.AdaptiveEngineConfig(
        topology=PT.one_cluster(33, 1), pool_cap=8191, deque_cap=1))
    # pool entries of two words, then the deques; rows on 16 bytes
    assert ws.slab_words(model) == 2 * 8191 + 33 + 1
