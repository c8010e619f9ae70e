"""The port's self-healing dispatch (``repro_torch.service.resilience``:
circuit breaker, fallback chain, bisection salvage) and the broker's locks,
held against the JAX package's where both can run the same thing.

The device rule decides the chain: a dispatch whose tensors lie on a CUDA
device runs on its primary alone, and only a CPU dispatch may demote
``torch`` to ``oracle``. The chain for a CUDA device is built here without a
launch."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import backend as jbk
from repro.core import dag_gen as jgen
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro.service import ResultStore as JaxStore
from repro.service import SimulationService as JaxService
from repro.service import resilience as jrz
from repro.service import store as jstore_mod
from repro_torch import obs
from repro_torch.core import backend as bk
from repro_torch.core import dag_gen as gen
from repro_torch.core.sweep import grid_rows, resolve_model
from repro_torch.service import ResultStore, SimulationService
from repro_torch.service import resilience as rz
from test_torch_common import (assert_grids_equal,
                               frozen_zip_clock,  # noqa: F401 (a fixture)
                               port_topology)

JTOPO = JT.one_cluster(4, 2)
TOPO = port_topology(JTOPO)
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True)
def _mask_ambient_plan():
    """Each test scripts its own faults; an environment plan must not leak
    into in-process assertions."""
    with rz.fault_plan(rz.no_faults()), jrz.fault_plan(jrz.no_faults()):
        yield
    rz.reload_env_plan()
    jrz.reload_env_plan()


def _model(**kw):
    args = dict(W_list=[2000], lam_list=[2], pow2_max_events=True)
    args.update(kw)
    return resolve_model(TOPO, "divisible", **args)


def _jmodel(**kw):
    args = dict(W_list=[2000], lam_list=[2], pow2_max_events=True)
    args.update(kw)
    return jsw.resolve_model(JTOPO, "divisible", **args)


# ---------------------------------------------------------------------------
# circuit breaker: the same state machine as the JAX package's
# ---------------------------------------------------------------------------

def test_breaker_trip_halfopen_close_cycle():
    m, jm = obs.MetricsRegistry(), jobs.MetricsRegistry()
    br = rz.CircuitBreaker(k_failures=3, cooldown_s=0.3, metrics=m)
    jbr = jrz.CircuitBreaker(k_failures=3, cooldown_s=0.3, metrics=jm)
    assert (rz.BREAKER_CLOSED, rz.BREAKER_HALF_OPEN, rz.BREAKER_OPEN) == \
        (jrz.BREAKER_CLOSED, jrz.BREAKER_HALF_OPEN, jrz.BREAKER_OPEN)
    for b in (br, jbr):
        assert b.allow("torch")
        for _ in range(3):
            b.record_failure("torch")
        assert b.state("torch") == rz.BREAKER_OPEN
        assert not b.allow("torch")
    assert m.snapshot() == jm.snapshot()
    assert m.snapshot()["gauges"]["resilience.breaker_state{backend=torch}"] \
        == 1.0
    time.sleep(0.35)
    for b in (br, jbr):
        assert b.state("torch") == rz.BREAKER_HALF_OPEN
        assert b.allow("torch")              # one probe...
        assert not b.allow("torch")          # ...per window
        b.record_success("torch")
        assert b.state("torch") == rz.BREAKER_CLOSED and b.allow("torch")
    assert m.snapshot() == jm.snapshot()


def test_breaker_failed_probe_reopens():
    br = rz.CircuitBreaker(k_failures=1, cooldown_s=0.3)
    br.record_failure("b")
    time.sleep(0.35)
    assert br.allow("b")
    br.record_failure("b")
    assert br.state("b") == rz.BREAKER_OPEN and not br.allow("b")


def test_decorrelated_jitter_bounds_match():
    import random
    for prev in (0.01, 0.05, 0.2, 1.0):
        a = rz.decorrelated_jitter(prev, 0.05, 0.5, random.Random(3))
        b = jrz.decorrelated_jitter(prev, 0.05, 0.5, random.Random(3))
        assert a == b and 0.05 <= a <= 0.5


# ---------------------------------------------------------------------------
# the chain and the device rule
# ---------------------------------------------------------------------------

def test_chain_on_the_cpu_demotes_torch_to_oracle():
    assert rz.FALLBACK_ORDER == ("torch", "oracle")
    assert rz.fallback_chain("torch", _model(), "cpu") == ["torch", "oracle"]
    assert rz.fallback_chain("oracle", _model(), "cpu") == ["oracle",
                                                            "torch"]


def test_chain_excludes_an_oracle_that_cannot_twin_the_model():
    dag = resolve_model(TOPO, "dag", W_list=[100], lam_list=[2],
                        dag=gen.binary_tree(4))
    adaptive = resolve_model(TOPO, "adaptive", W_list=[2000], lam_list=[2])
    for m in (_model(log_trace=True, max_trace=8), dag, adaptive):
        assert rz.fallback_chain("torch", m, "cpu") == ["torch"]
    # the same compatibility rule as the JAX package's, model for model
    jdag = jsw.resolve_model(JTOPO, "dag", W_list=[100], lam_list=[2],
                             dag=jgen.binary_tree(4))
    for pm, jm in ((_model(), _jmodel()), (dag, jdag),
                   (_model(log_trace=True, max_trace=8),
                    _jmodel(log_trace=True, max_trace=8))):
        assert rz.backend_compatible(bk.get_backend("oracle"), pm) == \
            jrz.backend_compatible(jbk.get_backend("oracle"), jm)


@pytest.mark.parametrize("primary", ["torch", "cuda"])
def test_a_dispatch_with_cuda_tensors_has_its_primary_alone(primary):
    """Built for device="cuda" without a launch: nothing on the card gives
    way to the plain loop or to the host."""
    assert rz.fallback_chain(primary, _model(), "cuda") == [primary]
    assert rz.fallback_chain(primary, _model(), "cuda:0") == [primary]


def test_the_cuda_backend_never_gives_way_on_the_cpu_either():
    assert rz.fallback_chain("cuda", _model(), "cpu") == ["cuda"]


def _always_failing_dispatch(calls):
    def dispatch(model, rows, rp, backend=None, ev_budget=None):
        calls.append((backend, len(rows)))
        raise rz.InjectedFault(f"{backend} down")
    return dispatch


def test_a_broker_on_a_cuda_device_never_demotes(tmp_path):
    """A broker built for device="cuda" (no launch: its dispatch callable
    fails every call) retries and bisects on its primary, then raises; it
    never calls torch or oracle."""
    from repro_torch.service.broker import QueryBroker, SimQuery
    calls = []
    cfg = rz.ResilienceConfig(
        retry=rz.RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0),
        breaker_failures=10_000)
    b = QueryBroker(store=ResultStore(root=tmp_path), lock_wait_s=None,
                    dispatch=_always_failing_dispatch(calls),
                    metrics=obs.MetricsRegistry(), resilience=cfg,
                    device="cuda")
    assert b.default_backend == "cuda"
    b.submit(SimQuery(model=_model(), W_list=(2000,), lam_list=(2,),
                      reps=4))
    with pytest.raises(rz.InjectedFault):
        b.flush()
    # two attempts at 4 rows, at the left half, at its left row: then the
    # error propagates
    assert calls == [("cuda", 4)] * 2 + [("cuda", 2)] * 2 + [("cuda", 1)] * 2
    assert b.n_dispatches == 0 and not list(tmp_path.glob("*.npz"))


def test_a_cpu_broker_demotes_torch_to_oracle(tmp_path, frozen_zip_clock):
    plan = rz.FaultPlan(sites={"backend.run_rows": rz.Prob(
        1.0, match={"backend": "torch"})})
    m = obs.MetricsRegistry()
    svc = SimulationService(root=tmp_path / "f", device="cpu", metrics=m,
                            resilience=rz.ResilienceConfig(
                                retry=rz.RetryPolicy(max_attempts=1),
                                salvage=False))
    oracle = bk.get_backend("oracle")
    before = oracle.n_run_rows
    with rz.fault_plan(plan):
        r = svc.query(TOPO, W_list=[2000], lam_list=[2], reps=4)
    assert oracle.n_run_rows == before + 1
    assert svc.broker.dispatch_log[0]["degraded"]
    assert m.snapshot()["counters"]["resilience.fallbacks"] == 1
    clean = SimulationService(root=tmp_path / "c", device="cpu")
    c = clean.query(TOPO, W_list=[2000], lam_list=[2], reps=4)
    assert_grids_equal(r.grid, c.grid)
    assert (tmp_path / "f" / f"{r.key}.npz").read_bytes() == \
        (tmp_path / "c" / f"{c.key}.npz").read_bytes()


# ---------------------------------------------------------------------------
# dispatch_resilient: salvage economics, the same calls as the JAX package's
# ---------------------------------------------------------------------------

def _resilient_run(pkg, n_rows, poisoned_seeds, chain, **cfg_kw):
    """Dispatch n_rows through ``pkg.dispatch_resilient`` against a first
    backend that raises whenever its batch holds a poisoned seed; the oracle
    computes everything. Returns (grid, degraded, calls, metrics)."""
    port = pkg is rz
    m = obs.MetricsRegistry() if port else jobs.MetricsRegistry()
    model = _model() if port else _jmodel()
    rows = grid_rows([2000], [2], n_rows)
    oracle = bk.get_backend("oracle") if port else jbk.get_backend("oracle")
    run = (lambda r, b: oracle.run_rows(model, r, 0.25, ev_budget=b,
                                        device="cpu")) if port else \
        (lambda r, b: oracle.run_rows(model, r, 0.25, ev_budget=b))
    calls = []

    def call(rws, buds, name, top):
        calls.append((chain.index(name), len(rws), top))
        if name == chain[0] and set(np.asarray(rws.seed)) & poisoned_seeds:
            raise pkg.InjectedFault("poisoned row")
        return run(rws, buds)

    cfg = pkg.ResilienceConfig(
        retry=pkg.RetryPolicy(max_attempts=1, base_s=0.0, cap_s=0.0),
        breaker_failures=10_000, **cfg_kw)
    grid, degraded = pkg.dispatch_resilient(
        call, rows, None, chain, retry=cfg.retry,
        breaker=cfg.make_breaker(m), metrics=m, salvage=cfg.salvage)
    return grid, degraded, calls, m


@pytest.mark.parametrize("n,bad_row", [(32, 11), (16, 0), (7, 6)])
def test_salvage_one_poisoned_row_costs_log_n(n, bad_row):
    rows = grid_rows([2000], [2], n)
    bad = {int(np.asarray(rows.seed)[bad_row])}
    grid, degraded, calls, m = _resilient_run(rz, n, bad, ["torch", "oracle"])
    jgrid, jdeg, jcalls, jm = _resilient_run(jrz, n, bad, ["jax", "oracle"])
    assert degraded and jdeg
    assert calls == jcalls                   # the same dispatches, in order
    assert_grids_equal(jgrid, grid)
    want = bk.get_backend("oracle").run_rows(_model(), rows, 0.25,
                                             device="cpu")
    assert_grids_equal(want, grid)
    assert len([c for c in calls if c[0] == 0]) <= 2 * (n.bit_length() + 1)
    assert [c[:2] for c in calls if c[0] == 1] == [(1, 1)]
    snap = m.snapshot()["counters"]
    assert snap["resilience.salvaged_rows"] == n - 1
    assert snap["resilience.fallbacks"] == 1
    assert snap == {k.replace("backend=jax", "backend=torch"): v
                    for k, v in jm.snapshot()["counters"].items()}


def test_salvage_disabled_falls_back_whole_batch():
    rows = grid_rows([2000], [2], 16)
    bad = {int(np.asarray(rows.seed)[3])}
    _, degraded, calls, m = _resilient_run(rz, 16, bad, ["torch", "oracle"],
                                           salvage=False)
    assert degraded and (1, 16, False) in calls
    assert m.snapshot()["counters"].get("resilience.salvaged_rows", 0) == 0


def test_clean_dispatch_is_one_call():
    _, degraded, calls, m = _resilient_run(rz, 8, set(), ["torch", "oracle"])
    assert not degraded and calls == [(0, 8, True)]
    assert "resilience.fallbacks" not in m.snapshot()["counters"]


def test_a_chain_of_one_salvages_then_raises():
    """On the card the chain is the primary alone: the clean rows are
    salvaged by bisection, and the poisoned row's error propagates."""
    rows = grid_rows([2000], [2], 8)
    bad = {int(np.asarray(rows.seed)[5])}
    with pytest.raises(rz.InjectedFault):
        _resilient_run(rz, 8, bad, ["cuda"])


def test_non_recoverable_errors_propagate():
    assert rz.NON_RECOVERABLE == jrz.NON_RECOVERABLE
    assert rz.non_recoverable_names() == jrz.non_recoverable_names()
    m = obs.MetricsRegistry()
    rows = grid_rows([2000], [2], 4)
    calls = []

    def call(rws, buds, name, top):
        calls.append(name)
        raise ValueError("config bug")

    cfg = rz.ResilienceConfig()
    with pytest.raises(ValueError):
        rz.dispatch_resilient(call, rows, None, ["torch", "oracle"],
                              retry=cfg.retry, breaker=cfg.make_breaker(m),
                              metrics=m)
    assert calls == ["torch"]                # no retry, no demotion


def test_an_exhausted_chain_reraises():
    m = obs.MetricsRegistry()
    rows = grid_rows([2000], [2], 1)

    def call(rws, buds, name, top):
        raise rz.InjectedFault(f"{name} down")

    cfg = rz.ResilienceConfig(
        retry=rz.RetryPolicy(max_attempts=1, base_s=0.0, cap_s=0.0))
    with pytest.raises(rz.InjectedFault):
        rz.dispatch_resilient(call, rows, None, ["torch", "oracle"],
                              retry=cfg.retry, breaker=cfg.make_breaker(m),
                              metrics=m)


# ---------------------------------------------------------------------------
# the chaos run: 20 % of rows poisoned, byte-identical artifacts
# ---------------------------------------------------------------------------

def test_chaos_run_zero_exceptions_byte_identical(tmp_path,
                                                  frozen_zip_clock):
    cfg = rz.ResilienceConfig(
        retry=rz.RetryPolicy(max_attempts=1, base_s=0.0, cap_s=0.0),
        breaker_failures=10_000)

    def queries(svc, topo, backend):
        return [svc.make_query(topo, W_list=[2000], lam_list=[3], reps=1,
                               seed0=s, backend=backend)
                for s in range(1, 61)]

    m0 = obs.MetricsRegistry()
    svc0 = SimulationService(root=tmp_path / "a", metrics=m0, resilience=cfg,
                             device="cpu")
    r0 = svc0.query_many(queries(svc0, TOPO, "torch"))
    plan = rz.FaultPlan(rng_seed=7, sites={
        "backend.run_rows": rz.Prob(0.2, kind="raise", per_row=True,
                                    match={"backend": "torch"})})
    m1 = obs.MetricsRegistry()
    svc1 = SimulationService(root=tmp_path / "b", metrics=m1, resilience=cfg,
                             device="cpu")
    with rz.fault_plan(plan):
        r1 = svc1.query_many(queries(svc1, TOPO, "torch"))   # must not raise
    # and the JAX package's clean answers to the same questions
    js = JaxService(root=tmp_path / "j")
    rj = js.query_many(queries(js, JTOPO, "jax"))
    assert len(r0) == len(r1) == len(rj) == 60
    for a, b, c in zip(r0, r1, rj):
        assert a.key == b.key == c.key
        np.testing.assert_array_equal(a.cells.mean, b.cells.mean)
        assert_grids_equal(c.grid, b.grid)
    files = [sorted((tmp_path / d).glob("*.npz")) for d in "abj"]
    assert [p.name for p in files[0]] == [p.name for p in files[1]] == \
        [p.name for p in files[2]]
    for pa, pb, pj in zip(*files):
        assert pa.read_bytes() == pb.read_bytes() == pj.read_bytes(), pa.name
    st = svc1.stats()
    counters = st["metrics"]["counters"]
    assert counters.get("resilience.fallbacks", 0) > 0
    assert counters.get("resilience.salvaged_rows", 0) > 0
    assert st["degraded"]["degraded"]
    assert any(e["degraded"] for e in svc1.broker.dispatch_log)
    assert not svc0.stats()["degraded"]["degraded"]


def test_resilience_disabled_propagates_faults(tmp_path):
    svc = SimulationService(root=tmp_path, device="cpu",
                            resilience=rz.ResilienceConfig(enabled=False))
    plan = rz.FaultPlan(sites={
        "backend.run_rows": rz.Prob(1.0, match={"backend": "torch"})})
    with rz.fault_plan(plan):
        with pytest.raises(rz.InjectedFault):
            svc.query(TOPO, W_list=[1000], lam_list=[2], reps=2)


def test_a_transient_broker_dispatch_fault_is_retried(tmp_path):
    svc = SimulationService(root=tmp_path, device="cpu",
                            metrics=obs.MetricsRegistry())
    plan = rz.FaultPlan(sites={"broker.dispatch": rz.At(0)})
    torch_be = bk.get_backend("torch")
    before = torch_be.n_run_rows
    with rz.fault_plan(plan):
        r = svc.query(TOPO, W_list=[1000], lam_list=[2], reps=2)
    assert torch_be.n_run_rows == before + 1
    assert svc.broker.dispatch_log[0]["degraded"]
    assert svc.stats()["degraded"]["retries"] == 1
    assert np.isfinite(r.cells.mean).all()


# ---------------------------------------------------------------------------
# locks: the broker's in-flight dedup, across the two packages too
# ---------------------------------------------------------------------------

_HOLDER_CRASH = """
import os, sys
sys.path.insert(0, {src!r})
from repro_torch.service.store import ResultStore
store = ResultStore(root={root!r}, lock_stale_s=300.0)
assert store.try_lock({key!r})
print("LOCKED", flush=True)
os._exit(0)          # crash while holding: no unlock, no cleanup
"""


def test_killed_lock_holder_unblocks_service_query(tmp_path):
    root = tmp_path / "store"
    svc = SimulationService(root=root, lock_wait_s=30.0, device="cpu")
    svc.store.lock_stale_s = 300.0
    q = svc.make_query(TOPO, W_list=[1000], lam_list=[2], reps=2)
    out = subprocess.run(
        [sys.executable, "-c",
         _HOLDER_CRASH.format(src=SRC, root=str(root), key=q.key())],
        capture_output=True, text=True, timeout=120)
    assert "LOCKED" in out.stdout, out.stderr
    assert (root / f"{q.key()}.lock").exists()
    t0 = time.monotonic()
    res = svc.query_many([q])[0]             # must not wait lock_wait_s
    assert time.monotonic() - t0 < 5.0
    assert svc.store.locks_broken == 1 and svc.n_dispatches == 1
    assert np.isfinite(res.cells.mean).all()


def test_port_broker_waits_for_the_jax_packages_lock(tmp_path,
                                                     frozen_zip_clock,
                                                     monkeypatch):
    """One store layout: a JAX process holding ``<key>.lock`` makes the
    port's broker wait, and the port then serves the JAX package's answer
    with no dispatch. The JAX side's answer lands during the port's first
    poll sleep (driven through the broker's clock, not a thread)."""
    from repro_torch.service import broker as broker_mod
    root = tmp_path / "shared"
    jstore = JaxStore(root=root)
    js = JaxService(root=tmp_path / "elsewhere")
    ps = SimulationService(root=root, lock_wait_s=30.0, device="cpu")
    monkeypatch.setattr(broker_mod, "LOCK_POLL_S", 0.001)
    jq = js.make_query(JTOPO, W_list=[2000], lam_list=[2, 5], reps=4)
    pq = ps.make_query(TOPO, W_list=[2000], lam_list=[2, 5], reps=4)
    assert jq.key() == pq.key()
    answer = js.query_many([jq])[0]
    assert jstore.try_lock(jq.key())         # the JAX process computes...

    def land_then_sleep(s):
        if not jstore.contains(jq.key()):    # ...and its answer lands
            jstore.put(jq.key(), answer.grid,
                       meta={"grid": jq.grid_dict(),
                             "model": jstore_mod.canonical_model(jq.model)})
            jstore.unlock(jq.key())

    monkeypatch.setattr(broker_mod.time, "sleep", land_then_sleep)
    res = ps.query_many([pq])[0]
    assert ps.broker.n_lock_waits == 1 and ps.broker.n_lock_served == 1
    assert ps.n_dispatches == 0 and res.from_cache
    assert_grids_equal(answer.grid, res.grid)
    np.testing.assert_array_equal(answer.cells.mean, res.cells.mean)


def test_broker_lock_wait_times_out_and_computes(tmp_path, monkeypatch):
    from repro_torch.service import broker as broker_mod
    m = obs.MetricsRegistry()
    svc = SimulationService(root=tmp_path, metrics=m, lock_wait_s=0.3,
                            device="cpu")
    monkeypatch.setattr(broker_mod, "LOCK_POLL_S", 0.01)
    q = svc.make_query(TOPO, W_list=[1000], lam_list=[2], reps=2)
    assert svc.store.try_lock(q.key())       # our own live pid: it waits
    res = svc.query_many([q])[0]             # times out, then computes
    assert np.isfinite(res.cells.mean).all() and svc.n_dispatches == 1
    assert m.snapshot()["counters"]["broker.lock_polls"] >= 2
    svc.store.unlock(q.key())


def test_stale_break_has_a_single_winner(tmp_path):
    """Three racers — the port's store, the JAX package's, the port's —
    find one stale lock (its mtime pinned a minute back). Driven in a fixed
    order, with no thread or process timing: the first breaks it and wins;
    the others then find a fresh lock and lose. A racer that finds another
    racer's break mutex loses too, and leaves the stale lock to it."""
    root = tmp_path / "store"
    key = "cafef00d"
    lock = root / f"{key}.lock"
    holder = ResultStore(root=root, lock_stale_s=0.5)
    racers = [ResultStore(root=root, lock_stale_s=0.5),
              JaxStore(root=root, lock_stale_s=0.5),
              ResultStore(root=root, lock_stale_s=0.5)]
    old = time.time() - 60
    for first in range(3):
        assert holder.try_lock(key)          # a live-pid lock...
        os.utime(lock, (old, old))           # ...made stale by age
        order = racers[first:] + racers[:first]
        outs = ["WON" if r.try_lock(key) else "LOST" for r in order]
        assert outs == ["WON", "LOST", "LOST"], (first, outs)
        assert sum(r.locks_broken for r in racers) == first + 1
        order[0].unlock(key)
        assert not lock.with_suffix(".lock-break").exists()
    # another breaker's mutex in place: every racer loses, the lock stays
    assert holder.try_lock(key)
    os.utime(lock, (old, old))
    brk = lock.with_suffix(".lock-break")
    brk.touch()
    assert [r.try_lock(key) for r in racers] == [False, False, False]
    assert lock.exists() and brk.exists()
    brk.unlink()
    holder.unlock(key)
