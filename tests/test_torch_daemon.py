"""The port's simulation daemon (``repro_torch.service.daemon``, ``client``,
``wire``) on the CPU: a twin of every test of ``tests/test_daemon.py`` with
``device="cpu"`` (``--device cpu`` for the command line), then the two
packages against each other — a JAX client answered by a port daemon and a
port client by a JAX daemon, each with one dispatch and the same keys and
npz bytes as library mode; frames, grids and history sidecars readable by
either side. Tolerance: none, every comparison is exact.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import one_cluster as jone_cluster
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro import service as jsvc
from repro.service import broker as jbroker
from repro.service import estimator as jest
from repro.service import resilience as jrz
from repro.service import wire as jwire
from repro_torch.core import one_cluster
from repro_torch.core import topology as PT
from repro_torch.core.sweep import run_grid
from repro_torch.service import (AdaptivePolicy, DaemonClient,
                                 DaemonUnavailable, PairedPolicy,
                                 QuantilePolicy, ResultStore,
                                 SimulationDaemon, SimulationService)
from repro_torch.service import resilience as rz
from repro_torch.service import wire
from repro_torch.service.broker import EventHistory
from repro_torch.service.daemon import PROTOCOL_VERSION

from test_torch_common import assert_grids_equal, frozen_zip_clock  # noqa: F401

TOPO = one_cluster(4, 2)
JTOPO = jone_cluster(4, 2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _mask_ambient_plan():
    """An environment fault plan must not kill the in-process daemon
    threads (of either package); subprocesses still inherit the env."""
    rz.install(None)
    jrz.install(None)
    yield
    rz.install(None)
    jrz.install(None)


def _src():
    return str(ROOT / "src")


@pytest.fixture()
def daemon(tmp_path):
    d = SimulationDaemon(root=tmp_path / "store", coalesce_window_s=0.01,
                         device="cpu").start()
    yield d
    d.stop()


def _same_npz(a: Path, b: Path, key: str):
    assert (a / f"{key}.npz").read_bytes() == (b / f"{key}.npz").read_bytes()


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_wire_framing_roundtrip():
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, {"op": "ping", "x": [1, 2, 3]})
        wire.send_frame(a, {"op": "second"})
        assert wire.recv_frame(b) == {"op": "ping", "x": [1, 2, 3]}
        assert wire.recv_frame(b) == {"op": "second"}
        a.close()
        assert wire.recv_frame(b) is None          # clean EOF
    finally:
        b.close()


def test_wire_truncated_frame_raises():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x01\x00partial")      # announces 256, sends 7
        a.close()
        with pytest.raises(wire.WireError):
            wire.recv_frame(b)
    finally:
        b.close()


def test_wire_oversized_frame_refused():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\xff\xff\xff\xff")             # 4 GiB announcement
        with pytest.raises(wire.WireError):
            wire.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_wire_topology_and_grid_roundtrip():
    topo2 = wire.decode_topology(wire.encode_topology(TOPO))
    assert topo2 == TOPO                           # content-based eq

    g = run_grid(TOPO, W_list=[800], lam_list=[2], reps=3, device="cpu")
    g2 = wire.decode_grid(wire.encode_grid(g))
    assert g2.p == g.p
    for f in ("W", "lam", "seed", "makespan", "overflow"):
        assert np.array_equal(np.asarray(getattr(g, f)),
                              np.asarray(getattr(g2, f))), f
    assert set(g2.extras) == set(g.extras)


def test_wire_rejects_unserializable_query():
    with pytest.raises(wire.WireError):
        wire.encode_query_spec(TOPO, {"dag": np.zeros(3)})
    with pytest.raises(wire.WireError):
        wire.encode_query_spec(object(), {})


def test_wire_policy_roundtrip():
    for pol in (AdaptivePolicy(ci_half_width=0.5, relative=True),
                QuantilePolicy(ci_half_width=1.0, quantiles=(0.5, 0.9)),
                PairedPolicy(batch_reps=8), None):
        assert wire.decode_policy(wire.encode_policy(pol)) == pol


# ---------------------------------------------------------------------------
# EventHistory persistence
# ---------------------------------------------------------------------------

def test_event_history_json_roundtrip():
    h = EventHistory(alpha=0.3)
    cols = np.array([[100, 2, 2, 0, 0], [200, 2, 2, 0, 0]], np.int64)
    h.observe("sig-a", cols, np.array([10.0, 20.0]))
    h.observe("sig-b", cols[:1], np.array([7.5]))
    h2 = EventHistory.from_json(h.to_json())
    assert h2.alpha == h.alpha and h2._ema == h._ema
    # corrupt / foreign docs load empty, never raise
    assert len(EventHistory.from_json({})) == 0
    assert len(EventHistory.from_json({"version": 99, "ema": [[1]]})) == 0
    assert len(EventHistory.from_json({"version": 1,
                                       "ema": [["s", "x", 1.0]]})) == 0


def test_history_survives_daemon_restart(tmp_path, daemon):
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    c.query(TOPO, W_list=[600, 1200], lam_list=[2], reps=3)
    assert len(daemon.service.broker.history) > 0
    daemon.stop()
    sidecar = tmp_path / "store" / "history.json"
    assert sidecar.exists()
    doc = json.loads(sidecar.read_text())
    assert doc["version"] == 1 and len(doc["ema"]) > 0

    d2 = SimulationDaemon(root=tmp_path / "store", device="cpu")
    try:
        # warm before the first dispatch: loaded, not re-observed
        assert len(d2.service.broker.history) == len(doc["ema"])
    finally:
        d2.stop()


# ---------------------------------------------------------------------------
# daemon round trips (in-process daemon, real unix socket)
# ---------------------------------------------------------------------------

def test_daemon_query_matches_library_mode(tmp_path, daemon,
                                           frozen_zip_clock):  # noqa: F811
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    assert c.alive()
    r = c.query(TOPO, W_list=[500, 1000], lam_list=[2], reps=4)
    svc = SimulationService(root=tmp_path / "lib", device="cpu")
    rl = svc.query(TOPO, W_list=[500, 1000], lam_list=[2], reps=4)
    assert r.key == rl.key
    assert np.array_equal(np.asarray(r.grid.makespan),
                          np.asarray(rl.grid.makespan))
    assert np.allclose(r.cells.mean, rl.cells.mean)
    # identical artifact bytes on disk (the zip clock pinned)
    _same_npz(tmp_path / "store", tmp_path / "lib", r.key)
    # repeat is a daemon-side cache hit
    assert c.query(TOPO, W_list=[500, 1000], lam_list=[2],
                   reps=4).from_cache


def test_daemon_adaptive_and_pair(tmp_path, daemon):
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    r = c.query(TOPO, W_list=[800], lam_list=[2], ci=5.0, batch_reps=8,
                max_reps=64)
    assert r.n_rounds >= 1 and r.cells.n.min() >= 8

    topo_b = TOPO.with_strategy(1, remote_prob=0.5)
    qa = c.make_query(TOPO, W_list=[500], lam_list=[2], reps=6)
    qb = c.make_query(topo_b, W_list=[500], lam_list=[2], reps=6)
    pr = c.query_pair(qa, qb)
    svc = SimulationService(root=tmp_path / "lib", device="cpu")
    prl = svc.query_pair(svc.make_query(TOPO, W_list=[500], lam_list=[2],
                                        reps=6),
                         svc.make_query(topo_b, W_list=[500], lam_list=[2],
                                        reps=6))
    assert pr.key == prl.key
    assert np.array_equal(np.asarray(pr.paired.delta_mean),
                          np.asarray(prl.paired.delta_mean))


def test_daemon_sweep_chunks_match_library(tmp_path, daemon):
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    g = c.sweep(TOPO, W_list=[200, 400], lam_list=[2], reps=3,
                chunk_size=4)
    svc = SimulationService(root=tmp_path / "lib", device="cpu")
    gl = svc.sweep(TOPO, W_list=[200, 400], lam_list=[2], reps=3,
                   chunk_size=4)
    assert np.array_equal(np.asarray(g.makespan), np.asarray(gl.makespan))
    # chunks landed under library-compatible chunk keys: a library-mode
    # sweep over the daemon's store recomputes nothing
    before = daemon.service.store.stats()["puts"]
    svc2 = SimulationService(root=tmp_path / "store", device="cpu")
    g2 = svc2.sweep(TOPO, W_list=[200, 400], lam_list=[2], reps=3,
                    chunk_size=4)
    assert np.array_equal(np.asarray(g2.makespan), np.asarray(gl.makespan))
    assert daemon.service.store.stats()["puts"] == before


def test_daemon_stats_payload(tmp_path, daemon):
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    c.query(TOPO, W_list=[300], lam_list=[2], reps=2)
    st = c.stats()
    d = st["daemon"]
    assert d["protocol"] == PROTOCOL_VERSION
    assert d["n_rounds"] >= 1 and d["n_rpcs"] >= 3
    assert d["pending"] == 0 and d["max_pending"] > 0
    assert st["n_dispatches"] >= 1 and st["device"] == "cpu"
    assert "metrics" in st and "counters" in st["metrics"]
    assert st["metrics"]["counters"].get("daemon.rounds")


def test_socket_path_names_the_rendezvous(tmp_path):
    """A daemon on a socket outside its store root is reached by a client
    given the same path, and by no other."""
    sock = tmp_path / "elsewhere.sock"
    d = SimulationDaemon(socket_path=sock, root=tmp_path / "store",
                         coalesce_window_s=0.01, device="cpu").start()
    try:
        assert d.socket_path == sock and sock.exists()
        assert not DaemonClient(root=tmp_path / "store").alive()
        c = DaemonClient(root=tmp_path / "store", socket_path=sock,
                         fallback=False)
        r = c.query(TOPO, W_list=[300], lam_list=[2], reps=2)
        assert c.n_daemon_answers == 1 and np.isfinite(r.cells.mean).all()
    finally:
        d.stop()
    assert not sock.exists()


def test_accept_loop_ends_without_a_wakeup(tmp_path):
    """A stop ends the accept loop also where the kernel wakes a blocked
    ``accept()`` neither on ``shutdown()`` nor on ``close()`` of the
    listener: the listener's accept timeout re-reads the running flag."""
    from repro_torch.service.daemon import ACCEPT_POLL_S
    d = SimulationDaemon(root=tmp_path / "store", device="cpu").start()
    try:
        assert d._sock.gettimeout() == ACCEPT_POLL_S
        with d._cond:                    # what stop() sets before it
            d._running = False           # touches the listener
        d._accept_thread.join(timeout=8 * ACCEPT_POLL_S)
        assert not d._accept_thread.is_alive()
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# admission control + fairness
# ---------------------------------------------------------------------------

def test_admission_soft_reject_and_recovery(tmp_path):
    d = SimulationDaemon(root=tmp_path / "store", max_pending=1,
                         coalesce_window_s=0.01, device="cpu").start()
    try:
        spec = wire.encode_query_spec(TOPO, {"W_list": [300],
                                             "lam_list": [2], "reps": 2})
        # occupy the single admission slot: submit without flushing
        hog = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            hog.connect(str(d.socket_path))
            wire.send_frame(hog, {"op": "submit", "query": spec})
            assert wire.recv_frame(hog)["ok"]

            c = DaemonClient(root=tmp_path / "store", fallback=False,
                             retry=rz.RetryPolicy(max_attempts=2,
                                                  base_s=0.001,
                                                  cap_s=0.002))
            with pytest.raises(DaemonUnavailable):
                c.query(TOPO, W_list=[300], lam_list=[2], reps=2)
            assert c.n_busy_retries >= 1
            assert d.n_busy_rejections >= 1

            # the busy frame itself carries the backpressure contract
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(str(d.socket_path))
                wire.send_frame(probe, {"op": "submit", "query": spec})
                resp = wire.recv_frame(probe)
                assert resp["status"] == "busy" and not resp["ok"]
                assert resp["retry_after_s"] > 0
            finally:
                probe.close()
        finally:
            hog.close()                    # disconnect frees the slot

        deadline = time.monotonic() + 5.0
        while d._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        c2 = DaemonClient(root=tmp_path / "store", fallback=False)
        r = c2.query(TOPO, W_list=[300], lam_list=[2], reps=2)
        assert np.isfinite(r.cells.mean).all()
    finally:
        d.stop()


def test_round_robin_fairness_split_rounds(tmp_path):
    """A client with many queries cannot monopolize a round: the drain is
    round-robin per client with max_round_queries per round."""
    d = SimulationDaemon(root=tmp_path / "store", max_round_queries=2,
                         coalesce_window_s=0.05, device="cpu").start()
    try:
        c = DaemonClient(root=tmp_path / "store", fallback=False)
        qs = [c.make_query(TOPO, W_list=[100 * (i + 1)], lam_list=[2],
                           reps=2) for i in range(5)]
        out = c.query_many(qs)
        assert len(out) == 5
        assert all(np.isfinite(r.cells.mean).all() for r in out)
        assert d.n_rounds >= 3               # 5 queries / cap 2
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# acceptance: 3 client processes, identical query -> 1 dispatch,
# byte-identical artifacts vs library mode
# ---------------------------------------------------------------------------

_CLIENT = """
import os, sys, time
sys.path.insert(0, {src!r})
from repro_torch.core import one_cluster
from repro_torch.service import DaemonClient
client = DaemonClient(root={root!r}, fallback=False)
assert client.alive()
print("READY", flush=True)
go = {go!r}
while not os.path.exists(go):
    time.sleep(0.001)
r = client.query(one_cluster(4, 2), W_list=[500, 1000], lam_list=[2],
                 reps=4, seed0=7)
assert r.cells.mean.shape == (2,)
print("KEY", r.key, flush=True)
"""


def test_three_clients_one_dispatch_byte_identical(tmp_path,
                                                   frozen_zip_clock):  # noqa: F811,E501
    root = tmp_path / "store"
    d = SimulationDaemon(root=root, coalesce_window_s=0.25,
                         device="cpu").start()
    try:
        go = tmp_path / "go"
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             _CLIENT.format(src=_src(), root=str(root), go=str(go))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _ in range(3)]
        for p in procs:                      # barrier: all connected
            assert p.stdout.readline().strip() == "READY"
        go.touch()                           # all three flush together
        outs = [p.communicate(timeout=300) for p in procs]
        assert all(p.returncode == 0 for p in procs), \
            [o[1][-2000:] for o in outs]
        keys = {o[0].split("KEY ", 1)[1].strip() for o in outs}
        assert len(keys) == 1                # identical question
        (key,) = keys
        # N processes, ONE dispatch: coalesced in a shared round (or
        # served from the round-1 artifact — never recomputed).
        assert d.service.broker.n_dispatches == 1
        assert d.n_rounds >= 1
    finally:
        d.stop()

    # byte-identical to library mode computing the same query cold
    svc = SimulationService(root=tmp_path / "lib", device="cpu")
    rl = svc.query(one_cluster(4, 2), W_list=[500, 1000], lam_list=[2],
                   reps=4, seed0=7)
    assert rl.key == key
    _same_npz(tmp_path / "lib", root, key)


# ---------------------------------------------------------------------------
# acceptance: daemon killed mid-round -> clients fall back, zero exceptions
# ---------------------------------------------------------------------------

def test_daemon_killed_mid_round_clients_fall_back(tmp_path):
    root = tmp_path / "store"
    env = dict(os.environ)
    env["PYTHONPATH"] = _src() + os.pathsep + env.get("PYTHONPATH", "")
    # os._exit(17) at the dispatch site == kill -9 mid-round: no unwind,
    # no response frames, sockets drop.
    env["REPRO_WS_FAULT_PLAN"] = json.dumps(
        {"sites": {"broker.dispatch": {"kind": "exit"}}})
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service.daemon",
         "--root", str(root), "--coalesce-window-s", "0.01",
         "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("READY"), proc.stderr.read()
        # Reap the daemon the moment it dies: a zombie's pid still answers
        # kill(pid, 0), so the store locks of its last round would look
        # held by a live process until the clients' lock wait (60 s) ran
        # out; a reaped pid lets them break those locks at once.
        threading.Thread(target=proc.wait, daemon=True).start()

        results, errors = [], []

        def ask(i):
            try:
                c = DaemonClient(root=root, rpc_timeout_s=60.0, device="cpu")
                r = c.query(TOPO, W_list=[400 + 100 * i], lam_list=[2],
                            reps=3)
                results.append((i, r, c.n_fallbacks))
            except Exception as e:         # noqa: BLE001 — the assertion
                errors.append((i, e))

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors                  # ZERO client-visible exceptions
        assert len(results) == 2
        assert all(np.isfinite(r.cells.mean).all() for _, r, _ in results)
        assert all(nf >= 1 for _, _, nf in results)   # really fell back
        assert proc.wait(timeout=30) == 17            # daemon really died
    finally:
        proc.kill()
        proc.wait(timeout=10)

    # fallback artifacts are the real thing: a fresh library service
    # answers from the store the fallback filled
    svc = SimulationService(root=root, device="cpu")
    r = svc.query(TOPO, W_list=[400], lam_list=[2], reps=3)
    assert r.from_cache


def test_client_without_daemon_is_library_mode(tmp_path):
    c = DaemonClient(root=tmp_path / "store", device="cpu")  # no listener
    assert not c.alive()
    r = c.query(TOPO, W_list=[500], lam_list=[2], reps=3)
    assert np.isfinite(r.cells.mean).all()
    assert c.n_fallbacks == 1 and c.n_daemon_answers == 0
    assert str(c.local.device) == "cpu"
    with pytest.raises(DaemonUnavailable):
        DaemonClient(root=tmp_path / "store", fallback=False).query(
            TOPO, W_list=[500], lam_list=[2], reps=3)


def test_unserializable_query_uses_library_mode(tmp_path, daemon):
    """Array-valued model kwargs cannot cross the wire; with fallback off
    that is a DaemonUnavailable at *encode* time — the daemon is never
    asked to parse what cannot round-trip."""
    c = DaemonClient(root=tmp_path / "store", fallback=False)
    rpcs_before = daemon.n_rpcs
    with pytest.raises(DaemonUnavailable):
        c.query_many([c.make_query(TOPO, dag=np.zeros(3))])
    assert c.n_daemon_answers == 0
    assert daemon.n_rpcs == rpcs_before


# ---------------------------------------------------------------------------
# store touch throttle (hot-loop memory hits are syscall-free)
# ---------------------------------------------------------------------------

def test_memory_hit_touch_is_throttled(tmp_path):
    g = run_grid(TOPO, W_list=[500], lam_list=[2], reps=2, device="cpu")
    store = ResultStore(root=tmp_path, touch_throttle_s=3600.0)
    store.put("k", g)
    old = 1000.0
    os.utime(store._path("k"), (old, old))
    assert store.get("k") is not None            # memory hit...
    assert store._path("k").stat().st_mtime > old   # first touch refreshes
    os.utime(store._path("k"), (old, old))
    for _ in range(50):
        assert store.get("k") is not None
    # throttled: 50 hot-loop hits, zero utime syscalls
    assert store._path("k").stat().st_mtime == old
    assert store.hits_mem == 51

    # throttle 0 restores touch-every-hit
    eager = ResultStore(root=tmp_path, touch_throttle_s=0.0)
    assert eager.get("k") is not None
    os.utime(eager._path("k"), (old, old))
    assert eager.get("k") is not None
    assert eager._path("k").stat().st_mtime > old


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

Q = dict(W_list=[500, 1000], lam_list=[2], reps=4, seed0=7)
SWEEP = dict(W_list=[200, 400], lam_list=[2, 5], reps=3, chunk_size=4)


def test_a_jax_client_is_answered_by_a_port_daemon(tmp_path,
                                                   frozen_zip_clock):  # noqa: F811,E501
    """The JAX package's DaemonClient against the port's daemon: one
    dispatch, and the key, the npz bytes and every sweep chunk of the JAX
    package's library mode."""
    d = SimulationDaemon(root=tmp_path / "store", coalesce_window_s=0.01,
                         device="cpu").start()
    try:
        c = jsvc.DaemonClient(root=tmp_path / "store", fallback=False)
        assert c.alive()
        r = c.query(JTOPO, **Q)
        assert d.service.broker.n_dispatches == 1
        g = c.sweep(JTOPO, **SWEEP)
        puts = d.service.store.stats()["puts"]
    finally:
        d.stop()
    jlib = jsvc.SimulationService(root=tmp_path / "lib")
    rl = jlib.query(JTOPO, **Q)
    assert r.key == rl.key and not rl.from_cache
    assert_grids_equal(r.grid, rl.grid)
    _same_npz(tmp_path / "store", tmp_path / "lib", r.key)
    assert_grids_equal(g, jlib.sweep(JTOPO, **SWEEP))
    # the chunks the port daemon stored serve a JAX sweep with no new put
    jsvc2 = jsvc.SimulationService(root=tmp_path / "store")
    assert_grids_equal(g, jsvc2.sweep(JTOPO, **SWEEP))
    assert jsvc2.store.stats()["puts"] == 0 and puts > 1


def test_a_port_client_is_answered_by_a_jax_daemon(tmp_path,
                                                   frozen_zip_clock):  # noqa: F811,E501
    """The port's DaemonClient against the JAX package's daemon: one
    dispatch, and the key, the npz bytes and every sweep chunk of the
    port's library mode."""
    d = jsvc.SimulationDaemon(root=tmp_path / "store",
                              coalesce_window_s=0.01).start()
    try:
        c = DaemonClient(root=tmp_path / "store", fallback=False)
        assert c.alive()
        r = c.query(TOPO, **Q)
        assert d.service.broker.n_dispatches == 1
        g = c.sweep(TOPO, **SWEEP)
    finally:
        d.stop()
    lib = SimulationService(root=tmp_path / "lib", device="cpu")
    rl = lib.query(TOPO, **Q)
    assert r.key == rl.key and not rl.from_cache
    assert_grids_equal(r.grid, rl.grid)
    np.testing.assert_array_equal(r.cells.mean, rl.cells.mean)
    _same_npz(tmp_path / "store", tmp_path / "lib", r.key)
    assert_grids_equal(g, lib.sweep(TOPO, **SWEEP))
    svc2 = SimulationService(root=tmp_path / "store", device="cpu")
    assert_grids_equal(g, svc2.sweep(TOPO, **SWEEP))
    assert svc2.store.stats()["puts"] == 0


def _json(doc) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


@pytest.mark.parametrize("make", [
    lambda m: m.one_cluster(4, 2),
    lambda m: m.two_clusters(8, 40).with_strategy(m.LOCAL_FIRST,
                                                     remote_prob=0.125),
], ids=["one_cluster", "two_clusters_local_first"])
def test_topology_frames_equal_the_jax_packages(make):
    t, jt = make(PT), make(JT)
    assert _json(wire.encode_topology(t)) == _json(jwire.encode_topology(jt))
    assert jwire.decode_topology(wire.encode_topology(t)) == jt
    assert wire.decode_topology(jwire.encode_topology(jt)) == t


@pytest.mark.parametrize("name,kw", [
    ("AdaptivePolicy", dict(ci_half_width=0.5, relative=True)),
    ("QuantilePolicy", dict(ci_half_width=1.0, quantiles=(0.5, 0.9))),
    ("PairedPolicy", dict(batch_reps=8)),
])
def test_policy_frames_equal_the_jax_packages(name, kw):
    from repro_torch.service import estimator as pest
    pol, jpol = getattr(pest, name)(**kw), getattr(jest, name)(**kw)
    assert _json(wire.encode_policy(pol)) == _json(jwire.encode_policy(jpol))
    assert jwire.decode_policy(wire.encode_policy(pol)) == jpol
    assert wire.decode_policy(jwire.encode_policy(jpol)) == pol


def test_query_spec_frames_equal_the_jax_packages():
    from repro_torch.service import estimator as pest
    kw = dict(W_list=[500, 1000], lam_list=[2, (3, 9)],
              theta=[(0, 0), (2, 1)], reps=4, seed0=3, mwt=True,
              task_model="adaptive", pool_cap=64, max_events=None,
              backend=None)
    pk = dict(kw, ci=pest.QuantilePolicy(ci_half_width=2.0))
    jk = dict(kw, ci=jest.QuantilePolicy(ci_half_width=2.0))
    assert _json(wire.encode_query_spec(TOPO, pk)) == \
        _json(jwire.encode_query_spec(JTOPO, jk))


def test_grids_cross_the_wire_between_the_packages():
    g = run_grid(TOPO, W_list=[800], lam_list=[2, 5], reps=3, device="cpu")
    assert_grids_equal(g, jwire.decode_grid(wire.encode_grid(g)))
    jg = jsw.run_grid(JTOPO, W_list=[800], lam_list=[2, 5], reps=3)
    assert_grids_equal(jg, wire.decode_grid(jwire.encode_grid(jg)))
    assert_grids_equal(g, jg)


def test_history_sidecars_load_in_either_package(tmp_path):
    cols = np.array([[100, 2, 2, 0, 0], [200, 2, 2, 0, 0]], np.int64)
    jd = jsvc.SimulationDaemon(root=tmp_path / "a")
    jd.service.broker.history.observe("sig-a", cols, np.array([10.0, 20.0]))
    jd.save_history()
    pd = SimulationDaemon(root=tmp_path / "a", device="cpu")
    assert pd.service.broker.history._ema == jd.service.broker.history._ema
    assert len(pd.service.broker.history) == 2

    pd2 = SimulationDaemon(root=tmp_path / "b", device="cpu")
    pd2.service.broker.history.observe("sig-b", cols[:1], np.array([7.5]))
    pd2.save_history()
    jd2 = jsvc.SimulationDaemon(root=tmp_path / "b")
    assert jd2.service.broker.history._ema == pd2.service.broker.history._ema
    assert isinstance(jd2.service.broker.history, jbroker.EventHistory)
