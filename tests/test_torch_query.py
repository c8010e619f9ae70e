"""The query path as a whole: ``SimulationService.query / query_many /
query_pair`` of the port (``device="cpu"``, the plain loop) against the JAX
package's (its ``jax`` backend, on the CPU), on the same questions.

Each case checks equal store keys, equal ``n_dispatches``, ``n_rounds`` and
``dispatch_log`` entries (the backend's name aside: ``torch`` here, ``jax``
there), every ``CellTable`` / ``PairedCells`` field and every grid column
exactly, and byte-identical npz and json files in the two stores; and that a
store filled by either package answers the other with no dispatch. These are
the twins of the query cases of ``tests/test_service.py``,
``tests/test_service_distributional.py`` and the relaxation case of
``tests/test_backends.py``."""
import dataclasses

import numpy as np
import pytest

from repro.core import topology as JT
from repro.service import PairedPolicy as JPairedPolicy
from repro.service import PairedQuery as JPairedQuery
from repro.service import QuantilePolicy as JQuantilePolicy
from repro.service import SimulationService as JaxService
from repro.service import model_digest as j_model_digest
from repro_torch.service import PairedPolicy, PairedQuery, QuantilePolicy
from repro_torch.service import SimulationService as PortService
from repro_torch.service import model_digest
from test_torch_common import (assert_grids_equal,
                               frozen_zip_clock,  # noqa: F401 (a fixture)
                               port_topology)

JTOPO = JT.one_cluster(4, 2)
PTOPO = port_topology(JTOPO)


def _services(tmp_path, **kw):
    return (JaxService(root=tmp_path / "jax", **kw),
            PortService(root=tmp_path / "port", device="cpu", **kw))


def _eq_dataclass(a, b, msg):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, (float, int, tuple, bool)):
            assert x == y, f"{msg} {f.name}: {x} != {y}"
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f"{msg} {f.name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f.name}")


def _same_answer(jr, pr, msg=""):
    assert pr.key == jr.key, msg
    assert pr.from_cache == jr.from_cache, msg
    assert pr.n_rounds == jr.n_rounds, msg
    if hasattr(jr, "paired"):
        assert_grids_equal(jr.grid_a, pr.grid_a, f"{msg} grid_a")
        assert_grids_equal(jr.grid_b, pr.grid_b, f"{msg} grid_b")
        _eq_dataclass(jr.cells_a, pr.cells_a, f"{msg} cells_a")
        _eq_dataclass(jr.cells_b, pr.cells_b, f"{msg} cells_b")
        _eq_dataclass(jr.paired, pr.paired, f"{msg} paired")
    else:
        assert_grids_equal(jr.grid, pr.grid, f"{msg} grid")
        _eq_dataclass(jr.cells, pr.cells, f"{msg} cells")


def _same_dispatches(js, ps):
    assert ps.n_dispatches == js.n_dispatches
    jl, pl = list(js.broker.dispatch_log), list(ps.broker.dispatch_log)
    assert len(jl) == len(pl)
    for je, pe in zip(jl, pl):
        assert je.pop("backend") == "jax" and pe.pop("backend") == "torch"
        assert je == pe


def _same_store(tmp_path):
    ja = {p.name: p.read_bytes() for p in sorted((tmp_path / "jax").iterdir())}
    pa = {p.name: p.read_bytes()
          for p in sorted((tmp_path / "port").iterdir())}
    assert list(ja) == list(pa)
    assert any(n.endswith(".npz") for n in pa)
    for name in ja:
        assert ja[name] == pa[name], name


def _ask(js, ps, make, call="query_many"):
    """Build the same questions on both services (``make(svc, topo)``), ask
    them, and hold every answer of the port against the JAX package's."""
    jq, pq = make(js, JTOPO), make(ps, PTOPO)
    jr = getattr(js, call)(jq)
    pr = getattr(ps, call)(pq)
    for k, (a, b) in enumerate(zip(jr, pr)):
        _same_answer(a, b, f"answer {k}")
    return jr, pr


def _small(svc, topo, **kw):
    args = dict(W_list=[4000], lam_list=[2, 5], reps=4, seed0=3)
    args.update(kw)
    return svc.make_query(topo, **args)


def test_coalesces_concurrent_queries(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    _, pr = _ask(js, ps, lambda s, t: [
        _small(s, t, theta=((0, k),), seed0=5 + k) for k in range(3)])
    assert ps.n_dispatches == 1
    assert ps.broker.dispatch_log[0]["n_queries"] == 3
    assert len({r.key for r in pr}) == 3
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_coalesces_across_callers(tmp_path, frozen_zip_clock):
    """Structurally identical models built by different callers share one
    bucket (canonical keying, not object identity)."""
    js, ps = _services(tmp_path)
    q1 = _small(ps, PTOPO, theta=((0, 0),), reps=3, seed0=7)
    q2 = _small(ps, port_topology(JT.one_cluster(4, 2)), theta=((0, 2),),
                reps=3, seed0=8)
    assert q1.model is not q2.model
    assert model_digest(q1.model) == model_digest(q2.model) == \
        j_model_digest(_small(js, JTOPO).model)

    def make(s, t):
        again = port_topology(JT.one_cluster(4, 2)) if s is ps \
            else JT.one_cluster(4, 2)
        return [_small(s, t, theta=((0, 0),), reps=3, seed0=7),
                _small(s, again, theta=((0, 2),), reps=3, seed0=8)]

    _ask(js, ps, make)
    assert ps.n_dispatches == 1 and \
        ps.broker.dispatch_log[0]["n_queries"] == 2
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_repeated_query_zero_dispatches(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    kw = dict(W_list=[4000], lam_list=[2, 5], reps=4, seed0=3)
    jr1, pr1 = js.query(JTOPO, **kw), ps.query(PTOPO, **kw)
    _same_answer(jr1, pr1)
    assert ps.n_dispatches == 1 and not pr1.from_cache
    jr2, pr2 = js.query(JTOPO, **kw), ps.query(PTOPO, **kw)
    _same_answer(jr2, pr2)
    assert ps.n_dispatches == 1 and pr2.from_cache      # the memory tier
    fresh = PortService(root=tmp_path / "port", device="cpu")
    pr3 = fresh.query(PTOPO, **kw)                      # the disk tier
    assert fresh.n_dispatches == 0 and pr3.from_cache
    assert fresh.store.hits_disk == 1
    _same_answer(jr2, pr3)
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_aliases_identical_inflight_queries(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    _, (r1, r2) = _ask(js, ps, lambda s, t: [_small(s, t)] * 2)
    assert ps.n_dispatches == 1
    assert not r1.from_cache and r2.from_cache
    _same_dispatches(js, ps)


def test_pads_to_pow2(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    _ask(js, ps, lambda s, t: [s.make_query(
        t, W_list=[4000], lam_list=[2, 5, 9], reps=2, seed0=3)])
    log = ps.broker.dispatch_log[0]
    assert log["n_rows"] == 6 and log["n_padded"] == 8
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_adaptive_policy_rounds(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    kw = dict(W_list=[4000], lam_list=[2, 20], ci=0.01, ci_relative=True,
              batch_reps=8, max_reps=512, seed0=11)
    _, (pr,) = _ask(js, ps, lambda s, t: [s.make_query(t, **kw)])
    cells = pr.cells
    assert pr.n_rounds > 1
    assert (cells.half_width <= 0.01 * np.abs(cells.mean)).all()
    assert cells.n[0] < cells.n[1]          # the noisy cell took more reps
    assert ps.n_dispatches == pr.n_rounds   # one dispatch per round
    _same_dispatches(js, ps)
    _same_store(tmp_path)
    again = ps.query(PTOPO, **kw)
    assert again.from_cache and ps.n_dispatches == pr.n_rounds


def test_quantile_policy_rounds(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)

    def make(s, t):
        pkg = QuantilePolicy if s is ps else JQuantilePolicy
        pol = pkg(ci_half_width=0.05, relative=True, batch_reps=16,
                  min_reps=16, max_reps=256)
        return [s.make_query(t, W_list=[4000], lam_list=[2, 20], ci=pol,
                             seed0=11)]

    _, (pr,) = _ask(js, ps, make)
    assert pr.cells.quantile_fracs == (0.1, 0.5, 0.9)
    assert (pr.cells.n >= 16).all()
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def _arms(s, t, W=20000, lam=20, reps=32, **kw_b):
    qa = s.make_query(t, W_list=[W], lam_list=[lam], reps=reps, seed0=17)
    qb = s.make_query(t, W_list=[W], lam_list=[lam], reps=reps, seed0=17,
                      **kw_b)
    return qa, qb


def test_paired_crn_fixed(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)
    jr = js.query_pair(*_arms(js, JTOPO, mwt=True))
    pr = ps.query_pair(*_arms(ps, PTOPO, mwt=True))
    _same_answer(jr, pr)
    pc = pr.paired
    assert int(pc.n[0]) == 32
    assert np.array_equal(pr.grid_a.seed, pr.grid_b.seed)
    assert pc.delta_half_width[0] < pc.independent_half_width()[0]
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_paired_policy_reaches_a_verdict_and_caches(tmp_path,
                                                    frozen_zip_clock):
    js, ps = _services(tmp_path)
    kw = dict(batch_reps=8, min_reps=8, max_reps=256)
    jr = js.query_pair(*_arms(js, JTOPO, reps=8, mwt=True),
                       policy=JPairedPolicy(**kw))
    pr = ps.query_pair(*_arms(ps, PTOPO, reps=8, mwt=True),
                       policy=PairedPolicy(**kw))
    _same_answer(jr, pr)
    assert pr.paired.significant[0] or int(pr.paired.n[0]) >= 256
    _same_dispatches(js, ps)
    _same_store(tmp_path)
    d0 = ps.n_dispatches
    again = ps.query_pair(*_arms(ps, PTOPO, reps=8, mwt=True),
                          policy=PairedPolicy(**kw))
    assert again.from_cache and ps.n_dispatches == d0


def test_paired_arms_differ_in_theta(tmp_path, frozen_zip_clock):
    js, ps = _services(tmp_path)

    def arms(s, t):
        return (s.make_query(t, W_list=[4000], lam_list=[20],
                             theta=((0, 0),), reps=8, seed0=3),
                s.make_query(t, W_list=[4000], lam_list=[20],
                             theta=((0, 2),), reps=8, seed0=3))

    jr, pr = js.query_pair(*arms(js, JTOPO)), ps.query_pair(*arms(ps, PTOPO))
    _same_answer(jr, pr)
    assert int(pr.paired.theta_comm_a[0]) == 0
    assert int(pr.paired.theta_comm_b[0]) == 2
    _same_dispatches(js, ps)
    _same_store(tmp_path)


def test_paired_query_validates_its_arms(tmp_path):
    ps = PortService(root=tmp_path, device="cpu")
    js = JaxService(root=tmp_path / "jax")
    for s, PQ in ((ps, PairedQuery), (js, JPairedQuery)):
        topo = PTOPO if s is ps else JTOPO
        qa = s.make_query(topo, W_list=[4000], lam_list=[2], reps=4, seed0=3)
        qb = s.make_query(topo, W_list=[4000], lam_list=[2], reps=4, seed0=4)
        with pytest.raises(ValueError, match="seed0"):
            PQ(a=qa, b=qb)
        qc = s.make_query(topo, W_list=[4000], lam_list=[2], reps=4,
                          seed0=3, ci=0.01)
        with pytest.raises(ValueError, match="adaptive"):
            PQ(a=qa, b=qc)


def _capped(s, t):
    kw = dict(W_list=[30_000], reps=3)
    return [s.make_query(t, lam_list=[2], max_events=128, **kw),  # overflows
            s.make_query(t, lam_list=[60], max_events=1 << 15, **kw)]


def test_relaxation_coalesces_and_matches_unrelaxed(tmp_path,
                                                    frozen_zip_clock):
    """Two queries whose static caps differ coalesce into one dispatch under
    relaxation, with answers and artifacts byte-identical to the unrelaxed
    path, overflow columns included — in both packages alike."""
    jt8 = JT.one_cluster(8, 1)
    pt8 = port_topology(jt8)
    jr = JaxService(root=tmp_path / "jax")
    pr = PortService(root=tmp_path / "port", device="cpu")
    res_j = jr.query_many(_capped(jr, jt8))
    res_r = pr.query_many(_capped(pr, pt8))
    for a, b in zip(res_j, res_r):
        _same_answer(a, b)
    assert pr.n_dispatches == 1
    log = pr.broker.dispatch_log[0]
    assert log["relaxed"] and log["n_queries"] == 2
    assert log["max_events"] == 1 << 15
    assert res_r[0].grid.overflow.any() and not res_r[1].grid.overflow.any()
    _same_dispatches(jr, pr)
    _same_store(tmp_path)

    pu = PortService(root=tmp_path / "unrelaxed", device="cpu",
                     relax_max_events=False)
    res_u = pu.query_many(_capped(pu, pt8))
    assert pu.n_dispatches == 2
    for r, u in zip(res_r, res_u):
        assert r.key == u.key
        assert_grids_equal(r.grid, u.grid)
        assert (tmp_path / "port" / f"{r.key}.npz").read_bytes() == \
            (tmp_path / "unrelaxed" / f"{u.key}.npz").read_bytes()


def _mixed(s, t):
    """A fixed, an adaptive and a paired question, for the store tests."""
    pol = (PairedPolicy if isinstance(s, PortService) else JPairedPolicy)(
        batch_reps=4, min_reps=4, max_reps=16)
    PQ = PairedQuery if isinstance(s, PortService) else JPairedQuery
    return [_small(s, t),
            s.make_query(t, W_list=[4000], lam_list=[5], ci=0.05,
                         ci_relative=True, batch_reps=4, max_reps=32,
                         seed0=21),
            PQ(*_arms(s, t, W=4000, lam=5, reps=4, mwt=True), policy=pol)]


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_store_filled_by_one_package_answers_the_other(filler, tmp_path,
                                                       frozen_zip_clock):
    root = tmp_path / "shared"
    js = JaxService(root=root)
    ps = PortService(root=root, device="cpu")
    (first, t1), (second, t2) = ((js, JTOPO), (ps, PTOPO))[::(
        1 if filler == "jax" else -1)]
    r1 = first.query_many(_mixed(first, t1))
    assert first.n_dispatches > 0
    r2 = second.query_many(_mixed(second, t2))
    assert second.n_dispatches == 0
    assert all(r.from_cache for r in r2)
    assert second.stats()["n_cache_hits"] == 3
    for a, b in zip(r1, r2):
        assert a.key == b.key
        if hasattr(a, "paired"):
            _eq_dataclass(a.paired, b.paired, "paired")
            assert_grids_equal(a.grid_a, b.grid_a)
        else:
            _eq_dataclass(a.cells, b.cells, "cells")
            assert_grids_equal(a.grid, b.grid)


def test_stats_carries_the_broker_keys(tmp_path):
    ps = PortService(root=tmp_path, device="cpu")
    ps.query(PTOPO, W_list=[2000], lam_list=[2], reps=2)
    ps.query(PTOPO, W_list=[2000], lam_list=[2], reps=2)
    st = ps.stats()
    js = JaxService(root=tmp_path / "jax")
    want = set(js.stats()) - {"compile_cache"}
    assert set(st) - {"device"} == want
    assert st["n_dispatches"] == 1 and st["n_cache_hits"] == 1
    assert st["n_queries"] == 2 and st["n_history_cells"] == 1
    assert st["degraded"]["degraded"] is False
    assert st["sanitizer"]["violations_total"] == 0
    # A CPU service dispatches a backend-less query on the plain loop.
    assert st["default_backend"] == "torch" == ps.broker.default_backend
    assert st["n_devices"] == 1
