"""The slice as a whole: ``SimulationService.sweep`` in both packages on the
same question gives the same chunk keys and the same npz bytes, and a store
filled by either package is a cache hit for the other."""
import numpy as np
import pytest

from repro.core import backend as jbk
from repro.core import topology as JT
from repro.service import SimulationService as JaxService
from repro.service import store as jstore
from repro_torch import obs as pobs
from repro_torch.core import backend as pbk
from repro_torch.service import SimulationService as PortService
from repro_torch.service import store as pstore
from test_torch_common import (assert_grids_equal,
                               frozen_zip_clock,  # noqa: F401 (a fixture)
                               port_topology)

QUESTIONS = {
    "two_clusters_local_first": dict(
        topo=lambda: JT.two_clusters(6, 9).with_strategy(JT.LOCAL_FIRST, 0.3),
        kw=dict(W_list=[2000, 5000], lam_list=[(1, 9), (2, 5)],
                theta=((0, 0), (3, 1)), reps=3, chunk_size=5)),
    "one_cluster_mwt": dict(
        topo=lambda: JT.one_cluster(8, 4),
        kw=dict(W_list=[6000], lam_list=[4, 11], reps=8, chunk_size=8,
                mwt=True, seed0=99)),
    "ring_inv_distance": dict(
        topo=lambda: JT.multi_cluster(4, 3, 7, 2, "ring").with_strategy(
            JT.INV_DISTANCE),
        kw=dict(W_list=[3000], lam_list=[(2, 7)], reps=10, chunk_size=4)),
}


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


@pytest.mark.parametrize("name", sorted(QUESTIONS))
def test_sweep_same_keys_same_bytes(name, tmp_path, frozen_zip_clock):
    q = QUESTIONS[name]
    jt = q["topo"]()
    ja = JaxService(root=tmp_path / "jax")
    pa = PortService(root=tmp_path / "port", device="cpu")
    g_jax = ja.sweep(jt, backend="jax", **q["kw"])
    g_port = pa.sweep(port_topology(jt), backend="torch", **q["kw"])
    assert_grids_equal(g_jax, g_port, name)
    fa, fb = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert list(fa) == list(fb) and len(fa) >= 4          # npz + json each
    assert any(n.endswith(".npz") for n in fa)
    for fname in fa:
        assert fa[fname] == fb[fname], f"{name}: {fname} differs"


def test_chunk_and_query_keys_equal():
    q = QUESTIONS["two_clusters_local_first"]
    jt = q["topo"]()
    pt = port_topology(jt)
    from repro.core import sweep as jsw
    from repro_torch.core import sweep as psw
    kw = dict(W_list=q["kw"]["W_list"], lam_list=[1, 9, 2, 5])
    jm, pm = jsw.resolve_model(jt, **kw), psw.resolve_model(pt, **kw)
    grid = psw.canonical_grid(q["kw"]["W_list"], q["kw"]["lam_list"], 3,
                              theta=q["kw"]["theta"])
    assert jstore.query_key(jm, grid) == pstore.query_key(pm, grid)
    assert jstore.query_key(jm, grid, extra={"a": 1}) == \
        pstore.query_key(pm, grid, extra={"a": 1})
    for ci in range(3):
        assert jstore.chunk_key(jm, grid, 5, ci) == \
            pstore.chunk_key(pm, grid, 5, ci)
    assert pstore._GRID_FIELDS == jstore._GRID_FIELDS


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_store_filled_by_one_package_serves_the_other(filler, tmp_path):
    q = QUESTIONS["one_cluster_mwt"]
    jt = q["topo"]()
    pt = port_topology(jt)
    jax_be, torch_be = jbk.get_backend("jax"), pbk.get_backend("torch")
    if filler == "jax":
        first = JaxService(root=tmp_path).sweep(jt, backend="jax", **q["kw"])
        n = torch_be.n_run_rows
        svc = PortService(root=tmp_path, device="cpu")
        second = svc.sweep(pt, backend="torch", **q["kw"])
        assert torch_be.n_run_rows == n           # nothing was simulated
    else:
        first = PortService(root=tmp_path, device="cpu").sweep(
            pt, backend="torch", **q["kw"])
        n = jax_be.n_run_rows
        svc = JaxService(root=tmp_path)
        second = svc.sweep(jt, backend="jax", **q["kw"])
        assert jax_be.n_run_rows == n
    assert svc.store.hits_disk == 2 and svc.store.misses == 0
    assert_grids_equal(first, second, filler)


def test_repeat_sweep_is_served_from_the_store(tmp_path):
    q = QUESTIONS["one_cluster_mwt"]
    pt = port_topology(q["topo"]())
    reg = pobs.MetricsRegistry()
    svc = PortService(root=tmp_path, metrics=reg, device="cpu")
    be = pbk.get_backend("oracle")
    n = be.n_run_rows
    seen = []
    a = svc.sweep(pt, backend="oracle",
                  on_chunk=lambda ci, g: seen.append(ci), **q["kw"])
    assert be.n_run_rows == n + 2 and seen == [0, 1]
    b = svc.sweep(pt, backend="torch", **q["kw"])   # any backend: same keys
    assert be.n_run_rows == n + 2
    assert_grids_equal(a, b)
    st = svc.stats()
    assert st["store"]["puts"] == 2 and st["store"]["hits_mem"] == 2
    # a CPU service runs a question that names no backend on the plain loop
    assert st["engine_version"] == 2 and st["default_backend"] == "torch"
    assert st["device"] == "cpu" and st["degraded"]["degraded"] is False
    assert st["metrics"]["counters"]["store.puts"] == 2
    # a second process (fresh memory tier) reads the same answer from disk
    other = PortService(root=tmp_path, device="cpu")
    c = other.sweep(pt, backend="torch", **q["kw"])
    assert other.store.hits_disk == 2
    assert_grids_equal(a, c)


def test_invariants_of_a_sweep(tmp_path):
    """What chip_smoke.py checks on every row of its sweeps, at a small
    size."""
    q = QUESTIONS["two_clusters_local_first"]
    g = PortService(root=tmp_path, device="cpu").sweep(
        port_topology(q["topo"]()), backend="torch", **q["kw"])
    assert not g.overflow.any()
    np.testing.assert_array_equal(g.extras["executed"].sum(1), g.W)
    assert (g.makespan >= -(-g.W // g.p)).all()
    np.testing.assert_array_equal(g.n_requests, g.n_success + g.n_fail)
