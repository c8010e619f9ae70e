"""Port of ``core/sweep.py`` + ``core/backend.py``: canonical rows, seeds,
grid and model canonical forms, and ``run_grid`` chunked == unchunked == the
JAX package's ``GridResult``, ``extras`` included. Exact."""
import json

import numpy as np
import pytest

from repro.core import sweep as jsw
from repro.core import topology as JT
from repro.service import store as jstore
from repro_torch.core import backend as pbk
from repro_torch.core import interop
from repro_torch.core import sweep as psw
from repro_torch.core import topology as PT
from repro_torch.service import store as pstore
from test_torch_common import assert_grids_equal, port_topology


@pytest.mark.parametrize("n,seed0,stream", [(1, 1, 0), (100, 1, 0),
                                            (64, 12345, 3), (7, 2**31, 1023)])
def test_row_seeds(n, seed0, stream):
    a, b = jsw.row_seeds(n, seed0, stream), psw.row_seeds(n, seed0, stream)
    assert a.dtype == b.dtype == np.uint32
    np.testing.assert_array_equal(a, b)


def test_row_seeds_exhaustion():
    with pytest.raises(ValueError):
        psw.row_seeds(1 << 22)
    with pytest.raises(ValueError):
        psw.row_seeds(4, stream=1 << 10)


GRID = dict(W_list=[1500, 4000], lam_list=[3, (1, 9)], reps=3,
            theta=((0, 0), (3, 1)), seed0=7)


def test_grid_rows_and_canonical_grid():
    a, b = jsw.grid_rows(**GRID), psw.grid_rows(**GRID)
    assert len(a) == len(b) == 24
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert jsw.canonical_grid(remote_prob=0.3, **GRID) == \
        psw.canonical_grid(remote_prob=0.3, **GRID)
    assert [psw.lam_pair(l) for l in (4, (1, 9), [2, 3])] == \
        [jsw.lam_pair(l) for l in (4, (1, 9), [2, 3])]
    sub = b.take(np.array([5, 0, 23]))
    np.testing.assert_array_equal(sub.seed, b.seed[[5, 0, 23]])
    np.testing.assert_array_equal(b.slice(4, 9).W, b.W[4:9])
    c = interop.rows_from_arrays(*(np.asarray(x) for x in a))
    for f in a._fields:
        np.testing.assert_array_equal(getattr(c, f), getattr(a, f))


@pytest.mark.parametrize("pow2", [False, True])
@pytest.mark.parametrize("mwt", [False, True])
def test_resolve_model_same_canonical_json(mwt, pow2):
    jt = JT.two_clusters(6, 9).with_strategy(JT.LOCAL_FIRST, 0.3)
    kw = dict(W_list=GRID["W_list"], lam_list=[3, 1, 9], mwt=mwt,
              pow2_max_events=pow2)
    a = jsw.resolve_model(jt, "divisible", **kw)
    b = psw.resolve_model(port_topology(jt), "divisible", **kw)
    assert a.max_events == b.max_events
    ja = json.dumps(jstore.canonical_model(a), sort_keys=True)
    jb = json.dumps(pstore.canonical_model(b), sort_keys=True)
    assert ja == jb
    assert jstore.model_digest(a) == pstore.model_digest(b)


def test_unported_task_models_say_so():
    for name in ("dag", "adaptive"):
        with pytest.raises(NotImplementedError, match="not ported"):
            psw.make_model(name, topology=PT.one_cluster(4, 1))
    with pytest.raises(ValueError):
        psw.make_model("nonsense", topology=PT.one_cluster(4, 1))


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_run_grid_chunked_unchunked_and_jax(backend):
    jt = JT.two_clusters(6, 9).with_strategy(JT.LOCAL_FIRST, 0.3)
    pt = port_topology(jt)
    expect = jsw.run_grid(jt, backend="jax", **GRID)
    whole = psw.run_grid(pt, backend=backend, device="cpu", **GRID)
    seen = []
    chunked = psw.run_grid(pt, backend=backend, device="cpu", chunk_size=5,
                           on_chunk=lambda ci, g: seen.append((ci, len(g))),
                           **GRID)
    assert seen == [(0, 5), (1, 5), (2, 5), (3, 5), (4, 4)]
    assert_grids_equal(expect, whole, "unchunked")
    assert_grids_equal(expect, chunked, "chunked")
    assert list(whole.extras) == ["n_events", "executed", "lam_local"]
    assert whole.seed.dtype == np.uint32 and whole.overflow.dtype == np.bool_


def test_run_grid_resume_and_lookup():
    pt = PT.one_cluster(4, 3)
    kw = dict(W_list=[900], lam_list=[3], reps=6, backend="torch",
              device="cpu")
    whole = psw.run_grid(pt, **kw)
    parts = {}
    psw.run_grid(pt, chunk_size=2, on_chunk=parts.__setitem__, **kw)
    computed = []
    again = psw.run_grid(pt, chunk_size=2,
                         chunk_lookup=lambda ci: parts.get(ci) if ci != 1
                         else None,
                         on_chunk=lambda ci, g: computed.append(ci), **kw)
    assert computed == [1]
    assert_grids_equal(whole, again)
    tail = psw.run_grid(pt, chunk_size=2, start_chunk=2, **kw)
    assert_grids_equal(tail, parts[2])
    with pytest.raises(ValueError):
        psw.run_grid(pt, start_chunk=1, **kw)


def test_auto_selected_backend_runs_every_batch_size():
    """No small-batch crossover: the selected backend runs a batch of any
    size, and nothing is handed to the host oracle behind the caller."""
    pt = PT.one_cluster(4, 3)
    model = psw.resolve_model(pt, W_list=[500], lam_list=[3])
    oracle, torch_be = pbk.get_backend("oracle"), pbk.get_backend("torch")
    n_o, n_t = oracle.n_run_rows, torch_be.n_run_rows
    small = psw.run_rows(model, psw.grid_rows([500], [3], 1), device="cpu")
    assert (oracle.n_run_rows, torch_be.n_run_rows) == (n_o, n_t + 1)
    big = psw.run_rows(model, psw.grid_rows([500], [3], 9), device="cpu")
    assert (oracle.n_run_rows, torch_be.n_run_rows) == (n_o, n_t + 2)
    named = psw.run_rows(model, psw.grid_rows([500], [3], 1), device="cpu",
                         backend="oracle")
    assert (oracle.n_run_rows, torch_be.n_run_rows) == (n_o + 1, n_t + 2)
    assert_grids_equal(small, named)
    np.testing.assert_array_equal(big.makespan[:1], small.makespan)
    assert not hasattr(pbk, "reroute_small_batch")
    assert not hasattr(pbk.get_backend("cuda").capabilities(),
                       "crossover_rows")


def test_backend_registry_and_caps(monkeypatch):
    assert pbk.backend_names() == ("oracle", "torch", "cuda")
    monkeypatch.delenv(pbk.BACKEND_ENV, raising=False)
    assert pbk.default_backend_name() == "cuda"
    monkeypatch.setenv(pbk.BACKEND_ENV, "oracle")
    assert pbk.default_backend_name() == "oracle"
    assert pbk.get_backend(None, device="cpu").name == "oracle"
    monkeypatch.setenv(pbk.BACKEND_ENV, "pallas")
    with pytest.raises(ValueError):
        pbk.default_backend_name()
    monkeypatch.delenv(pbk.BACKEND_ENV)
    assert pbk.get_backend(None, device="cpu").name == "torch"
    assert pbk.get_backend("cuda").capabilities().max_p == 1024
    with pytest.raises(ValueError):
        pbk.get_backend("jax")
    with pytest.raises(ValueError, match="p <= 1024"):
        psw.resolve_model(PT.one_cluster(1025, 1), backend="cuda")
    chunks = pbk.get_backend("torch")._device_chunks(20, ("a", "b", "c"))
    assert chunks == [(0, 10, "a"), (10, 20, "b")]


def test_quick_sim_matches():
    a = jsw.quick_sim(8, 3000, 4, seed=3, mwt=True)
    b = psw.quick_sim(8, 3000, 4, seed=3, mwt=True, device="cpu")
    assert int(a.makespan) == int(b.makespan)
    np.testing.assert_array_equal(np.asarray(a.executed), b.executed.numpy())
