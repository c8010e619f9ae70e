"""Port of ``core/dag_gen.py`` + ``core/dag.py`` and the DAG body of the
kernel: the port's generators, plain batched loop, oracle twin, oracle
backend and store-backed sweep against the JAX package's on the same
numpy-made inputs. Tolerance: none, on every leaf, dtypes included. The
JAX side runs on the CPU, its Pallas kernel in interpret mode."""
import json

import numpy as np
import pytest
import torch

from repro.core import dag as jdg
from repro.core import dag_gen as jgen
from repro.core import oracle as jorc
from repro.core import sweep as jsw
from repro.core import topology as JT
from repro.service import SimulationService as JaxService
from repro.service import store as jstore
from repro_torch.core import backend as pbk
from repro_torch.core import dag as pdg
from repro_torch.core import dag_gen as pgen
from repro_torch.core import oracle as porc
from repro_torch.core import sweep as psw
from repro_torch.core import topology as PT
from repro_torch.kernels import ref
from repro_torch.kernels.ws_sim import ws_sim_cuda
from repro_torch.service import SimulationService as PortService
from repro_torch.service import store as pstore
from test_torch_common import (STRATEGIES, assert_grids_equal,
                               assert_results_equal,
                               frozen_zip_clock,  # noqa: F401 (a fixture)
                               hold_port_against_jax, port_dag, port_topology,
                               seeded_scenario)

GENERATORS = {
    "chain": lambda g: g.chain(7, dur=3),
    "binary_tree": lambda g: g.binary_tree(5),
    "fork_join": lambda g: g.fork_join(4, dur=2),
    "merge_sort": lambda g: g.merge_sort(300, 32),
    "random_layered": lambda g: g.random_layered(5, 8, 0.3, seed=3),
    "random_layered_durs": lambda g: g.random_layered(3, 6, 0.5, (2, 9), 11),
}

#: the DAGs of the strategy matrix, taken in turn
MATRIX_DAGS = (lambda: jgen.random_layered(4, 6, 0.3, seed=3),
               lambda: jgen.merge_sort(200, 32),
               lambda: jgen.fork_join(4))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_the_reference(name):
    a, b = GENERATORS[name](jgen), GENERATORS[name](pgen)
    assert a.name == b.name and a.n == b.n and a.total_work == b.total_work
    for f in ("dur", "child_ptr", "child_idx", "pred_count"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.int32, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.sources, b.sources)
    assert a.critical_path() == b.critical_path()
    np.testing.assert_array_equal(a.heights(), b.heights())
    text = pgen.to_json(b)
    assert text == jgen.to_json(a)
    back = pgen.from_json(text)
    assert back == b and back.name == b.name
    assert pgen.from_json(jgen.to_json(a, {0: {"proc": 1}})) == b
    assert port_dag(a) == b and hash(port_dag(a)) == hash(b)


@pytest.mark.parametrize("lifo", [True, False], ids=["lifo", "fifo"])
@pytest.mark.parametrize("mwt", [False, True], ids=["swt", "mwt"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dag_matrix(strategy, mwt, lifo):
    """4 strategies x SWT/MWT x owner_lifo; the Pallas kernel on half."""
    jt = JT.two_clusters(6, 9).with_strategy(strategy, remote_prob=0.3)
    dagf = MATRIX_DAGS[(2 * strategy + mwt) % 3]()
    cfg = jdg.DagEngineConfig(topology=jt, dag=dagf, mwt=mwt,
                              owner_lifo=lifo, max_events=1 << 14)
    scn = seeded_scenario(7 + strategy, 4, 0, jt, theta=(mwt, 0),
                          remote_prob=0.3)
    got = hold_port_against_jax(cfg, scn, pallas=lifo == mwt)
    assert not got.overflow.any()
    assert (got.n_completed == dagf.n).all()
    assert (got.tasks_run.sum(1) == dagf.n).all()
    assert (got.executed.sum(1) == dagf.total_work).all()


def test_dag_halt_budgets_and_trace_ring():
    """A FIFO deque whose positions reach a small cap halts its row (an
    overflow); per-row budgets (0 included) cut rows; the trace ring fills
    and saturates."""
    jt = JT.one_cluster(4, 2)
    dagf = jgen.random_layered(6, 8, 0.4, seed=5)
    budgets = np.array([2**31 - 1, 0, 40, 2**31 - 1, 7, 2**31 - 1],
                       np.int32)
    cfg = jdg.DagEngineConfig(topology=jt, dag=dagf, owner_lifo=False,
                              deque_cap=16, max_events=1 << 14,
                              log_trace=True, max_trace=48)
    scn = seeded_scenario(4, 6, 0, jt, budgets=budgets)
    got = hold_port_against_jax(cfg, scn)
    assert got.overflow[[1, 2, 4]].all()
    np.testing.assert_array_equal(got.n_events[[1, 2, 4]].numpy(), [0, 40, 7])
    halted = got.overflow & (got.n_events < torch.as_tensor(budgets))
    assert halted.any(), "no row halted at the deque cap"
    assert (got.n_completed[halted] < dagf.n).all()
    assert int(got.makespan[1]) == -1 and int(got.executed[1].sum()) == 0
    assert (got.n_trace <= 48).all() and int(got.n_trace.max()) == 48


def test_dag_trace_whole_run():
    jt = JT.two_clusters(4, 5)
    dagf = jgen.fork_join(4)
    cfg = jdg.DagEngineConfig(topology=jt, dag=dagf, mwt=True,
                              max_events=1 << 14, log_trace=True,
                              max_trace=4096)
    got = hold_port_against_jax(cfg, seeded_scenario(8, 3, 0, jt),
                                pallas=False)
    assert (got.n_trace < got.n_events).all()   # local pops log nothing
    kinds = got.trace[0, :int(got.n_trace[0]), 2]
    assert set(kinds.tolist()) <= {0, 1, 2, 3, 4}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dag_oracle_twin(strategy):
    """The port's copy of the numpy twin == the JAX package's == the
    port's plain loop, row by row."""
    jt = JT.multi_cluster(2, 3, 7, 2, "ring").with_strategy(strategy, 0.3)
    pt = port_topology(jt)
    dagf = jgen.merge_sort(300, 32)
    lifo = strategy % 2 == 0
    seeds = np.random.default_rng(strategy).integers(0, 2**32, 3,
                                                     dtype=np.uint64)
    cfg = pdg.DagEngineConfig(topology=pt, dag=port_dag(dagf),
                              owner_lifo=lifo, max_events=1 << 14)
    scn = pdg.eng.batch_scenarios(0, seeds, lam_local=2, lam_remote=7,
                                  theta_static=1, remote_prob=0.3,
                                  device="cpu")
    loop = pdg.simulate_dag_batch(cfg, scn)
    for k, seed in enumerate(seeds):
        kw = dict(seed=int(seed), lam_local=2, lam_remote=7, theta_static=1,
                  owner_lifo=lifo, remote_prob=0.3, max_events=1 << 14)
        a = jorc.simulate_dag_oracle(jt, dagf, **kw)
        b = porc.simulate_dag_oracle(pt, port_dag(dagf), **kw)
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
            np.testing.assert_array_equal(
                np.asarray(b[f]), getattr(loop, f)[k].numpy(), err_msg=f)


def test_oracle_backend_dag_and_its_cap_guard():
    pt = PT.two_clusters(4, 5)
    dagf = port_dag(jgen.merge_sort(200, 32))
    kw = dict(lam_list=[(1, 5), (2, 3)], reps=3, task_model="dag",
              dag=dagf, device="cpu")
    g_or = psw.run_grid(pt, backend="oracle", **kw)
    g_pt = psw.run_grid(pt, backend="torch", **kw)
    assert_grids_equal(g_or, g_pt)
    assert list(g_pt.extras) == ["n_events", "executed", "tasks_run",
                                 "n_completed", "lam_local"]
    # a cap that cannot bind (>= n) is served; one below n is refused
    g_cap = psw.run_grid(pt, backend="oracle", deque_cap=dagf.n, **kw)
    assert_grids_equal(g_or, g_cap)
    be = pbk.get_backend("oracle")
    n = be.n_run_rows
    with pytest.raises(ValueError, match="deque_cap"):
        psw.run_grid(pt, backend="oracle", deque_cap=dagf.n - 1, **kw)
    assert be.n_run_rows == n + 1   # the dispatch was counted, no row made


def test_make_model_and_resolve_model_match_the_reference():
    jt = JT.one_cluster(8, 3)
    dagf = jgen.merge_sort(400, 32)
    a = jsw.resolve_model(jt, "dag", lam_list=[3, 11], dag=dagf,
                          owner_lifo=False, deque_cap=50)
    b = psw.resolve_model(port_topology(jt), "dag", lam_list=[3, 11],
                          dag=port_dag(dagf), owner_lifo=False, deque_cap=50)
    assert a.max_events == b.max_events     # from W_eff = the DAG's T1
    assert json.dumps(jstore.canonical_model(a), sort_keys=True) == \
        json.dumps(pstore.canonical_model(b), sort_keys=True)
    assert jstore.model_digest(a) == pstore.model_digest(b)
    assert isinstance(psw.as_model(b.cfg), pdg.DagModel)
    assert psw.as_model(b) is b


def test_dag_sweep_same_keys_same_bytes_shared_store(tmp_path,
                                                     frozen_zip_clock):
    """One DAG question through both packages' SimulationService.sweep:
    same chunk keys, same npz bytes, and a store filled by one package is
    a hit for the other."""
    jt = JT.two_clusters(4, 6).with_strategy(JT.LOCAL_FIRST, 0.3)
    dagf = jgen.random_layered(4, 6, 0.3, seed=3)
    kw = dict(task_model="dag", lam_list=[(1, 6), 3], reps=3, chunk_size=4,
              owner_lifo=False)
    g_jax = JaxService(root=tmp_path / "jax").sweep(jt, backend="jax",
                                                    dag=dagf, **kw)
    port = PortService(root=tmp_path / "port", device="cpu")
    g_port = port.sweep(port_topology(jt), backend="torch",
                        dag=port_dag(dagf), **kw)
    assert_grids_equal(g_jax, g_port)
    files = {d: {p.name: p.read_bytes()
                 for p in sorted((tmp_path / d).iterdir())}
             for d in ("jax", "port")}
    assert list(files["jax"]) == list(files["port"])
    assert sum(n.endswith(".npz") for n in files["jax"]) == 2
    for name, data in files["jax"].items():
        assert data == files["port"][name], name
    # the JAX package's store serves the port: nothing is simulated
    be = pbk.get_backend("torch")
    n = be.n_run_rows
    reader = PortService(root=tmp_path / "jax", device="cpu")
    again = reader.sweep(port_topology(jt), backend="torch",
                         dag=port_dag(dagf), **kw)
    assert be.n_run_rows == n and reader.store.hits_disk == 2
    assert_grids_equal(g_jax, again)


def test_wrapper_on_cpu_tensors_and_its_checks():
    pt = PT.one_cluster(4, 2)
    dagf = port_dag(jgen.fork_join(4))
    cfg = pdg.DagEngineConfig(topology=pt, dag=dagf, max_events=1 << 12)
    scn = pdg.eng.batch_scenarios(0, [1, 2, 3], lam=2, device="cpu")
    assert_results_equal(ref.ws_sim_ref(cfg, scn), ws_sim_cuda(cfg, scn))
    assert_results_equal(ref.ws_sim_ref(pdg.DagModel(cfg), scn),
                         pdg.simulate_dag_batch(cfg, scn))
    with pytest.raises(ValueError, match="cap"):
        ws_sim_cuda(pdg.DagEngineConfig(topology=pt, dag=dagf, deque_cap=0),
                    scn)
