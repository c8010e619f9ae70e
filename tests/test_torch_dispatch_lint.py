"""The port's dispatch lint (``repro_torch.check.dispatch_lint``), the twin of
the JAX package's jaxpr lint, on the CPU: the port's tree is clean, every
rule fires on a seeded hazard and stays silent on the same shape written
right (the JAX package's own cases, ``tests/test_check.py``), the port's
``grid_shape_hazards`` agrees with the JAX package's, and
``ws_sim_cuda(grid_chunk=)`` is bit-identical to the unchunked call and to
``ws_sim_pallas(interpret=True, grid_chunk=)`` for every body.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import dag as jdg
from repro.core import dag_gen as jgen
from repro.core import divisible as jdv
from repro.core import topology as JT
from repro.kernels import ws_sim as jws
from repro_torch.check import PASSES, dispatch_lint as dl, run_pass
from repro_torch.core import divisible as pdv
from repro_torch.core import engine as peng
from repro_torch.core import topology as PT
from repro_torch.kernels import ws_sim as pws
from test_torch_common import (assert_results_equal, port_config_of,
                               port_scenario, seeded_scenario)

ROOT = Path(__file__).resolve().parents[1]


def test_the_port_tree_is_clean_on_the_cpu():
    assert PASSES == ("dispatch", "protocol", "sanitizer")
    assert run_pass("dispatch", device="cpu") == []


def test_cli_runs_every_pass_clean_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--device", "cpu",
         "--baseline", str(tmp_path / "none.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for name in PASSES:
        assert f"check[{name}]: 0 finding(s)" in out.stdout


def test_one_step_syncs_once_and_the_decode_step_never():
    for name, model in dl.tiny_models():
        for n in dl.SIGNATURE_WIDTHS:
            _, ops = dl.step_ops(model, n, torch.device("cpu"))
            assert sum(op.name == dl.SYNC_OP for op in ops) == 1, (name, n)
    ops = dl.decode_step_ops(torch.device("cpu"))
    assert ops and not [op for op in ops if op.name == dl.SYNC_OP]
    assert not [op for op in ops if torch.float64 in op.out_dtypes]


# ---------------------------------------------------------------------------
# host_sync.item
# ---------------------------------------------------------------------------

def test_flags_an_item_inside_the_step():
    def step(x):
        y = x * 2
        if y.sum().item() > 0:           # a read of a device value
            y = y + 1
        return y

    _, ops = dl.record_ops(step, torch.ones(4))
    got = dl.scan_ops(ops, where="synthetic", symbol="t")
    assert [g.rule for g in got] == ["host_sync.item"]
    # the loop condition's one read is allowed where a step may make it
    assert dl.scan_ops(ops, where="synthetic", symbol="t",
                       syncs_allowed=1) == []


def test_a_step_without_a_read_is_clean():
    _, ops = dl.record_ops(lambda x: (x * 2).sum(), torch.ones(4))
    assert dl.scan_ops(ops, where="synthetic", symbol="t") == []


def test_ast_rule_flags_host_copies_in_sync_free_bodies():
    bad = ("def advance(model, loop):\n"
           "    n = loop.core.n_events.tolist()\n"
           "    m = loop.core.t.cpu()\n"
           "    return n, m.numpy(), loop.core.t[0].item()\n")
    got = dl.lint_host_sync_source(bad, "x.py", {"advance"})
    assert [g.rule for g in got] == ["host_sync.item"] * 4
    assert {g.symbol for g in got} == {"advance"}
    # the same calls outside the named functions are not the rule's
    assert dl.lint_host_sync_source(bad, "x.py", {"other"}) == []
    ok = ("def advance(model, loop):\n"
          "    return bool(loop.core.done.all())\n")
    assert dl.lint_host_sync_source(ok, "x.py", {"advance"}) == []


def test_sync_free_bodies_of_the_port_are_clean():
    assert dl.host_sync_source_findings() == []
    for rel, fn in dl.SYNC_FREE:
        src = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert f"def {fn}(" in src, (rel, fn)


# ---------------------------------------------------------------------------
# dtype.f64
# ---------------------------------------------------------------------------

def test_flags_float64():
    _, ops = dl.record_ops(lambda x: x.to(torch.float64) * 2.0,
                           torch.ones(3))
    got = dl.scan_ops(ops, where="synthetic", symbol="t")
    assert {g.rule for g in got} == {"dtype.f64"}
    _, ops = dl.record_ops(lambda x: x * 2.0, torch.ones(3))
    assert dl.scan_ops(ops, where="synthetic", symbol="t") == []


def test_flags_a_core_state_field_that_changes_dtype():
    name, model = dl.tiny_models()[0]
    loop = peng.start_loop(model, dl._tiny_scenario(4, "cpu"))
    core = loop.core
    assert dl.state_dtype_findings(core, core, "synthetic", name) == []
    drifted = core._replace(total_idle=core.total_idle.to(torch.float64))
    got = dl.state_dtype_findings(core, drifted, "synthetic", name)
    assert [g.rule for g in got] == ["dtype.f64"]
    assert "total_idle" in got[0].message
    wrapped = core._replace(rng=core.rng + (1 << 32))
    got = dl.state_dtype_findings(core, wrapped, "synthetic", name)
    assert [g.rule for g in got] == ["dtype.f64"]
    assert "rng" in got[0].message


# ---------------------------------------------------------------------------
# retrace.shape_branch
# ---------------------------------------------------------------------------

def test_signature_catches_a_branch_on_the_batch_shape():
    def branchy(x):
        if x.shape[0] > 4:          # Python branch on a batch shape
            return x.sum()
        return (x * 2).sum()

    def straight(x):
        return (x * 2).sum()

    def record(fn):
        return lambda n: dl.record_ops(fn, torch.zeros(n))[1]

    got = dl.signature_findings(record(branchy), "synthetic", "t")
    assert [g.rule for g in got] == ["retrace.shape_branch"]
    assert dl.signature_findings(record(straight), "synthetic", "t") == []


def test_the_launch_key_does_not_depend_on_the_width():
    for name, model in dl.tiny_models():
        keys = {dl.launch_key(model, dl._tiny_scenario(n, "cpu"))
                for n in (1, 4, 8, 300)}
        assert len(keys) == 1, name
    assert dl.shape_branch_findings(*dl.tiny_models()[1], "cpu") == []


def test_a_launch_parameter_that_follows_the_width_is_flagged(monkeypatch):
    """A launch whose integer parameters follow G (here ``max_trace``) would
    pick a kernel per batch width: the launch key differs, the rule fires."""
    params = pws._params

    def widthful(model, scn, k, probe=None):
        prm, outs, keep = params(model, scn, k, probe)
        prm.max_trace = prm.G
        return prm, outs, keep

    monkeypatch.setattr(pws, "_params", widthful)
    name, model = dl.tiny_models()[0]
    got = dl.shape_branch_findings(name, model, "cpu")
    assert [(g.rule, g.where) for g in got] == [("retrace.shape_branch",
                                                 "kernels.ws_sim._params")]


# ---------------------------------------------------------------------------
# retrace.static_args
# ---------------------------------------------------------------------------

def test_static_arg_findings_flag_float_cfg():
    @dataclasses.dataclass(frozen=True)
    class FloatCfg(pdv.EngineConfig):
        alpha: float = 0.5

    topo = PT.one_cluster(4, 1)
    got = dl.static_arg_findings("poisoned",
                                 pdv.DivisibleModel(FloatCfg(topology=topo)))
    assert {g.rule for g in got} == {"retrace.static_args"}
    assert "alpha" in got[0].message
    clean = pdv.DivisibleModel(pdv.EngineConfig(topology=topo))
    assert dl.static_arg_findings("clean", clean) == []


# ---------------------------------------------------------------------------
# grid_shape_hazards and ws_sim_cuda(grid_chunk=)
# ---------------------------------------------------------------------------

#: the JAX test's inputs, then the widths around powers of two
HAZARD_CASES = [(128, None), (None, None), (96, None), (0, None),
                (None, 48), (None, 64)] + [(None, g) for g in
                                           (0, 1, 2, 3, 48, 64, 96, 128)]


@pytest.mark.parametrize("chunk,G", HAZARD_CASES)
def test_grid_shape_hazards_agree_with_the_jax_package(chunk, G):
    want = jws.grid_shape_hazards(chunk, G=G)
    got = pws.grid_shape_hazards(chunk, G=G)
    assert len(got) == len(want)


def test_grid_shape_hazards_cases_of_the_jax_test():
    assert pws.grid_shape_hazards(128) == []
    assert pws.grid_shape_hazards(None) == []
    assert pws.grid_shape_hazards(96)
    assert pws.grid_shape_hazards(0)
    assert pws.grid_shape_hazards(None, G=48)
    assert pws.grid_shape_hazards(None, G=64) == []


def _chunk_configs():
    topo = JT.one_cluster(4, 3)
    return {
        "divisible": (jdv.EngineConfig(topology=topo, max_events=1 << 14),
                      1500),
        "dag": (jdg.DagEngineConfig(topology=topo, dag=jgen.binary_tree(5),
                                    max_events=1 << 14), 0),
        "adaptive": (jad.AdaptiveEngineConfig(topology=topo,
                                              max_events=1 << 14), 900),
    }


@pytest.mark.parametrize("body", ["divisible", "dag", "adaptive"])
def test_grid_chunk_is_bit_identical(body):
    cfg, W = _chunk_configs()[body]
    scn = seeded_scenario(31, 7, W, cfg.topology, theta=(1, 0))
    pcfg, pscn = port_config_of(cfg), port_scenario(scn)
    whole = pws.ws_sim_cuda(pcfg, pscn)
    before = pws.ws_sim_cuda.launches
    for c in (1, 3, 4, 128):
        got = pws.ws_sim_cuda(pcfg, pscn, grid_chunk=c)
        assert_results_equal(whole, got, f"{body} chunk {c} vs unchunked")
        assert_results_equal(
            jws.ws_sim_pallas(cfg, scn, interpret=True, grid_chunk=c), got,
            f"{body} chunk {c} vs pallas")
    assert pws.ws_sim_cuda.launches == before    # CPU tensors: no launch
    assert [int(x) for x in pscn.max_events] == [int(x)
                                                 for x in scn.max_events]


def test_grid_chunk_of_an_empty_batch():
    cfg = pdv.EngineConfig(topology=PT.one_cluster(4, 1), max_events=256)
    scn = pdv.batch_scenarios(100, np.arange(0, dtype=np.uint32),
                              device="cpu")
    res = pws.ws_sim_cuda(cfg, scn, grid_chunk=4)
    assert res.makespan.shape == (0,)


def test_a_one_row_dag_batch_leaves_the_dag_untouched():
    """The plain loop decrements its pending-predecessor counts in place; a
    one-row batch once aliased them to the DAG's own array, so every later
    run of that model saw a corrupted DAG (found by the chunked runs)."""
    cfg, _ = _chunk_configs()["dag"]
    scn = seeded_scenario(31, 3, 0, cfg.topology)
    pcfg, pscn = port_config_of(cfg), port_scenario(scn)
    pred = np.array(pcfg.dag.pred_count, copy=True)
    rows = [pws.ws_sim_cuda(pcfg, peng.Scenario(*(x[k:k + 1] for x in pscn)))
            for k in range(3)]
    np.testing.assert_array_equal(pcfg.dag.pred_count, pred)
    assert_results_equal(pws.ws_sim_cuda(pcfg, pscn), peng.cat_results(rows))
