"""The port's log engine (``repro_torch.core.gantt``) against the JAX
package's: the quickstart's traced run (W=5000, p=8, λ=10, seed 42,
``max_trace=8192``) and a trace cut at ``max_trace``. The result, ``trace``,
``n_trace``, ``decode_trace``, ``ascii_gantt``, ``to_paje``, ``to_json`` and
the Chrome events are all equal to the JAX package's (string equality for
the exports, ``assert_array_equal`` for arrays)."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import divisible as jdv
from repro.core import gantt as jg
from repro.core import topology as JT
from repro_torch import obs
from repro_torch.core import engine as eng
from repro_torch.core import gantt
from repro_torch.kernels.ws_sim import ws_sim_cuda
from test_torch_common import assert_results_equal, port_config

ROOT = Path(__file__).resolve().parents[1]


def _quickstart():
    sys.path.insert(0, str(ROOT))
    try:
        from examples import quickstart_torch
    finally:
        sys.path.remove(str(ROOT))
    return quickstart_torch


def _jax_run(max_trace):
    cfg = jdv.EngineConfig(topology=JT.one_cluster(8, 10), log_trace=True,
                           max_trace=max_trace, max_events=1 << 18)
    return cfg, jdv.simulate(cfg, jdv.make_scenario(5000, seed=42, lam=10))


def _exports(mod, res, p, W):
    """Every export of one traced row, through the module ``mod``."""
    makespan = int(res.makespan)
    dec = mod.decode_trace(res.trace, res.n_trace, p, W, makespan)
    return dict(
        decoded=dec,
        ascii=mod.ascii_gantt(dec["runs"], makespan, width=64),
        ascii80=mod.ascii_gantt(dec["runs"], makespan),
        paje=mod.to_paje(dec["runs"], makespan),
        json=mod.to_json(res, p, W, extra={"note": "quickstart"}),
        chrome=mod.to_chrome_events(dec, makespan),
        row_chrome=mod.row_chrome_events(res.trace, res.n_trace, p, W,
                                         makespan))


@pytest.fixture(scope="module")
def quickstart():
    """The quickstart's traced run in both packages: the port's through
    ``examples/quickstart_torch.py::single_run`` (the kernel's wrapper on
    CPU tensors, which runs its plain version)."""
    _, jres = _jax_run(8192)
    res, dec = _quickstart().single_run(device="cpu")
    return jres, res, dec


def test_the_traced_run_equals_the_jax_packages(quickstart):
    jres, res, _ = quickstart
    assert_results_equal(jres, res)
    assert not bool(res.overflow)
    assert 0 < int(res.n_trace) < 8192


def test_every_export_equals_the_jax_packages(quickstart):
    jres, res, dec = quickstart
    want = _exports(jg, jres, 8, 5000)
    got = _exports(gantt, res, 8, 5000)
    assert dec == want["decoded"]
    for key in want:
        assert got[key] == want[key], key
    assert json.dumps(got["chrome"]) == json.dumps(want["chrome"])


def test_the_decoded_run_is_the_schedule(quickstart):
    """Every RUN interval lies in [0, makespan]; the busy time of each
    processor is its ``executed`` work (unit tasks run one a time unit)."""
    _, res, dec = quickstart
    makespan = int(res.makespan)
    executed = res.executed.numpy()
    for proc, runs in dec["runs"].items():
        assert all(0 <= t0 <= t1 <= makespan for t0, t1 in runs)
        assert sum(t1 - t0 for t0, t1 in runs) == executed[proc], proc


@pytest.mark.parametrize("max_trace", [64, 101])
def test_a_truncated_trace_decodes_as_the_jax_packages(max_trace):
    """A trace cut at ``max_trace``: ``n_trace`` saturates there in both
    packages, and every export of the cut trace is equal."""
    jcfg, jres = _jax_run(max_trace)
    scn = eng.batch_scenarios(5000, np.array([42], np.uint32), lam=10,
                              device="cpu")
    res = ws_sim_cuda(port_config(jcfg), scn)
    res = type(res)(*(x[0] for x in res))
    assert_results_equal(jres, res)
    assert int(res.n_trace) == max_trace
    want, got = _exports(jg, jres, 8, 5000), _exports(gantt, res, 8, 5000)
    for key in want:
        assert got[key] == want[key], key


def test_decode_takes_numpy_or_a_tensor(quickstart):
    _, res, dec = quickstart
    makespan = int(res.makespan)
    for trace, n in ((res.trace, res.n_trace),
                     (res.trace.numpy(), int(res.n_trace)),
                     (res.trace.to(torch.int64), res.n_trace.numpy())):
        assert gantt.decode_trace(trace, n, 8, 5000, makespan) == dec


def test_the_chrome_document_helpers_are_the_obs_ones(quickstart, tmp_path):
    _, res, _ = quickstart
    assert gantt.chrome_trace_doc is obs.chrome_trace_doc
    assert gantt.write_chrome_trace is obs.write_chrome_trace
    assert (gantt.SIM_PID, gantt.SIM_PROCESS_NAME) == (jg.SIM_PID,
                                                       jg.SIM_PROCESS_NAME)
    with obs.trace_to() as tr:
        with obs.span("service.query", n_queries=1):
            pass
    sim = gantt.row_chrome_events(res.trace, res.n_trace, 8, 5000,
                                  int(res.makespan))
    path = gantt.write_chrome_trace(tmp_path / "combined.json",
                                    tr.chrome_events(), sim)
    doc = json.loads(Path(path).read_text())
    assert {e["pid"] for e in doc["traceEvents"]} == {obs.HOST_PID,
                                                      gantt.SIM_PID}
