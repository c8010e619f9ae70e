"""Guards of the port's boundary: ``repro_torch``, ``chip_smoke.py``, the
port's examples (``examples/*_torch.py``) and its benches
(``benchmarks/paper_torch.py``, ``benchmarks/daemon_torch.py``,
``benchmarks/run_torch.py``, ``benchmarks/smoke_ab.py``) import
neither ``jax`` nor the JAX package,
and no entry point carries on on the CPU unless it was asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py")) \
    + [ROOT / "benchmarks" / "paper_torch.py",
       ROOT / "benchmarks" / "daemon_torch.py",
       ROOT / "benchmarks" / "run_torch.py",
       ROOT / "benchmarks" / "smoke_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call):
            # importlib.import_module("x") / __import__("x") with a literal
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_the_expected_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PACKAGE_FILES}
    for want in ("core/engine.py", "core/divisible.py", "core/dag.py",
                 "core/dag_gen.py", "core/adaptive.py", "core/oracle.py",
                 "core/interop.py", "core/sweep.py", "core/backend.py",
                 "core/topology.py", "kernels/ws_sim.py", "kernels/ref.py",
                 "kernels/_build.py", "service/api.py", "service/store.py",
                 "service/resilience.py", "obs/trace.py", "obs/metrics.py",
                 "configs/base.py", "configs/qwen3_1p7b.py",
                 "models/layers.py", "models/mlp.py", "models/attention.py",
                 "models/blocks.py", "models/model.py", "models/interop.py",
                 "launch/steps.py", "launch/serve.py", "kernels/ops.py",
                 "kernels/rmsnorm.py", "kernels/flash_attention.py",
                 "kernels/decode_attention.py", "service/estimator.py",
                 "service/broker.py", "check/__init__.py",
                 "check/sanitizer.py", "sched/__init__.py",
                 "sched/planner.py", "sched/ws_scheduler.py",
                 "core/analysis.py", "core/gantt.py",
                 "configs/ws_paper.py", "service/wire.py",
                 "service/daemon.py", "service/client.py",
                 "check/protocol_lint.py", "check/__main__.py",
                 "check/dispatch_lint.py", "models/moe.py",
                 "configs/deepseek_67b.py", "configs/phi3_mini_3p8b.py",
                 "configs/command_r_35b.py", "configs/mixtral_8x7b.py",
                 "configs/phi35_moe_42b.py", "models/xlstm.py",
                 "models/ssm.py", "configs/xlstm_350m.py",
                 "configs/jamba_v01_52b.py", "configs/whisper_large_v3.py",
                 "configs/internvl2_76b.py", "tree.py", "optim/__init__.py",
                 "optim/adamw.py", "optim/compression.py",
                 "data/__init__.py", "data/pipeline.py", "data/_threefry.py",
                 "checkpoint/__init__.py", "checkpoint/ckpt.py",
                 "runtime/__init__.py", "runtime/fault.py",
                 "launch/train.py", "launch/mesh.py",
                 "launch/sharding.py", "launch/partition.py"):
        assert want in names, want
    for other in ("examples/quickstart_torch.py",
                  "examples/paper_sweep_torch.py",
                  "examples/serve_lm_torch.py",
                  "examples/train_lm_torch.py",
                  "benchmarks/paper_torch.py",
                  "benchmarks/daemon_torch.py",
                  "benchmarks/run_torch.py",
                  "benchmarks/smoke_ab.py"):
        assert ROOT / other in PORT_FILES, other
    for src in ("ws_sim.cu", "ws_sim_core.cuh", "rmsnorm.cu",
                "flash_attention.cu", "decode_attention.cu",
                "lm_common.cuh"):
        assert (ROOT / "src/repro_torch/kernels/csrc" / src).is_file(), src


_CPU_SWEEP = """
import sys, tempfile
from repro_torch.core import one_cluster, run_grid
from repro_torch.service import SimulationService
g = run_grid(one_cluster(4, 2), W_list=[500], lam_list=[2], reps=9,
             device="cpu")
with tempfile.TemporaryDirectory() as d:
    h = SimulationService(root=d, device="cpu").sweep(
        one_cluster(4, 2), W_list=[500], lam_list=[2], reps=9, chunk_size=4,
        backend="torch")
assert (g.makespan == h.makespan).all() and len(g) == 9
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


_CPU_SERVE = """
import sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, decode_batch
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import build_model
cfg = get_config("qwen3-1.7b").reduced()
m = build_model(cfg, device="cpu")
p = m.init_params(torch.Generator().manual_seed(0))
reqs = [Request(i, np.arange(1, 9, dtype=np.int32) + i, 3) for i in range(2)]
out = decode_batch(m, p, reqs, device="cpu")
lg = build_prefill_step(m, device="cpu")(p, {"tokens": torch.ones(2, 8,
                                         dtype=torch.int64)})
assert out.shape == (2, 3) and lg.shape == (2, 1, cfg.padded_vocab)
for arch in ("mixtral-8x7b", "command-r-35b", "xlstm-350m",
             "jamba-v0.1-52b"):
    m = build_model(get_config(arch).reduced(), device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    assert decode_batch(m, p, reqs, device="cpu").shape == (2, 3)
    loss, met = m.loss_fn(p, {"tokens": torch.ones(2, 8, dtype=torch.int64),
                              "labels": torch.ones(2, 8, dtype=torch.int64)})
    assert torch.isfinite(loss) and set(met) == {"loss", "xent", "moe_aux"}
for arch, key, rows in (("whisper-large-v3", "frames", "encoder_seq_len"),
                        ("internvl2-76b", "vis_embeds", "vision_prefix_len")):
    cfg = get_config(arch).reduced()
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones(2, 8, dtype=torch.int64),
             key: torch.zeros(2, getattr(cfg, rows), cfg.d_model)}
    cache, lg = m.prefill(p, batch, max_seq=cfg.vision_prefix_len + 8)
    assert lg.shape == (2, 1, cfg.padded_vocab)
    assert build_prefill_step(m, device="cpu")(p, batch).shape == lg.shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


_CPU_QUERY = """
import sys, tempfile
from repro_torch.core import one_cluster
from repro_torch.sched import plan
from repro_torch.service import PairedPolicy, SimulationService
topo = one_cluster(4, 2)
with tempfile.TemporaryDirectory() as d:
    svc = SimulationService(root=d, device="cpu")
    r = svc.query(topo, W_list=[500], lam_list=[2, 5], reps=4)
    a = svc.make_query(topo, W_list=[500], lam_list=[5], reps=4)
    b = svc.make_query(topo, W_list=[500], lam_list=[5], reps=4, mwt=True)
    pr = svc.query_pair(a, b, policy=PairedPolicy(batch_reps=4, min_reps=4,
                                                  max_reps=8))
    dec = plan(topo, work_per_group=64, reps=2, service=svc)
    again = plan(topo, work_per_group=64, reps=2, service=svc)
assert r.cells.n.tolist() == [4, 4] and pr.paired.n[0] >= 4
assert dec.n_dispatches > 0 and again.n_dispatches == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


_CPU_PAPER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from benchmarks import paper_torch as pt
from examples import quickstart_torch as qs
from repro_torch.configs import ws_paper
from repro_torch.core import analysis, gantt, one_cluster
from repro_torch.core import engine, sweep
from repro_torch.sched import WorkItem, WorkStealingScheduler
res, dec = qs.single_run(device="cpu")
assert gantt.to_paje(dec["runs"], int(res.makespan)).startswith("%EventDef")
rows = pt.fig10_overhead_ratio(
    2, ws_paper.PaperGrid((2000,), (4,), (2,), 2), device="cpu")
assert len(rows) == 1 and np.isfinite(rows[0]["ratio_med"])
model = sweep.resolve_model(one_cluster(4, 2), W_list=[900], lam_list=[2])
scn = sweep.scenario_from_rows(sweep.grid_rows([900], [2], 8), device="cpu")
_, st = engine.simulate_segmented(model, scn, seg_len=32)
assert st.n_segments > 1
s = WorkStealingScheduler(one_cluster(4, 2))
for i in range(8):
    s.submit(0, WorkItem(i, 3.0))
assert s.run().completed == 8
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


_CPU_DAEMON = """
import sys, tempfile
from pathlib import Path
from repro_torch.check import protocol_lint
from repro_torch.core import one_cluster
from repro_torch.service import DaemonClient, SimulationDaemon
with tempfile.TemporaryDirectory() as d:
    dm = SimulationDaemon(root=Path(d), coalesce_window_s=0.01,
                          device="cpu").start()
    try:
        c = DaemonClient(root=Path(d), fallback=False)
        r = c.query(one_cluster(4, 2), W_list=[500], lam_list=[2], reps=3)
        g = c.sweep(one_cluster(4, 2), W_list=[500], lam_list=[2], reps=3,
                    chunk_size=2)
    finally:
        dm.stop()
assert c._local is None and r.cells.n.tolist() == [3] and len(g) == 3
assert protocol_lint.run() == []
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


_CPU_TRAIN = """
import dataclasses, sys, tempfile
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import batch_at
from repro_torch.launch.train import build_state_and_step
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (FailureInjector, TrainLoopConfig,
                                       run_training)
cfg = get_config("qwen3-1.7b").reduced()
model, state, step = build_state_and_step(
    cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6), True,
    device="cpu")
shape = ShapeSpec("t", 32, 2, "train")
with tempfile.TemporaryDirectory() as d:
    out = run_training(TrainLoopConfig(total_steps=6, ckpt_every=2,
                                       ckpt_dir=d), step, state,
                       lambda s: batch_at(cfg, shape, s, device="cpu"),
                       injector=FailureInjector(fail_at=(3,)))
    assert ckpt.list_steps(d) == [1, 3, 5]
assert out["restarts"] == 1 and out["final_step"] == 6
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


def _run_port_alone(script: str, *args: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


def test_cpu_sweep_in_a_subprocess_loads_neither_jax_nor_repro():
    _run_port_alone(_CPU_SWEEP)


def test_cpu_serve_in_a_subprocess_loads_neither_jax_nor_repro():
    _run_port_alone(_CPU_SERVE)


def test_cpu_query_and_plan_in_a_subprocess_load_neither_jax_nor_repro():
    _run_port_alone(_CPU_QUERY)


def test_cpu_paper_surface_in_a_subprocess_loads_neither_jax_nor_repro():
    """The traced quickstart run, a figure bench, the segmented loop and the
    host scheduler on the CPU."""
    _run_port_alone(_CPU_PAPER, str(ROOT))


def test_cpu_daemon_client_and_lint_in_a_subprocess_load_neither_jax_nor_repro():
    _run_port_alone(_CPU_DAEMON)


def test_cpu_training_in_a_subprocess_loads_neither_jax_nor_repro():
    """The training path: data, EF-int8 and AdamW steps, a failure, a
    resume from a checkpoint."""
    _run_port_alone(_CPU_TRAIN)


def _skip_if_cuda():
    if torch.cuda.is_available():
        pytest.skip("this guard describes a host without a CUDA device")


def test_no_silent_cpu_run_without_a_cuda_device(tmp_path):
    _skip_if_cuda()
    from repro_torch.core import (get_backend, make_scenario, one_cluster,
                                  quick_sim, run_grid, run_rows)
    from repro_torch.core import sweep as psw
    from repro_torch.service import SimulationService
    topo = one_cluster(4, 2)
    kw = dict(W_list=[500], lam_list=[2], reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_grid(topo, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_grid(topo, backend="torch", **kw)
    model = psw.resolve_model(topo, W_list=[500], lam_list=[2])
    with pytest.raises(RuntimeError):
        run_rows(model, psw.grid_rows([500], [2], 2))
    with pytest.raises(RuntimeError):
        get_backend(None)
    with pytest.raises(RuntimeError):
        SimulationService(root=tmp_path)
    with pytest.raises(RuntimeError):
        make_scenario(10, 1)
    with pytest.raises(RuntimeError):
        quick_sim(4, 100, 2)
    assert not list(tmp_path.iterdir())


def test_cuda_backend_is_unavailable_and_never_gives_way(tmp_path):
    _skip_if_cuda()
    from repro_torch.core import get_backend, one_cluster, run_grid
    from repro_torch.service import SimulationService
    caps = get_backend("cuda").capabilities()
    assert caps.available is False and caps.devices == ()
    be = get_backend("torch")
    n = be.n_run_rows
    kw = dict(W_list=[500], lam_list=[2], reps=2)
    with pytest.raises(RuntimeError, match="not available"):
        run_grid(one_cluster(4, 2), backend="cuda", device="cpu", **kw)
    with pytest.raises(RuntimeError, match="not available"):
        SimulationService(root=tmp_path, device="cpu").sweep(
            one_cluster(4, 2), backend="cuda", chunk_size=2, **kw)
    assert be.n_run_rows == n and not list(tmp_path.glob("*.npz"))


def test_no_backend_demotion_in_the_port():
    """Nothing demotes a dispatch on the card: the chain of a dispatch whose
    tensors lie on a CUDA device is its primary alone, the ``cuda`` backend
    is never given up, and no backend is picked by cost. Only the host
    backends may stand in for each other, on the CPU."""
    from repro_torch import obs
    from repro_torch.core import backend as pbk
    from repro_torch.core import one_cluster
    from repro_torch.core import sweep as psw
    from repro_torch.kernels import _build
    from repro_torch.service import resilience as rz
    model = psw.resolve_model(one_cluster(4, 2), W_list=[500], lam_list=[2])
    for name in pbk.backend_names():
        assert rz.fallback_chain(name, model, "cuda") == [name]
    assert rz.fallback_chain("cuda", model, "cpu") == ["cuda"]
    assert "cuda" not in rz.FALLBACK_ORDER
    assert not hasattr(pbk, "cheapest_backend")
    summary = rz.degraded_summary(obs.MetricsRegistry())
    assert summary["degraded"] is False and summary["fallbacks"] == 0
    with rz.fault_plan(rz.FaultPlan(sites={"backend.run_rows": rz.At(0)})):
        with pytest.raises(rz.InjectedFault):
            rz.fault_point("backend.run_rows", backend="torch")
        assert rz.fault_point("backend.run_rows", backend="torch") is None
    # the kernels build inside the checkout, nowhere else
    assert not hasattr(_build, "BUILD_DIR_ENV")
    root = Path(_build.__file__).resolve().parents[3]
    assert _build.build_dir() == root / "build" / "repro_torch_kernels"


def test_no_silent_cpu_run_of_the_query_path(tmp_path):
    """Without CUDA and without ``device``, the query path and the planner
    raise instead of running on the host, and write nothing."""
    _skip_if_cuda()
    from repro_torch.core import one_cluster
    from repro_torch.core import sweep as psw
    from repro_torch.sched import planner
    from repro_torch.service import ResultStore, SimulationService
    from repro_torch.service import resilience as rz
    from repro_torch.service.broker import QueryBroker
    topo = one_cluster(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationService(root=tmp_path).query(topo, W_list=[500],
                                               lam_list=[2], reps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryBroker()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryBroker(store=ResultStore(root=tmp_path))
    assert planner._DEFAULT_SERVICE is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.default_service()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.plan_for_mesh(2, 32, dcn_delay=200)
    assert planner._DEFAULT_SERVICE is None
    model = psw.resolve_model(topo, W_list=[500], lam_list=[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rz.fallback_chain("torch", model)
    assert not list(tmp_path.iterdir())


def test_no_silent_cpu_run_of_the_daemon(tmp_path):
    """Without CUDA and without ``device``, the daemon, its command line and
    a client's library mode raise instead of running on the host."""
    _skip_if_cuda()
    from repro_torch.core import one_cluster
    from repro_torch.service import DaemonClient, SimulationDaemon
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationDaemon(root=tmp_path / "a")
    c = DaemonClient(root=tmp_path / "b")        # nothing listening
    with pytest.raises(RuntimeError, match="device='cpu'"):
        c.query(one_cluster(4, 2), W_list=[500], lam_list=[2], reps=2)
    assert c.n_fallbacks == 1
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.service.daemon",
                          "--root", str(tmp_path / "c")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    assert "READY" not in out.stdout
    assert not list(tmp_path.rglob("*.npz"))
    assert not list(tmp_path.rglob("daemon.sock"))


def test_no_silent_cpu_run_of_the_paper_surface():
    """The figure benches, the examples and serve's command line raise
    without a CUDA device unless given ``device="cpu"``."""
    _skip_if_cuda()
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import paper_torch as pt
        from examples import paper_sweep_torch as ps
        from examples import quickstart_torch as qs
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.launch import serve
    sys.path.insert(0, str(ROOT))
    try:
        from examples import serve_lm_torch
    finally:
        sys.path.remove(str(ROOT))
    for call in (lambda: pt.fig10_overhead_ratio(2),
                 lambda: pt.fig11_accept_latency(2),
                 lambda: pt.fig12_mwt_swt(2, False),
                 lambda: pt.steal_threshold(2),
                 lambda: pt.multicluster(2),
                 lambda: pt.backend_matrix(2),
                 lambda: qs.single_run(), lambda: qs.sweep(),
                 lambda: ps.acceptable_latency(2),
                 lambda: ps.all_task_models(2),
                 lambda: ps.execution_backends(2),
                 lambda: serve.main([]),
                 lambda: serve.main(serve_lm_torch.ARGV)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_no_silent_cpu_run_of_the_simulator_benches_and_the_lint():
    """The benches of ``benchmarks/run_torch.py`` and the dispatch lint
    raise without a CUDA device unless given ``device="cpu"``."""
    _skip_if_cuda()
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import run_torch as rt
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.check import dispatch_lint, run_pass
    for call in (lambda: rt.sim_throughput(2), lambda: rt.model_throughput(2),
                 lambda: rt.sched_planner(2),
                 lambda: rt.service_throughput(2),
                 lambda: rt.paired_comparison(2), lambda: rt.obs_overhead(2),
                 lambda: rt.sanitizer_overhead(2),
                 lambda: rt.fault_recovery(2), lambda: dispatch_lint.run(),
                 lambda: run_pass("dispatch")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_no_silent_cpu_run_of_the_language_model_path():
    _skip_if_cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import Model, build_model
    cfg = get_config("qwen3-1.7b").reduced()
    for make in (Model, build_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    reqs = [Request(0, np.arange(1, 5, dtype=np.int32), 2)]
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw
    sys.path.insert(0, str(ROOT))
    try:
        from examples import train_lm_torch
    finally:
        sys.path.remove(str(ROOT))
    for call in (lambda: decode_batch(m, p, reqs),
                 lambda: build_prefill_step(m),
                 lambda: build_decode_step(m),
                 lambda: build_train_step(m, adamw.AdamWConfig()),
                 lambda: train.main(["--reduced", "--steps", "2"]),
                 lambda: train.main(train_lm_torch.ARGV)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


#: the kernel wrappers of the language-model path and what they share
LM_WRAPPER_FILES = ("kernels/ops.py", "kernels/_lm.py", "kernels/rmsnorm.py",
                    "kernels/flash_attention.py",
                    "kernels/decode_attention.py")


@pytest.mark.parametrize("rel", LM_WRAPPER_FILES)
def test_lm_kernel_wrappers_have_no_fallback(rel):
    """A wrapper launches its kernel on a CUDA tensor or raises: its module
    holds no ``try`` that could turn a failed build or launch into a run of
    the plain version, and a device that is neither the CPU nor CUDA is
    refused, not computed on."""
    tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_lm_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import ops
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ops.rms_norm(x, torch.ones(8, device="meta"))
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ops.flash_decode(q[:, :1], q, q, 2)


def test_no_quiet_gloo_and_no_silent_cpu_mesh():
    """A mesh follows the device rule (None is the card, and raises
    without one), and nccl is never swapped for gloo: gloo runs only where
    the device is the CPU or the caller names it."""
    _skip_if_cuda()
    from repro_torch.launch import mesh as pmesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_test_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.init_world()
    with pytest.raises(ValueError, match="nccl"):
        pmesh.init_world("nccl", device="cpu")
    with pytest.raises(ValueError, match="init_method"):
        pmesh.init_world("gloo", world_size=4, device="cpu")
    import torch.distributed as dist
    assert not dist.is_initialized()
