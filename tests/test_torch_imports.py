"""Guards of the port's boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package, and no entry point carries on on the CPU
unless it was asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
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
             for p in PORT_FILES[:-1]}
    for want in ("core/engine.py", "core/divisible.py", "core/oracle.py",
                 "core/interop.py", "core/sweep.py", "core/backend.py",
                 "core/topology.py", "kernels/ws_sim.py", "kernels/ref.py",
                 "kernels/_build.py", "service/api.py", "service/store.py",
                 "service/resilience.py", "obs/trace.py", "obs/metrics.py"):
        assert want in names, want
    assert (ROOT / "src/repro_torch/kernels/csrc/ws_sim.cu").is_file()


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


def test_cpu_sweep_in_a_subprocess_loads_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CPU_SWEEP], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


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
    """The slice ships fault injection, store retry and the degraded summary
    only: nothing that would demote a failed kernel launch to the plain loop
    or to the host."""
    from repro_torch import obs
    from repro_torch.core import backend as pbk
    from repro_torch.kernels import _build
    from repro_torch.service import resilience as rz
    for name in ("FALLBACK_ORDER", "fallback_chain", "dispatch_resilient",
                 "CircuitBreaker", "ResilienceConfig"):
        assert not hasattr(rz, name), name
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
