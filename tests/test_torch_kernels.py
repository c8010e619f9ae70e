"""The module that holds the kernel, ``repro_torch.kernels.ws_sim``.

On the CPU its wrapper takes the kernel's plain version (and only because
the tensors lie on the CPU); that path is held here against the JAX package's
Pallas kernel run in interpret mode, on the same numpy-made inputs, with no
tolerance. The CUDA kernel itself has no interpret mode: the tests that
launch it are in ``tests/test_torch_gpu.py`` (marked ``gpu``, JAX-free so
that they run on a GPU machine without JAX) and skip where there is no
card."""
import numpy as np
import pytest
import torch

from repro.core import divisible as jdv
from repro.core import topology as JT
from repro.kernels.ws_sim import ws_sim_pallas
from repro_torch.core import divisible as pdv
from repro_torch.core import topology as PT
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ws_sim import ws_sim_cuda
from test_torch_common import (STRATEGIES, assert_results_equal, port_config,
                               port_scenario, seeded_scenario)


def _pallas_vs_port(cfg, scn, msg=""):
    expect = ws_sim_pallas(cfg, scn, interpret=True)
    before = ws_sim_cuda.launches
    got = ws_sim_cuda(port_config(cfg), port_scenario(scn))
    assert ws_sim_cuda.launches == before    # CPU tensors: no kernel launch
    assert_results_equal(expect, got, msg)
    return got


@pytest.mark.parametrize("p,W,lam,mwt", [
    (4, 1000, 3, False), (8, 5000, 25, True), (16, 20000, 7, False),
])
def test_ws_sim_one_cluster(p, W, lam, mwt):
    topo = JT.one_cluster(p, lam)
    cfg = jdv.EngineConfig(topology=topo, mwt=mwt, max_events=1 << 18)
    scn = jdv.batch_scenarios(W, np.arange(8, dtype=np.uint32) + 1, lam=lam)
    got = _pallas_vs_port(cfg, scn)
    assert not got.overflow.any()


def test_ws_sim_two_clusters_local_first():
    topo = JT.two_clusters(6, 50).with_strategy(JT.LOCAL_FIRST,
                                                remote_prob=0.3)
    cfg = jdv.EngineConfig(topology=topo, mwt=False, max_events=1 << 18)
    scn = jdv.batch_scenarios(4000, np.arange(4, dtype=np.uint32) + 9,
                              lam_local=1, lam_remote=50, remote_prob=0.3)
    _pallas_vs_port(cfg, scn)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ws_sim_strategies(strategy):
    topo = JT.multi_cluster(3, 2, 6, 1, "ring").with_strategy(strategy, 0.3)
    cfg = jdv.EngineConfig(topology=topo, mwt=strategy % 2 == 1,
                           max_events=1 << 16)
    scn = seeded_scenario(20 + strategy, 4, 1500, topo, theta=(2, 1),
                          remote_prob=0.3)
    _pallas_vs_port(cfg, scn, f"strategy={strategy}")


def test_ws_sim_ref_is_the_plain_loop():
    topo = PT.one_cluster(4, 3)
    cfg = pdv.EngineConfig(topology=topo, max_events=1 << 14)
    scn = pdv.batch_scenarios(800, np.arange(3) + 1, lam=3, device="cpu")
    assert_results_equal(pdv.simulate_batch(cfg, scn),
                         ref.ws_sim_ref(cfg, scn))
    assert_results_equal(ref.ws_sim_ref(pdv.DivisibleModel(cfg), scn),
                         ws_sim_cuda(cfg, scn))


@pytest.mark.parametrize("p", [1, 1025])
def test_wrapper_refuses_unsupported_p(p):
    topo = PT.one_cluster(p, 1)
    cfg = pdv.EngineConfig(topology=topo)
    scn = pdv.batch_scenarios(10, [1], device="cpu")
    with pytest.raises(ValueError, match="p="):
        ws_sim_cuda(cfg, scn)


def test_wrapper_checks_leaves():
    cfg = pdv.EngineConfig(topology=PT.one_cluster(4, 1))
    scn = pdv.batch_scenarios(10, [1, 2], device="cpu")
    with pytest.raises(TypeError, match="seed"):
        ws_sim_cuda(cfg, scn._replace(seed=scn.seed.to(torch.int32)))
    with pytest.raises(ValueError, match="length"):
        ws_sim_cuda(cfg, scn._replace(W=scn.W[:1]))
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((2, 2), dtype=torch.int32)
        ws_sim_cuda(cfg, scn._replace(W=wide[:, 0]))
    with pytest.raises(NotImplementedError):
        ws_sim_cuda(object(), scn)


def test_kernel_sources_ship_with_the_package():
    assert _build.sources() == ("decode_attention", "flash_attention",
                                "flash_attention_tc", "rmsnorm", "ws_sim")
    for name, launcher in (("ws_sim", "ws_sim_divisible_launch"),
                           ("rmsnorm", "rmsnorm_launch"),
                           ("flash_attention", "flash_attention_launch"),
                           ("flash_attention_tc", "flash_attention_tc_launch"),
                           ("decode_attention", "decode_attention_launch")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert launcher in text and "torch/extension.h" not in text
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """An edited header must give another library name (and so a rebuild),
    as an edited source does; an unchanged tree gives the same name."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    assert (tmp_path / "ws_sim_core.cuh").is_file()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("ws_sim")
    assert _build._target("ws_sim") == first
    hdr = tmp_path / "ws_sim_core.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    second = _build._target("ws_sim")
    assert second != first and second.parent == first.parent
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("ws_sim") not in (first, second)
    src = tmp_path / "ws_sim.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._target("ws_sim") not in (first, second)
