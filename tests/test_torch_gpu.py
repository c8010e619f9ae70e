"""The CUDA kernels on the card: every body of ``ws_sim.cu`` against its plain
version on the same CUDA tensors, every leaf ``torch.equal``; the three
language-model kernels (``rmsnorm.cu``, ``flash_attention.cu``,
``decode_attention.cu``) against their plain versions within the JAX
package's kernel tolerances; the reduced model on the card against the CPU.

A CUDA kernel has no interpret mode, so these tests carry the ``gpu`` marker
and skip where there is no CUDA device. This file imports the port alone (no
JAX, no JAX package), so that it runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import ast
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import adaptive as pad
from repro_torch.core import dag as pdg
from repro_torch.core import dag_gen as pgen
from repro_torch.core import divisible as pdv
from repro_torch.core import topology as PT
from repro_torch.kernels import ref
from repro_torch.kernels.ws_sim import ws_sim_cuda

STRATEGIES = (PT.UNIFORM, PT.LOCAL_FIRST, PT.INV_DISTANCE, PT.ROUND_ROBIN)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")


def _launch_and_hold(cfg, scn, body, msg):
    before = dict(ws_sim_cuda.launches_by_body)
    total = ws_sim_cuda.launches
    got = ws_sim_cuda(cfg, scn)
    torch.cuda.synchronize()
    assert ws_sim_cuda.launches == total + 1
    assert ws_sim_cuda.launches_by_body[body] == before[body] + 1
    want = ref.ws_sim_ref(cfg, scn)
    assert type(got) is type(want)
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{msg}: {f}"
    return got


def _scenario(W, n=16, **kw):
    return pdv.batch_scenarios(W, np.arange(n) + 3, lam_local=2, lam_remote=7,
                               remote_prob=0.3, device="cuda", **kw)


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card():
    """The divisible body, four strategies, trace on."""
    _need_card()
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        cfg = pdv.EngineConfig(topology=topo, mwt=bool(strategy % 2),
                               max_events=1 << 16, log_trace=True,
                               max_trace=128)
        _launch_and_hold(cfg, _scenario(3000, theta_static=2, theta_comm=1),
                         "ws_sim_divisible", f"strategy={strategy}")


@pytest.mark.gpu
def test_dag_body_on_the_card():
    """The DAG body: LIFO and FIFO, a deque cap that halts rows, trace on."""
    _need_card()
    dagf = pgen.random_layered(6, 8, 0.4, seed=5)
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        for lifo, cap in ((True, None), (False, 12)):
            cfg = pdg.DagEngineConfig(topology=topo, dag=dagf, mwt=lifo,
                                      owner_lifo=lifo, deque_cap=cap,
                                      max_events=1 << 16, log_trace=True,
                                      max_trace=128)
            got = _launch_and_hold(cfg, _scenario(0), "ws_sim_dag",
                                   f"strategy={strategy} lifo={lifo}")
            if cap is None:
                assert (got.n_completed == dagf.n).all()


@pytest.mark.gpu
def test_adaptive_body_on_the_card():
    """The adaptive body: beta 1/16 and a negative denominator, a pool that
    fills, trace on."""
    _need_card()
    merges = (dict(merge_alpha=2, merge_beta_num=1),
              dict(merge_alpha=30, merge_beta_num=3, merge_beta_den=-5))
    for strategy in STRATEGIES:
        topo = PT.multi_cluster(4, 4, 7, 2, "ring").with_strategy(strategy,
                                                                  0.3)
        for merge, pool in zip(merges, (4096, 15)):
            cfg = pad.AdaptiveEngineConfig(topology=topo,
                                           mwt=bool(strategy % 2),
                                           pool_cap=pool, max_events=1 << 16,
                                           log_trace=True, max_trace=128,
                                           **merge)
            got = _launch_and_hold(
                cfg, _scenario(3000, theta_static=2, theta_comm=1),
                "ws_sim_adaptive", f"strategy={strategy} pool={pool}")
            assert (got.n_created <= pool).all() and not got.overflow.any()


# ---------------------------------------------------------------------------
# Every body at the slot-count boundaries of the register variant, each case
# bit-exact against the plain loop on the card. The cases are chip_smoke.py's
# (``boundary_case``), so the two cannot drift apart.
# ---------------------------------------------------------------------------

_CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _literal(name):
    """A module-level constant of chip_smoke.py, read without importing it
    (the script exits where there is no CUDA device)."""
    for node in ast.parse(_CHIP_SMOKE.read_text()).body:
        if isinstance(node, ast.Assign) and \
                [getattr(t, "id", None) for t in node.targets] == [name]:
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} not in chip_smoke.py")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up there
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("p", _literal("BOUNDARY_P"))
@pytest.mark.parametrize("body", _literal("BODIES"))
def test_every_body_at_the_slot_boundaries(body, p):
    _need_card()
    from repro_torch.kernels import ws_sim as ws
    cfg, scn = _chip_smoke().boundary_case(body, p)
    name, _ = ws.variant(p)
    assert name == "registers"
    by_variant = dict(ws_sim_cuda.launches_by_variant)
    got = _launch_and_hold(cfg, scn, body, f"{body} p={p} {cfg.topology.name}")
    assert ws_sim_cuda.launches_by_variant[name] == by_variant[name] + 1
    assert bool(got.overflow[1]) and int(got.n_events[1]) == 3


# ---------------------------------------------------------------------------
# The language-model kernels: each against its plain version on the card, at
# tests/test_kernels.py's tolerances (attention 2e-5 float32 / 2e-2 bf16,
# RMSNorm 1e-6 float32 / 2e-2 bf16).
# ---------------------------------------------------------------------------

_LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _lm_randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _hold(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_on_the_card(dtype):
    _need_card()
    from repro_torch.kernels import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for R, D in ((24, 2048), (384, 128), (100, 512), (7, 100), (1, 128)):
        x = _lm_randn(gen, (R, D), dtype, 3.0)
        s = _lm_randn(gen, (D,), dtype)
        n = rmsnorm.rms_norm.launches
        got = rmsnorm.rms_norm(x, s)
        torch.cuda.synchronize()
        assert rmsnorm.rms_norm.launches == n + 1
        _hold(got, rmsnorm.rms_norm_ref(x, s), tol)


# every width of the register kernel at one row, a decode step's 24 rows and
# more row groups than the card holds at once (the grid-stride loop); each
# width then takes both of its thread counts (a few rows: many threads a row)
_RMS_ROWS = (1, 24, 17000)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_register_kernel_at_every_width(D, dtype):
    _need_card()
    from repro_torch.kernels import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(D)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    tprs = set()
    for R in _RMS_ROWS:
        x = _lm_randn(gen, (R, D), dtype, 3.0)
        s = _lm_randn(gen, (D,), dtype)
        tpr = rmsnorm.threads_per_row(R, D, dtype)
        assert tpr > 0
        tprs.add(tpr)
        n = rmsnorm.rms_norm.launches_by_variant["row_in_registers"]
        got = rmsnorm.rms_norm(x, s)
        torch.cuda.synchronize()
        assert rmsnorm.rms_norm.launches_by_variant["row_in_registers"] == n + 1
        _hold(got, rmsnorm.rms_norm_ref(x, s), tol)
    nvec = D * x.element_size() // 16
    assert len(tprs) == (1 if nvec <= 32 else 2)


# B, Sq, Skv, H, KV, hd, causal, window, q_offset: ragged Sq / Skv (33, 100,
# 2047: partial q and kv tiles of either kernel), q_offsets, windows,
# non-causal, G = H / KV of 1, 2, 3 and 4, every head dim
_ATTENTION_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (2, 100, 100, 2, 1, 16, True, 0, 0),
    (1, 64, 64, 8, 2, 128, False, 0, 0),
    (1, 192, 192, 6, 3, 32, True, 32, 0),
    (2, 50, 80, 4, 2, 128, True, 0, 30),
    (1, 33, 33, 4, 4, 128, True, 0, 0),
    (2, 100, 100, 4, 2, 64, True, 0, 0),
    (1, 2047, 2047, 4, 1, 128, True, 0, 0),
    (1, 2047, 2047, 2, 2, 32, False, 0, 0),
    (2, 100, 333, 8, 2, 16, True, 0, 233),
    (1, 256, 700, 4, 2, 128, True, 0, 444),
    (1, 300, 300, 4, 1, 64, True, 100, 0),
    (2, 513, 513, 2, 1, 32, True, 7, 0),
    (1, 200, 600, 4, 2, 16, True, 150, 400),
    (1, 100, 257, 8, 4, 64, False, 0, 0),
    (1, 128, 128, 4, 2, 128, False, 50, 0),
    (2, 1, 40, 4, 2, 128, True, 0, 39),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_the_card(dtype):
    """Each case through its dtype's kernel (bf16: the tensor cores, float32:
    the CUDA cores), held to the plain version."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    variant = "tc_bf16" if dtype == torch.bfloat16 else "simt_f32"
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, Sq, Skv, H, KV, hd, causal, win, qo in _ATTENTION_CASES:
        q = _lm_randn(gen, (B, Sq, H, hd), dtype)
        k = _lm_randn(gen, (B, Skv, KV, hd), dtype)
        v = _lm_randn(gen, (B, Skv, KV, hd), dtype)
        kw = dict(causal=causal, window=win, q_offset=qo)
        n = fa.flash_attention.launches
        nv = fa.flash_attention.launches_by_variant[variant]
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == n + 1
        assert fa.flash_attention.launches_by_variant[variant] == nv + 1
        _hold(got, fa.flash_attention_ref(q, k, v, **kw),
              _LM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_on_the_card(dtype):
    """Every kv_len of a short cache, a window, and a float32 q against a
    cache of ``dtype`` (the serving path's bf16 cache beside f32 q)."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, Smax, H, KV, hd, win in ((3, 24, 16, 8, 128, 0),
                                    (2, 40, 4, 2, 16, 5)):
        kc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        vc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        for qdt in (dtype, torch.float32):
            q = _lm_randn(gen, (B, 1, H, hd), qdt)
            for kv_len in range(1, Smax + 1):
                n = fd.flash_decode.launches
                got = fd.flash_decode(q, kc, vc, kv_len, window=win)
                torch.cuda.synchronize()
                assert fd.flash_decode.launches == n + 1
                want = fd.decode_attention_ref(q, kc, vc, kv_len, window=win)
                _hold(got, want, _LM_TOL[qdt])


@pytest.mark.gpu
def test_reduced_model_on_the_card_matches_the_cpu():
    """The reduced qwen3-1.7b in float32: forward logits on the card (through
    the kernels) against the CPU (plain versions), and greedy tokens."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    mc, mg = build_model(cfg, device="cpu"), build_model(cfg)
    pc = mc.init_params(torch.Generator(device="cpu").manual_seed(3))

    def to_card(t):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in t.items()}
    pg = to_card(pc)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    a = mc.forward(pc, {"tokens": tok})
    b = mg.forward(pg, {"tokens": tok.cuda()}).cpu()
    tol = 1e-4 * float(a.abs().max())
    assert float((a - b).abs().max()) < tol
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 16).astype(np.int32),
                    8) for i in range(6)]
    np.testing.assert_array_equal(
        decode_batch(mc, pc, reqs, device="cpu"),
        decode_batch(mg, pg, reqs))
