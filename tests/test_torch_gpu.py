"""The CUDA kernels on the card: every body of ``ws_sim.cu`` against its plain
version on the same CUDA tensors, every leaf ``torch.equal``; the three
language-model kernels (``rmsnorm.cu``, ``flash_attention.cu``,
``decode_attention.cu``) against their plain versions within the JAX
package's kernel tolerances, flash decode also with a device kv_len replayed
in a CUDA graph and on its split path, and the gradient through each wrapper;
the reduced models (dense, MoE, parallel block, the recurrent mixers) on the
card against the CPU, and ``decode_batch``'s graph against the eager loop
(dense, MoE, recurrent, Whisper's encoder-decoder, InternVL's vision
prefix on two graphs); head dim 96 in both attention kernels; the
simulation daemon on the card answering a client process;
``ws_sim_cuda(grid_chunk=)`` against the unchunked launch, the dispatch
lint's host-sync counts of the decode step and of an event-loop step on the
card; and the training path: a reduced train step on the card against the
CPU with its exact kernel launches, the bf16 logits' gradient, a checkpoint
of a state on the card restored onto the card, and a failure before the
first checkpoint restarting from the initial state on the card.

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


def _hold_to_a_bf16_step(got, want):
    """A bfloat16 output within one bfloat16 step of its largest value M,
    (2**-7 + 2e-5) M: both sides round float32 values that agree to 2e-5,
    and the limit shrinks with an output that averages thousands of rows
    (as chip_smoke.py's ``lm_within_a_bf16_step``)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= (2.0 ** -7 + _LM_TOL[torch.float32]) * scale


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
#: (D, bytes an element) -> the launcher's threads a row for many rows and
#: for few: powers of two that divide the row's 16-byte vectors, at most 8
#: vectors a thread (``csrc/rmsnorm.cu::Width``)
_RMS_THREADS = {(128, 2): (16, 16), (128, 4): (32, 32), (256, 2): (32, 32),
                (256, 4): (32, 64), (512, 2): (32, 64), (512, 4): (32, 128),
                (1024, 2): (32, 128), (1024, 4): (32, 256),
                (1280, 2): (32, 32), (1280, 4): (64, 64),
                (2048, 2): (32, 256), (2048, 4): (64, 256),
                (3072, 2): (64, 128), (3072, 4): (128, 256),
                (4096, 2): (64, 256), (4096, 4): (128, 256),
                (8192, 2): (128, 256), (8192, 4): (256, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 512, 1024, 1280, 2048, 3072, 4096,
                               8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_register_kernel_at_every_width(D, dtype):
    _need_card()
    from repro_torch.kernels import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(D)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    many, few = _RMS_THREADS[(D, torch.empty((), dtype=dtype).element_size())]
    for R in _RMS_ROWS:
        x = _lm_randn(gen, (R, D), dtype, 3.0)
        s = _lm_randn(gen, (D,), dtype)
        assert rmsnorm.threads_per_row(R, D, dtype) == \
            (many if R == _RMS_ROWS[-1] else few)
        n = rmsnorm.rms_norm.launches_by_variant["row_in_registers"]
        got = rmsnorm.rms_norm(x, s)
        torch.cuda.synchronize()
        assert rmsnorm.rms_norm.launches_by_variant["row_in_registers"] == n + 1
        _hold(got, rmsnorm.rms_norm_ref(x, s), tol)


# B, Sq, Skv, H, KV, hd, causal, window, q_offset: ragged Sq / Skv (33, 100,
# 2047: partial q and kv tiles of either kernel), q_offsets, windows,
# non-causal, G = H / KV of 1, 2, 3 and 4, every head dim (96: phi3-mini's,
# three 32-column sub-tiles on the tensor cores)
_ATTENTION_CASES = [
    (1, 300, 300, 4, 4, 96, True, 0, 0),
    (2, 100, 257, 4, 2, 96, True, 50, 157),
    (1, 130, 130, 2, 1, 96, False, 0, 0),
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
    # Whisper's encoder (non-causal over 1500 frames: a ragged last tile),
    # cross-attention (Sq != Skv) and decoder self-attention, 20 heads of
    # 64; InternVL's G = 8, also over its 256 patch rows and 2048 tokens
    (1, 1500, 1500, 20, 20, 64, False, 0, 0),
    (1, 300, 1500, 20, 20, 64, False, 0, 0),
    (1, 300, 300, 20, 20, 64, True, 0, 0),
    (1, 512, 512, 64, 8, 128, True, 0, 0),
    (1, 2304, 2304, 64, 8, 128, True, 0, 0),
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
    cache of ``dtype`` (the serving path's bf16 cache beside f32 q); G = 8
    at InternVL's heads, also over the 280 rows it serves from at a few
    kv_len, Whisper's self-attention cache (G = 1, hd 64) and its cross
    cache of 1500 rows at a few kv_len."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, Smax, H, KV, hd, win, lens in (
            (3, 24, 16, 8, 128, 0, range(1, 25)),
            (2, 40, 4, 2, 16, 5, range(1, 41)),
            (2, 24, 64, 8, 128, 0, range(1, 25)),
            (2, 280, 64, 8, 128, 0, (1, 24, 257, 269, 280)),
            (2, 24, 20, 20, 64, 0, range(1, 25)),
            (2, 1500, 20, 20, 64, 0, (1, 777, 1500))):
        kc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        vc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        for qdt in (dtype, torch.float32):
            q = _lm_randn(gen, (B, 1, H, hd), qdt)
            for kv_len in lens:
                n = fd.flash_decode.launches
                got = fd.flash_decode(q, kc, vc, kv_len, window=win)
                torch.cuda.synchronize()
                assert fd.flash_decode.launches == n + 1
                want = fd.decode_attention_ref(q, kc, vc, kv_len, window=win)
                _hold(got, want, _LM_TOL[qdt])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_head_dim_96(dtype):
    """Head dim 96 (phi3-mini-3.8b: 32 heads, G = 1), whose rows are 12
    (bf16) or 24 (float32) 16-byte loads, in lane groups of 16 or 32: every
    kv_len of the serving cache with kv_len as an int and on the device, a
    window, and a long cache on the split path; q of the cache's type and
    float32."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, Smax, H, KV, win, lens in ((24, 24, 32, 32, 0, range(1, 25)),
                                      (3, 40, 4, 2, 5, (1, 17, 40)),
                                      (1, 8192, 32, 32, 0, (8192, 3000, 1)),
                                      (1, 8192, 32, 32, 700, (8192, 5000))):
        kc = _lm_randn(gen, (B, Smax, KV, 96), dtype)
        vc = _lm_randn(gen, (B, Smax, KV, 96), dtype)
        variant = fd.VARIANTS[fd.num_splits(B, H, KV, Smax, sms)[0] > 1]
        for qdt in (dtype, torch.float32):
            q = _lm_randn(gen, (B, 1, H, 96), qdt)
            for n in lens:
                for kv_len in (n, torch.tensor(n, dtype=torch.int32,
                                               device="cuda")):
                    before = fd.flash_decode.launches_by_variant[variant]
                    got = fd.flash_decode(q, kc, vc, kv_len, window=win)
                    torch.cuda.synchronize()
                    assert fd.flash_decode.launches_by_variant[variant] == \
                        before + 1
                    want = fd.decode_attention_ref(q, kc, vc, n, window=win)
                    _hold(got, want, _LM_TOL[qdt])
                    if qdt == torch.bfloat16:
                        _hold_to_a_bf16_step(got, want)


# B, Smax, H, KV, hd, window: the serving shape (one split), a window at a
# small head dim, and a cache that takes two splits
_GRAPH_DECODE_CASES = [(3, 24, 16, 8, 128, 0), (2, 40, 4, 2, 16, 5),
                       (1, 600, 16, 8, 128, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_graph_replays_every_kv_len(dtype):
    """One launch with a device kv_len, captured in a CUDA graph, replayed
    for every kv_len in 1..Smax: each result equals the plain version's, so
    nothing of kv_len froze in the capture."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, Smax, H, KV, hd, win in _GRAPH_DECODE_CASES:
        kc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        vc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
        q = _lm_randn(gen, (B, 1, H, hd), dtype)
        kv_len = torch.full((1,), Smax, dtype=torch.int32, device="cuda")
        fd.flash_decode(q, kc, vc, kv_len, window=win)      # build, warm
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fd.flash_decode(q, kc, vc, kv_len, window=win)
        for n in range(1, Smax + 1):
            kv_len.fill_(n)
            graph.replay()
            torch.cuda.synchronize()
            _hold(out, fd.decode_attention_ref(q, kc, vc, n, window=win),
                  _LM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_path(dtype):
    """A long cache (1, 8192) takes the split variant: full, partial and
    one-row kv_len, and windows that leave most splits empty; kv_len as an
    int and on the device; q of the cache's type and float32. A bfloat16
    output is also held to one bfloat16 step of its largest value."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, Smax, H, KV, hd = 1, 8192, 16, 8, 128
    kc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
    vc = _lm_randn(gen, (B, Smax, KV, hd), dtype)
    for qdt in (dtype, torch.float32):
        q = _lm_randn(gen, (B, 1, H, hd), qdt)
        for n, win in ((8192, 0), (5000, 0), (1, 0), (8192, 300),
                       (4000, 1000), (257, 256)):
            for kv_len in (n, torch.tensor(n, dtype=torch.int32,
                                           device="cuda")):
                before = fd.flash_decode.launches_by_variant["split"]
                got = fd.flash_decode(q, kc, vc, kv_len, window=win)
                torch.cuda.synchronize()
                assert fd.flash_decode.launches_by_variant["split"] == \
                    before + 1
                want = fd.decode_attention_ref(q, kc, vc, n, window=win)
                _hold(got, want, _LM_TOL[qdt])
                if qdt == torch.bfloat16:
                    _hold_to_a_bf16_step(got, want)


@pytest.mark.gpu
def test_flash_decode_split_path_is_bit_identical_run_to_run():
    """The splits are merged in a fixed order, with no float atomics: two
    runs of the same inputs give the same bits."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    gen = torch.Generator(device="cuda").manual_seed(6)
    kc = _lm_randn(gen, (2, 32768, 8, 128), torch.bfloat16)
    vc = _lm_randn(gen, (2, 32768, 8, 128), torch.bfloat16)
    q = _lm_randn(gen, (2, 1, 16, 128), torch.bfloat16)
    kv_len = torch.tensor([30000], dtype=torch.int32, device="cuda")
    runs = [fd.flash_decode(q, kc, vc, kv_len) for _ in range(3)]
    torch.cuda.synchronize()
    assert fd.num_splits(2, 16, 8, 32768, torch.cuda.get_device_properties(
        0).multi_processor_count)[0] > 1
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.gpu
def test_decode_batch_graph_matches_the_eager_loop():
    """decode_batch replays one captured step; its tokens equal those of an
    eager ``prefill`` + ``decode_step`` loop, the graph's step logits are
    within 2e-2 x max|logit| of the eager ones, and the launch counts after
    the call equal the eager loop's."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.launch.steps import GraphedDecodeStep
    from repro_torch.models import build_model
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(7))
    S, new, B = 16, 8, 6
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")

    def loop(step):
        cache, logits = model.prefill(params, {"tokens": tokens},
                                      max_seq=S + new, step=step)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks, steps = [], []
        for i in range(new):
            toks.append(tok[:, 0])
            logits, cache = step(params, cache, tok, S + i)
            steps.append(logits.clone())
            tok = torch.argmax(logits, dim=-1)
        return torch.stack(toks, 1).cpu().numpy(), steps

    ops.reset_counts()
    eager_tokens, eager_logits = loop(model.decode_step)
    eager_counts = (ops.launch_counts(), ops.variant_counts())
    _graph_tokens, graph_logits = loop(GraphedDecodeStep(model))
    for a, b in zip(eager_logits, graph_logits):
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())
    ops.reset_counts()
    got = decode_batch(model, params, [Request(i, p, new)
                                       for i, p in enumerate(prompts)])
    np.testing.assert_array_equal(got, eager_tokens)
    assert (ops.launch_counts(), ops.variant_counts()) == eager_counts
    assert eager_counts[0]["flash_decode"] == (S + new) * cfg.n_layers
    stats = decode_batch.last_graph
    assert stats["replays"] == S + new - 1 and stats["capture_seconds"] > 0


@pytest.mark.gpu
def test_reduced_model_on_the_card_matches_the_cpu():
    """The reduced qwen3-1.7b in float32: forward logits on the card (through
    the kernels) against the CPU (plain versions), and greedy tokens."""
    _need_card()
    _reduced_on_the_card_against_the_cpu("qwen3-1.7b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_reduced_recurrent_models_on_the_card(arch):
    """The recurrent mixers (mLSTM and sLSTM; Mamba beside attention and
    MoE) in float32: forward logits on the card against the CPU, and
    greedy tokens (decode_batch's graph on the card)."""
    _need_card()
    _reduced_on_the_card_against_the_cpu(arch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_recurrent_decode_graph_matches_the_eager_loop(arch):
    """decode_batch of a reduced recurrent model (bf16) replays one
    captured step that writes every state in place; its tokens and launch
    counts equal an eager prefill + decode_step loop's."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(9))
    S, new, B = 16, 8, 24
    prompts = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    ops.reset_counts()
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  max_seq=S + new)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    eager = []
    for i in range(new):
        eager.append(tok[:, 0])
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    eager_tokens = torch.stack(eager, 1).cpu().numpy()
    eager_counts = (ops.launch_counts(), ops.variant_counts())
    ops.reset_counts()
    got = decode_batch(model, params, [Request(i, p, new)
                                       for i, p in enumerate(prompts)])
    np.testing.assert_array_equal(got, eager_tokens)
    assert (ops.launch_counts(), ops.variant_counts()) == eager_counts
    norms = sum(1 if f == "none" else 2 for _m, f in cfg.pattern)
    attn = sum(m == "attn" for m, _f in cfg.pattern)
    assert eager_counts[0] == {
        "rms_norm": (S + new) * (norms * cfg.repeats + 1),
        "flash_attention": 0,
        "flash_decode": (S + new) * attn * cfg.repeats}
    assert decode_batch.last_graph["replays"] == S + new - 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "command-r-35b"])
def test_reduced_moe_and_parallel_block_models_on_the_card(arch):
    """The MoE model (rebalance on, the config's capacity) and the parallel
    block in float32: forward logits and the MoE auxiliary loss on the card
    against the CPU, and greedy tokens."""
    _need_card()
    _reduced_on_the_card_against_the_cpu(arch)


def _reduced_on_the_card_against_the_cpu(arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    mc, mg = build_model(cfg, device="cpu"), build_model(cfg)
    pc = mc.init_params(torch.Generator(device="cpu").manual_seed(3))

    def to_card(t):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in t.items()}
    pg = to_card(pc)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    a, aux_a = mc.forward(pc, {"tokens": tok})
    b, aux_b = mg.forward(pg, {"tokens": tok.cuda()})
    tol = 1e-4 * float(a.abs().max())
    assert float((a - b.cpu()).abs().max()) < tol
    assert float(aux_a) == pytest.approx(float(aux_b), rel=1e-5, abs=1e-7)
    assert (float(aux_a) > 0) == bool(cfg.n_experts)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 16).astype(np.int32),
                    8) for i in range(6)]
    np.testing.assert_array_equal(
        decode_batch(mc, pc, reqs, device="cpu"),
        decode_batch(mg, pg, reqs))


def _greedy(model, params, batch, new, step):
    """``Model.prefill(step=)`` and ``new`` greedy steps through ``step``
    (as chip_smoke.py's ``lm_encdec`` serves): the tokens (B, new)."""
    S = batch["tokens"].shape[1]
    prefix = batch["vis_embeds"].shape[1] if "vis_embeds" in batch else 0
    cache, logits = model.prefill(params, batch, max_seq=prefix + S + new,
                                  step=step)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = []
    for i in range(new):
        out.append(tok[:, 0])
        logits, cache = step(params, cache, tok, prefix + S + i)
        tok = torch.argmax(logits, dim=-1)
    return torch.stack(out, 1).cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
def test_encdec_and_vision_prefix_models_on_the_card(arch):
    """Whisper's encoder, cross-attention and learned positions, InternVL's
    vision prefix, reduced, in float32: forward logits on the card against
    the CPU; greedy tokens of the prefill and decode steps replayed from
    ``GraphedDecodeStep``'s graphs (InternVL: one on embeddings for the
    prefix, one on tokens) equal to the eager loop's on the card and on the
    CPU, with the eager loop's launch counts."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import GraphedDecodeStep
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    mc, mg = build_model(cfg, device="cpu"), build_model(cfg)
    pc = mc.init_params(torch.Generator(device="cpu").manual_seed(3))

    def to_card(t):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in t.items()}
    pg = to_card(pc)
    rng = np.random.default_rng(0)
    B, S, new = 6, 16, 8
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                                    (B, S)))}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    if cfg.vision_prefix_len:
        batch["vis_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.vision_prefix_len, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    card = {k: v.cuda() for k, v in batch.items()}
    a, _ = mc.forward(pc, batch)
    b, _ = mg.forward(pg, card)
    assert float((a - b.cpu()).abs().max()) < 1e-4 * float(a.abs().max())
    ops.reset_counts()
    eager = _greedy(mg, pg, card, new, mg.decode_step)
    eager_counts = (ops.launch_counts(), ops.variant_counts())
    ops.reset_counts()
    graphed = GraphedDecodeStep(mg)
    np.testing.assert_array_equal(_greedy(mg, pg, card, new, graphed), eager)
    assert (ops.launch_counts(), ops.variant_counts()) == eager_counts
    steps = cfg.vision_prefix_len + S + new
    assert graphed.stats()["replays"] == steps - len(graphed.graphs)
    assert set(graphed.graphs) == ({"tokens", "embeds"}
                                   if cfg.vision_prefix_len else {"tokens"})
    np.testing.assert_array_equal(
        _greedy(mc, pc, batch, new, mc.decode_step), eager)


@pytest.mark.gpu
def test_moe_decode_graph_matches_the_eager_loop():
    """decode_batch of the reduced mixtral-8x7b (bf16, routing with the
    rebalance on inside the graph) replays one captured step; its tokens
    equal an eager prefill + decode_step loop's, and the launches too."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.models import build_model
    cfg = get_config("mixtral-8x7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(5))
    S, new, B = 16, 8, 24
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    ops.reset_counts()
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  max_seq=S + new)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    eager = []
    for i in range(new):
        eager.append(tok[:, 0])
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    eager_tokens = torch.stack(eager, 1).cpu().numpy()
    eager_counts = (ops.launch_counts(), ops.variant_counts())
    ops.reset_counts()
    got = decode_batch(model, params, [Request(i, p, new)
                                       for i, p in enumerate(prompts)])
    np.testing.assert_array_equal(got, eager_tokens)
    assert (ops.launch_counts(), ops.variant_counts()) == eager_counts
    L = cfg.n_layers
    assert eager_counts[0] == {"rms_norm": (S + new) * (2 * L + 1),
                               "flash_attention": 0,
                               "flash_decode": (S + new) * L}
    assert decode_batch.last_graph["replays"] == S + new - 1


#: kernel -> the float32 tolerance of its kernel tests
_GRAD_CASES = {
    "rms_norm": 1e-6,
    "flash_attention": 2e-5,
    "flash_decode": 2e-5,
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(_GRAD_CASES))
def test_gradients_through_each_kernel_wrapper(kernel):
    """Through the kernel on CUDA tensors (grad mode on, inputs that require
    a gradient: ``_lm.KernelWithPlainBackward``), every input's gradient
    exists and equals the plain version's on the same tensors (the loss
    weighs the output by a ramp, so the same gradient reaches both
    backwards); the forward launched the kernel once."""
    _need_card()
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32 = torch.float32
    if kernel == "rms_norm":
        ins = [_lm_randn(gen, (24, 512), f32, 3.0), _lm_randn(gen, (512,), f32)]
        run, plain = ops.rms_norm, rn.rms_norm_ref
    elif kernel == "flash_attention":
        ins = [_lm_randn(gen, (2, 40, 4, 32), f32),
               _lm_randn(gen, (2, 40, 2, 32), f32),
               _lm_randn(gen, (2, 40, 2, 32), f32)]
        run = functools.partial(ops.flash_attention, window=9)
        plain = functools.partial(fa.flash_attention_ref, window=9)
    else:
        kv = torch.tensor([29], dtype=torch.int32, device="cuda")
        ins = [_lm_randn(gen, (3, 1, 8, 64), f32),
               _lm_randn(gen, (3, 48, 2, 64), f32),
               _lm_randn(gen, (3, 48, 2, 64), f32)]
        run = lambda q, k, v: ops.flash_decode(q, k, v, kv)  # noqa: E731
        plain = lambda q, k, v: fd.decode_attention_ref(q, k, v, kv)  # noqa
    tol = _GRAD_CASES[kernel]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        weight = torch.linspace(-1, 1, out.numel(), device="cuda")
        (out * weight.reshape(out.shape)).sum().backward()
        return out, [t.grad for t in leaves]

    before = ops.launch_counts()[kernel]
    out, got = grads(run)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == before + 1
    assert out.grad_fn is not None
    want_out, want = grads(plain)
    _hold(out.detach(), want_out.detach(), tol)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        _hold(g, w, tol)
    with torch.no_grad():                   # no autograd: a direct launch
        assert run(*ins).grad_fn is None


@pytest.fixture
def _pinned_zip_clock(monkeypatch):
    """An npz is a zip, and a zip member carries its time of writing: pin
    the clock zipfile reads so that equal arrays give equal bytes."""
    import time
    import types
    import zipfile
    fixed = time.mktime((2020, 1, 1, 0, 0, 0, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: fixed, localtime=time.localtime))


def _capped_queries(svc, backend):
    """Two queries whose static caps differ (one overflows at 128 events):
    one relaxed dispatch of 6 rows, padded to 8 with W=1 rows."""
    kw = dict(W_list=[30_000], reps=3, backend=backend)
    return [svc.make_query(PT.one_cluster(8, 1), lam_list=[2],
                           max_events=128, **kw),
            svc.make_query(PT.one_cluster(8, 1), lam_list=[60],
                           max_events=1 << 15, **kw)]


@pytest.mark.gpu
def test_relaxed_mixed_caps_and_pow2_padding_on_the_card(tmp_path,
                                                         _pinned_zip_clock):
    """Per-row budgets under a relaxed static cap, with pad rows, launched on
    the card: the same answers and npz bytes as the plain loop on the card."""
    _need_card()
    from repro_torch.service import SimulationService
    before = ws_sim_cuda.launches
    out = {}
    for backend in ("cuda", "torch"):
        svc = SimulationService(root=tmp_path / backend)
        res = svc.query_many(_capped_queries(svc, backend))
        log = svc.broker.dispatch_log[0]
        assert svc.n_dispatches == 1 and log["backend"] == backend
        assert log["relaxed"] and (log["n_rows"], log["n_padded"]) == (6, 8)
        assert res[0].grid.overflow.any() and not res[1].grid.overflow.any()
        out[backend] = res
    assert ws_sim_cuda.launches == before + 1
    for a, b in zip(out["cuda"], out["torch"]):
        assert a.key == b.key
        for name in (f"{a.key}.npz", f"{a.key}.json"):
            assert (tmp_path / "cuda" / name).read_bytes() == \
                (tmp_path / "torch" / name).read_bytes()
        np.testing.assert_array_equal(a.cells.mean, b.cells.mean)


@pytest.mark.gpu
def test_a_faulted_cuda_dispatch_never_demotes(tmp_path):
    """On the card the chain is the cuda backend alone: a transient fault is
    retried there, and a fault on every call raises — nothing runs on the
    plain loop or on the host oracle."""
    _need_card()
    from repro_torch import obs
    from repro_torch.core import backend as pbk
    from repro_torch.service import SimulationService
    from repro_torch.service import resilience as rz
    others = {n: pbk.get_backend(n).n_run_rows for n in ("torch", "oracle")}
    cfg = rz.ResilienceConfig(retry=rz.RetryPolicy(max_attempts=2,
                                                   base_s=0.0, cap_s=0.0))
    svc = SimulationService(root=tmp_path, resilience=cfg,
                            metrics=obs.MetricsRegistry())
    q = _capped_queries(svc, None)[1]
    assert rz.fallback_chain("cuda", q.model) == ["cuda"]
    assert rz.fallback_chain("torch", q.model) == ["torch"]
    transient = rz.FaultPlan(sites={"backend.run_rows": rz.Prob(
        1.0, max_faults=1, match={"backend": "cuda"})})
    with rz.fault_plan(transient):
        r = svc.query_many([q])[0]
    assert svc.broker.dispatch_log[0]["degraded"]
    assert svc.broker.dispatch_log[0]["backend"] == "cuda"
    assert np.isfinite(r.cells.mean).all()
    always = rz.FaultPlan(sites={"backend.run_rows": rz.Prob(
        1.0, match={"backend": "cuda"})})
    q2 = svc.make_query(PT.one_cluster(8, 1), W_list=[20_000], lam_list=[5],
                        reps=4)
    with rz.fault_plan(always), pytest.raises(rz.InjectedFault):
        svc.query_many([q2])
    assert {n: pbk.get_backend(n).n_run_rows for n in others} == others


def _port_script(rel: str):
    """A module of the port that lives outside the package (the examples
    and the figure benches)."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(rel)
    finally:
        sys.path.remove(str(root))


@pytest.mark.gpu
def test_a_traced_launch_decodes_like_the_plain_loop():
    """The quickstart's traced run through the kernel, and a trace cut at
    ``max_trace``: the kernel's trace, ``n_trace`` and every export of the
    log engine equal the plain loop's on the card."""
    _need_card()
    from repro_torch.core import gantt
    qs = _port_script("examples.quickstart_torch")
    res, dec = qs.single_run()
    assert res.trace.is_cuda
    for max_trace in (8192, 64):
        cfg = pdv.EngineConfig(topology=PT.one_cluster(8, 10),
                               log_trace=True, max_trace=max_trace,
                               max_events=1 << 18)
        scn = pdv.batch_scenarios(5000, np.array([42], np.uint32), lam=10,
                                  device="cuda")
        got = _launch_and_hold(cfg, scn, "ws_sim_divisible",
                               f"max_trace={max_trace}")
        plain = ref.ws_sim_ref(cfg, scn)
        row = [type(r)(*(x[0] for x in r)) for r in (got, plain)]
        exports = []
        for r in row:
            ms = int(r.makespan)
            d = gantt.decode_trace(r.trace, r.n_trace, 8, 5000, ms)
            exports.append((d, gantt.ascii_gantt(d["runs"], ms),
                            gantt.to_paje(d["runs"], ms),
                            gantt.to_json(r, 8, 5000),
                            gantt.to_chrome_events(d, ms)))
        assert exports[0] == exports[1]
        if max_trace == 8192:
            assert exports[0][0] == dec
        else:
            assert int(row[0].n_trace) == 64


@pytest.mark.gpu
def test_segmented_torch_on_the_card_equals_cuda():
    """The backend matrix's 66-row grid: the torch backend, segmented on the
    card, gives the ``cuda`` kernel's grid, every column."""
    _need_card()
    from repro_torch.core import backend as bk
    from repro_torch.core import sweep as sw
    pt = _port_script("benchmarks.paper_torch")
    rows = sw.grid_rows([30_000], (2, 6, 20), 22)
    model = sw.resolve_model(PT.one_cluster(16, 1), "divisible",
                             W_list=[30_000], lam_list=(2, 6, 20),
                             pow2_max_events=True)
    tg = sw.run_rows(model, rows, backend="torch")
    st = bk.get_backend("torch").last_stats
    cg = sw.run_rows(model, rows, backend="cuda")
    assert bk.get_backend("cuda").last_stats is None
    assert len(rows) == 66 and pt.grids_equal(tg, cg)
    assert st.n_segments > 1 and st.n_compactions >= 1
    assert st.events_executed == int(cg.extras["n_events"].sum())


@pytest.mark.gpu
def test_a_figure_bench_on_the_card_equals_the_oracle():
    """Fig 10 on a small grid through the kernel: every row of every cell
    equals the numpy oracle's, and its rows equal the bench's on the plain
    loop."""
    _need_card()
    import dataclasses
    from repro_torch.configs import ws_paper
    from repro_torch.core import oracle as orc
    pt = _port_script("benchmarks.paper_torch")
    grid = ws_paper.PaperGrid(W_list=(10**4, 10**5), p_list=(32, 64),
                              lam_list=(2, 262), reps=4)
    cells = []
    rows = pt.fig10_overhead_ratio(4, grid,
                                   on_cell=lambda *c: cells.append(c))
    assert len(cells) == 8
    for cfg, scn, res in cells:
        for k in range(4):
            o = dataclasses.asdict(orc.simulate_oracle(
                cfg.topology, int(scn.W[k]), seed=int(scn.seed[k]),
                lam_local=int(scn.lam_local[k]),
                lam_remote=int(scn.lam_remote[k]),
                max_events=cfg.max_events))
            for f, v in o.items():
                np.testing.assert_array_equal(
                    np.asarray(v), getattr(res, f)[k].cpu().numpy(),
                    err_msg=f)
    assert rows == pt.fig10_overhead_ratio(4, grid, device="cpu")


_DAEMON_CLIENT = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.core import one_cluster
from repro_torch.service import DaemonClient
c = DaemonClient(root=sys.argv[2], fallback=False)
r = c.query(one_cluster(8, 1), W_list=[20000], lam_list=[3, 5], reps=8)
assert c.n_daemon_answers == 1 and c.n_fallbacks == 0 and c._local is None
print("KEY", r.key, flush=True)
"""


@pytest.mark.gpu
def test_a_daemon_on_the_card_answers_a_client_process(tmp_path,
                                                      _pinned_zip_clock):
    """A port daemon on the card (no ``device``: the card) answers a client
    process with one ``ws_sim`` launch, and its npz bytes equal library mode
    on the card computing the same query cold."""
    _need_card()
    import subprocess
    from repro_torch.core.topology import one_cluster
    from repro_torch.service import SimulationDaemon, SimulationService
    root = Path(__file__).resolve().parents[1]
    d = SimulationDaemon(root=tmp_path / "store",
                         coalesce_window_s=0.01).start()
    try:
        assert d.service.device.type == "cuda"
        before = dict(ws_sim_cuda.launches_by_body)
        out = subprocess.run([sys.executable, "-c", _DAEMON_CLIENT,
                              str(root / "src"), str(tmp_path / "store")],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        torch.cuda.synchronize()
        assert ws_sim_cuda.launches_by_body["ws_sim_divisible"] == \
            before["ws_sim_divisible"] + 1
        assert d.service.broker.n_dispatches == 1
        key = out.stdout.split("KEY ", 1)[1].strip()
    finally:
        d.stop()
    rl = SimulationService(root=tmp_path / "lib").query(
        one_cluster(8, 1), W_list=[20000], lam_list=[3, 5], reps=8)
    assert rl.key == key and not rl.from_cache
    assert (tmp_path / "lib" / f"{key}.npz").read_bytes() == \
        (tmp_path / "store" / f"{key}.npz").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 3, 4, 128])
def test_grid_chunk_on_the_card(chunk):
    """``ws_sim_cuda(grid_chunk=c)`` makes ceil(G / c) launches of each body
    and every leaf equals the unchunked launch's."""
    _need_card()
    topo = PT.one_cluster(8, 3)
    models = {
        "ws_sim_divisible": (pdv.EngineConfig(topology=topo,
                                              max_events=1 << 16), 3000),
        "ws_sim_dag": (pdg.DagEngineConfig(topology=topo,
                                           dag=pgen.merge_sort(300, 16),
                                           max_events=1 << 16), 0),
        "ws_sim_adaptive": (pad.AdaptiveEngineConfig(topology=topo,
                                                     max_events=1 << 16),
                            3000),
    }
    G = 10
    for body, (cfg, W) in models.items():
        scn = pdv.batch_scenarios(W, np.arange(G) + 5, lam=3, device="cuda")
        whole = ws_sim_cuda(cfg, scn)
        before = ws_sim_cuda.launches_by_body[body]
        got = ws_sim_cuda(cfg, scn, grid_chunk=chunk)
        torch.cuda.synchronize()
        assert ws_sim_cuda.launches_by_body[body] == before - (-G // chunk)
        for f in whole._fields:
            a, b = getattr(whole, f), getattr(got, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f"{body}: {f}"


@pytest.mark.gpu
def test_the_decode_step_copies_nothing_to_the_host():
    """The body the decode graph captures, on the card: no read of a device
    value on the host and no device-to-host copy; one event-loop step reads
    one (its loop condition) and copies nothing."""
    _need_card()
    from repro_torch.check import dispatch_lint as dl
    dev = torch.device("cuda", torch.cuda.current_device())
    ops = dl.decode_step_ops(dev)
    assert ops
    assert not [op.name for op in ops if op.name == dl.SYNC_OP or op.to_host]
    for name, model in dl.tiny_models():
        _, ops = dl.step_ops(model, 4, dev)
        assert sum(op.name == dl.SYNC_OP for op in ops) == 1, name
        assert not [op.name for op in ops if op.to_host], name
    assert dl.run(device=dev) == []


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _train_setup(device, compress=False, seed=0):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state_and_step
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    return cfg, opt, build_state_and_step(cfg, opt, compress, seed=seed,
                                          device=device)


def _to(tree, device):
    from repro_torch import tree as tr
    return tr.tree_map(lambda t: t.to(device), tree)


@pytest.mark.gpu
def test_a_reduced_train_step_on_the_card_vs_the_cpu():
    """Two steps of ``build_train_step`` (reduced qwen3, float32) on the
    card and on the CPU from the same weights and data: loss and gradient
    norm within 1e-4 (the kernels' float32 forward against the plain
    versions'), parameters within the AdamW sign hazard's 2 · k · lr; each
    step launched 4 L + 1 RMSNorms (norm1, q_norm, k_norm, norm2 a layer,
    the final norm) and L attentions, the backward none."""
    _need_card()
    from repro_torch import tree as tr
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg, opt, _ = _train_setup("cpu")
    cpu_m, gpu_m = build_model(cfg, "cpu"), build_model(cfg)
    params = cpu_m.init_params(torch.Generator().manual_seed(3))
    shape = ShapeSpec("t", 64, 4, "train")
    runs = {}
    for name, model in (("cpu", cpu_m), ("cuda", gpu_m)):
        p = _to(params, model.device)
        st = adamw.init(p)
        step = build_train_step(model, opt, device=model.device)
        mets = []
        for k in range(2):
            ops.reset_counts()
            p, st, met = step(p, st, batch_at(cfg, shape, k,
                                              device=model.device))
            if name == "cuda":
                torch.cuda.synchronize()
                assert ops.launch_counts() == {
                    "rms_norm": 4 * cfg.n_layers + 1,
                    "flash_attention": cfg.n_layers, "flash_decode": 0}
            mets.append({k_: float(v) for k_, v in met.items()})
        runs[name] = (_to(p, "cpu"), mets)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=key)
    for a, b in zip(tr.leaves(runs["cuda"][0]), tr.leaves(runs["cpu"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2 * 2 * opt.lr)


@pytest.mark.gpu
def test_bf16_logits_have_a_gradient_on_the_card():
    """``layers.logits_f32`` on bf16 CUDA operands under autograd (the
    product written straight to float32 has no derivative of its own): its
    logits against the float32 copies' product within 1e-5 of their
    largest (float32 sums in other orders), its gradients — the float32
    cotangent times the float32 operands, rounded to bf16 — within one bf16
    step of each element, plus 1e-5 of the largest for sums that cancel (a
    cotangent rounded to bf16 first breaks this bound by tens of
    elements)."""
    _need_card()
    from repro_torch.models.layers import logits_f32
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 16, 64), generator=gen, device="cuda").bfloat16()
    w = torch.randn((64, 1000), generator=gen, device="cuda").bfloat16()
    lab = torch.randint(0, 1000, (2, 16), generator=gen, device="cuda")

    def grads(fn):
        xs, ws = (t.clone().requires_grad_(True) for t in (x, w))
        out = fn(xs, ws)
        torch.nn.functional.cross_entropy(out.reshape(-1, 1000),
                                          lab.reshape(-1)).backward()
        return out.detach(), xs.grad, ws.grad

    got = grads(logits_f32)
    want = grads(lambda a, b: a.float() @ b.float())
    assert got[0].dtype == torch.float32
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * scale
    for g, w_ in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16
        scale = float(w_.float().abs().max())
        diff = (g.float() - w_.float()).abs()
        assert bool((diff <= 2 ** -7 * w_.float().abs() + 1e-5 * scale).all())


@pytest.mark.gpu
def test_a_checkpoint_of_a_card_state_restores_onto_the_card(tmp_path):
    _need_card()
    from repro_torch import tree as tr
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batch_at
    cfg, _opt, (_m, state, step_fn) = _train_setup(None, compress=True)
    state, _ = step_fn(state, batch_at(cfg, ShapeSpec("t", 32, 2, "train"),
                                       0))
    ckpt.save_checkpoint(tmp_path, 0, state)
    step, back, _ = ckpt.load_checkpoint(tmp_path, state)
    assert step == 0
    for a, b in zip(tr.leaves(back), tr.leaves(state)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_a_failure_before_the_first_checkpoint_on_the_card(tmp_path):
    """The restart trap on the card: a failure at step 2, before any
    checkpoint, restarts from the initial state, which no step wrote into;
    the run ends bit-equal to an uninterrupted one."""
    _need_card()
    from repro_torch import tree as tr
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batch_at
    from repro_torch.runtime.fault import (FailureInjector, TrainLoopConfig,
                                           run_training)
    finals = []
    for name, fails in (("a", (2,)), ("b", ())):
        cfg, _opt, (_m, state, step_fn) = _train_setup(None)
        before = [t.clone() for t in tr.leaves(state)]
        out = run_training(
            TrainLoopConfig(total_steps=5, ckpt_every=10,
                            ckpt_dir=str(tmp_path / name)),
            step_fn, state,
            lambda s: batch_at(cfg, ShapeSpec("t", 32, 2, "train"), s),
            injector=FailureInjector(fail_at=fails))
        assert out["restarts"] == len(fails)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tr.leaves(state)))
        finals.append(ckpt.load_checkpoint(tmp_path / name, state)[1])
    for a, b in zip(tr.leaves(finals[0]), tr.leaves(finals[1])):
        assert a.is_cuda and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the mesh: a world of one NCCL rank on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh():
    """A world of one NCCL rank in this process and a (1, 1) ("data",
    "model") mesh on the card; the process group is destroyed after."""
    _need_card()
    import torch.distributed as dist
    from repro_torch.launch import mesh as pmesh
    assert pmesh.init_world() == "nccl"
    try:
        yield pmesh.make_test_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cp_decode_in_a_graph_equals_the_plain_step(nccl_mesh):
    """The reduced qwen3's context-parallel step captured in a CUDA graph
    (the merge's NCCL all-reduces in it) against the step without context
    parallelism: logits within 2e-2 x max|logit|, the same greedy tokens,
    no flash_decode launch; and ``decode_batch`` with ``cp_axes`` equal to
    ``decode_batch``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, decode_batch
    from repro_torch.launch.steps import GraphedDecodeStep
    from repro_torch.models import build_model
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(7))
    S, new, B = 8, 6, 4
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    cp = (("model",), ("data",))

    def loop(step):
        cache, logits = model.prefill(params, {"tokens": tokens},
                                      max_seq=S + new, step=step)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks, steps = [], []
        for i in range(new):
            toks.append(tok[:, 0])
            logits, cache = step(params, cache, tok, S + i)
            steps.append(logits.clone())
            tok = torch.argmax(logits, dim=-1)
        return torch.stack(toks, 1).cpu().numpy(), steps

    plain_tokens, plain_logits = loop(GraphedDecodeStep(model))
    ops.reset_counts()
    graph = GraphedDecodeStep(model, cp_axes=cp, mesh=nccl_mesh)
    cp_tokens, cp_logits = loop(graph)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == 0
    assert graph.stats()["replays"] == S + new - 1
    np.testing.assert_array_equal(cp_tokens, plain_tokens)
    for a, b in zip(plain_logits, cp_logits):
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())
    reqs = [Request(i, p, new) for i, p in enumerate(prompts)]
    np.testing.assert_array_equal(
        decode_batch(model, params, reqs, cp_axes=cp, mesh=nccl_mesh),
        decode_batch(model, params, reqs))
    assert decode_batch.last_graph["replays"] == S + new - 1


@pytest.mark.gpu
def test_cp_decode_in_a_graph_equals_the_one_shard_step(nccl_mesh,
                                                        monkeypatch):
    """On a world of one rank the merge changes nothing, so the
    context-parallel step replayed from a graph gives, bit for bit, the
    logits of the step without a mesh whose attention is the partials'
    arithmetic on one shard (``decode_attention_partial``, normalized)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import GraphedDecodeStep
    from repro_torch.models import attention as pattn
    from repro_torch.models import build_model
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(7))
    S, new, B = 8, 6, 4
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (B, S + new)), dtype=torch.int64, device="cuda")

    def forced(step):
        cache, logits = model.prefill(params, {"tokens": tokens[:, :S]},
                                      max_seq=S + new, step=step)
        out = [logits]
        for i in range(S, S + new - 1):
            logits, cache = step(params, cache, tokens[:, i:i + 1], i)
            out.append(logits.clone())
        return torch.stack(out)

    cp = forced(GraphedDecodeStep(model, cp_axes=(("model",), ("data",)),
                                  mesh=nccl_mesh))

    def one_shard(q, k_cache, v_cache, kv_len, *, window=0):
        o, _m, l = pattn.decode_attention_partial(q, k_cache, v_cache, 0,
                                                  kv_len, window=window)
        return (o / torch.clamp(l, min=1e-30)[..., None])[:, None] \
            .to(q.dtype)

    monkeypatch.setattr(pattn, "decode_attention", one_shard)
    assert torch.equal(forced(GraphedDecodeStep(model)), cp)


@pytest.mark.gpu
def test_cp_decode_step_reads_nothing_on_the_host(nccl_mesh):
    """The context-parallel step, as the graph captures it, reads no device
    value on the host and copies nothing back (the dispatch lint's
    recorder)."""
    from repro_torch.check import dispatch_lint as dl
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1))
    cache = model.init_cache(2, 8)
    tok = torch.ones((2, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((1,), 3, dtype=torch.int32, device="cuda")
    model.decode_step(params, cache, tok, pos, cp_axes=(("model",), ()),
                      mesh=nccl_mesh)
    with dl.OpRecorder() as rec:
        model.decode_step(params, cache, tok, pos, cp_axes=(("model",), ()),
                          mesh=nccl_mesh)
    assert rec.ops
    assert not [op.name for op in rec.ops
                if op.name == dl.SYNC_OP or op.to_host]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_sharded_prefill_on_an_nccl_mesh_of_one_is_bit_equal(nccl_mesh,
                                                             dtype):
    """The reduced qwen3's prefill with its weights laid out by the
    placement rules on a (1, 1) NCCL mesh (every collective a real NCCL
    call over a group of one, sequence parallelism on) gives the unsharded
    step's logits bit for bit, through the kernels (one ``rms_norm`` a
    norm, one ``flash_attention`` a layer)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as ppart
    from repro_torch.launch import sharding as pshd
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(
        d_model=256, head_dim=128), param_dtype=dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(2))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 64)), dtype=torch.int64, device="cuda")
    want = build_prefill_step(model)(params, {"tokens": tokens})
    local = pshd.local_params(params, pshd.shard_params(
        model.param_shapes(), nccl_mesh), nccl_mesh)
    ops.reset_counts()
    ppart.reset_counts()
    got = build_prefill_step(model, mesh=nccl_mesh)(
        local, shard_batch({"tokens": tokens}, nccl_mesh))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    L = cfg.n_layers
    assert ops.launch_counts()["rms_norm"] == 4 * L + 1
    assert ops.launch_counts()["flash_attention"] == L
    assert ppart.counts()["collectives"] == dict(
        all_gather=9 * L + 2, reduce_scatter=2 * L + 1, all_reduce=0,
        broadcast=1, all_to_all=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_sharded_moe_prefill_on_an_nccl_mesh_of_one_is_bit_equal(nccl_mesh,
                                                                 dtype):
    """The reduced mixtral's prefill with its weights laid out by the
    placement rules on a (1, 1) NCCL mesh (its experts split on "data" and
    d_ff on "model" over groups of one: the all-to-alls real NCCL calls,
    sequence parallelism on, one dispatch group as ``plan_cell`` sets on a
    world of one) gives the unsharded step's logits bit for bit, through
    the kernels (one ``rms_norm`` a norm, one ``flash_attention`` a
    layer)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as ppart
    from repro_torch.launch import sharding as pshd
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        d_model=256, head_dim=128), param_dtype=dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(2))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 64)), dtype=torch.int64, device="cuda")
    want = build_prefill_step(model)(params, {"tokens": tokens})
    local = pshd.local_params(params, pshd.shard_params(
        model.param_shapes(), nccl_mesh), nccl_mesh)
    ops.reset_counts()
    ppart.reset_counts()
    got = build_prefill_step(model, mesh=nccl_mesh)(
        local, shard_batch({"tokens": tokens}, nccl_mesh))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    L = cfg.n_layers
    assert ops.launch_counts()["rms_norm"] == 2 * L + 1
    assert ops.launch_counts()["flash_attention"] == L
    assert ppart.counts()["collectives"] == dict(
        all_gather=9 * L + 2, reduce_scatter=2 * L + 1, all_reduce=L,
        broadcast=1, all_to_all=2 * L)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_sharded_train_step_on_an_nccl_mesh_of_one_is_bit_equal(nccl_mesh,
                                                                dtype):
    """The reduced qwen3's train step with its weights and AdamW moments
    laid out by the placement rules on a (1, 1) NCCL mesh (every collective
    and its transpose a real NCCL call over a group of one, sequence
    parallelism on) gives the unsharded step's metrics, weights and moments
    bit for bit over two steps, through the kernels (one ``rms_norm`` a
    norm and one ``flash_attention`` a layer a step, none in the
    backward), with the collectives of PERF.md's train formula."""
    import dataclasses
    from repro_torch import tree as ptr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as ppart
    from repro_torch.launch import sharding as pshd
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(
        d_model=256, head_dim=128), param_dtype=dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(5)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                   dtype=torch.int64, device="cuda")
                for k in ("tokens", "labels")} for _ in range(2)]
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    plain = build_train_step(model, opt)
    want_p, want_o = params, adamw.init(params)
    local = pshd.local_params(params, pshd.shard_params(
        model.param_shapes(), nccl_mesh), nccl_mesh)
    got_p, got_o = local, adamw.init(local)
    sharded = build_train_step(model, opt, mesh=nccl_mesh)
    L = cfg.n_layers
    for b in batches:
        want_p, want_o, want_m = plain(want_p, want_o, b)
        ops.reset_counts()
        ppart.reset_counts()
        got_p, got_o, got_m = sharded(got_p, got_o, shard_batch(b,
                                                                nccl_mesh))
        torch.cuda.synchronize()
        assert ops.launch_counts()["rms_norm"] == 4 * L + 1
        assert ops.launch_counts()["flash_attention"] == L
        gathers = 9 * L + 3
        assert ppart.counts()["collectives"] == dict(
            all_gather=gathers, reduce_scatter=2 * L + 1, all_reduce=4,
            broadcast=0, all_to_all=0)
        assert ppart.backward_counts() == dict(
            all_gather=2 * L + 1, reduce_scatter=gathers, all_reduce=2,
            all_to_all=0, leaf_sum=5, norm_sum=1)
        for k, v in want_m.items():
            assert torch.equal(got_m[k], v), k
        for (path, a), (_p, w) in zip(
                ptr.flatten_with_path({"p": got_p, "o": got_o}),
                ptr.flatten_with_path({"p": want_p, "o": want_o})):
            assert torch.equal(a, w), path


#: (the sharded prefill's collectives, the train step's forward and
#: backward ones) on a (1, 1) mesh without SP, by PERF.md's formula for the
#: recurrent mixers (tests/test_torch_sharded_recurrent.py::
#: recurrent_formula): jamba's first five slots (Mamba with a dense and a
#: MoE FFN twice, attention with a dense FFN) and xlstm's two (mLSTM,
#: sLSTM)
RECURRENT_COLLECTIVES = {
    "jamba-v0.1-52b": (
        dict(all_gather=33, reduce_scatter=2, all_reduce=19, broadcast=0,
             all_to_all=4),
        dict(all_gather=33, reduce_scatter=2, all_reduce=23, broadcast=0,
             all_to_all=4),
        dict(all_gather=2, reduce_scatter=33, all_reduce=21, all_to_all=4,
             leaf_sum=37, norm_sum=1)),
    "xlstm-350m": (
        dict(all_gather=12, reduce_scatter=0, all_reduce=2, broadcast=0,
             all_to_all=0),
        dict(all_gather=12, reduce_scatter=0, all_reduce=6, broadcast=0,
             all_to_all=0),
        dict(all_gather=0, reduce_scatter=12, all_reduce=4, all_to_all=0,
             leaf_sum=7, norm_sum=1))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("arch", sorted(RECURRENT_COLLECTIVES))
def test_sharded_recurrent_on_an_nccl_mesh_of_one_is_bit_equal(nccl_mesh,
                                                               arch, dtype):
    """A reduced jamba (its first five slots) and xlstm (one mLSTM, one
    sLSTM) with their weights and AdamW moments laid out by the placement
    rules on a (1, 1) NCCL mesh, the layout ``plan_cell`` gives a stack
    that is not attention-only (SP off): the prefill's logits and two train
    steps' metrics, weights and moments are the unsharded steps' bit for
    bit, through the kernels (one ``rms_norm`` a norm and one
    ``flash_attention`` an attention layer a step), with the collectives
    of PERF.md's formula."""
    import dataclasses
    from repro_torch import tree as ptr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as ppart
    from repro_torch.launch import sharding as pshd
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_train_step,
                                          make_act_constrainer)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(
        d_model=256, head_dim=128, repeats=1, pattern=full.pattern[:5]),
        param_dtype=dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(5)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                   dtype=torch.int64, device="cuda")
                for k in ("tokens", "labels")} for _ in range(2)]
    act = make_act_constrainer(nccl_mesh, ("data",), sequence_parallel=False)
    prefill, fwd, bwd = RECURRENT_COLLECTIVES[arch]
    rms = cfg.n_layers + sum(f != "none" for _m, f in cfg.pattern) + 1
    attn = sum(m == "attn" for m, _f in cfg.pattern)
    local = pshd.local_params(params, pshd.shard_params(
        model.param_shapes(), nccl_mesh), nccl_mesh)
    want = build_prefill_step(model)(params, {"tokens": batches[0]["tokens"]})
    ops.reset_counts()
    ppart.reset_counts()
    got = build_prefill_step(model, act_spec=act)(
        local, shard_batch({"tokens": batches[0]["tokens"]}, nccl_mesh))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.launch_counts()["rms_norm"] == rms
    assert ops.launch_counts()["flash_attention"] == attn
    assert ppart.counts()["collectives"] == prefill
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    plain, sharded = build_train_step(model, opt), \
        build_train_step(model, opt, act_spec=act)
    want_p, want_o = params, adamw.init(params)
    got_p, got_o = local, adamw.init(local)
    for b in batches:
        want_p, want_o, want_m = plain(want_p, want_o, b)
        ops.reset_counts()
        ppart.reset_counts()
        got_p, got_o, got_m = sharded(got_p, got_o, shard_batch(b,
                                                                nccl_mesh))
        torch.cuda.synchronize()
        assert ops.launch_counts()["rms_norm"] == rms
        assert ops.launch_counts()["flash_attention"] == attn
        assert ppart.counts()["collectives"] == fwd
        assert ppart.backward_counts() == bwd
        for k, v in want_m.items():
            assert torch.equal(got_m[k], v), k
        for (path, a), (_p, w) in zip(
                ptr.flatten_with_path({"p": got_p, "o": got_o}),
                ptr.flatten_with_path({"p": want_p, "o": want_o})):
            assert torch.equal(a, w), path


@pytest.mark.gpu
def test_run_rows_on_an_nccl_mesh_equals_run_rows(nccl_mesh):
    """Each body's sweep through ``run_rows(mesh=)`` on the card: one launch,
    every field equal to ``run_rows()``'s."""
    from repro_torch.core import sweep as psw
    topo = PT.one_cluster(8, 2)
    for body, kw in (("ws_sim_divisible", dict(W_list=[4000])),
                     ("ws_sim_dag", dict(task_model="dag",
                                         dag=pgen.merge_sort(300, 32))),
                     ("ws_sim_adaptive", dict(task_model="adaptive",
                                              W_list=[4000]))):
        model = psw.resolve_model(topo, lam_list=[2, 5],
                                  **{k: v for k, v in kw.items()})
        rows = psw.grid_rows(kw.get("W_list", (0,)), [2, 5], 7)
        before = ws_sim_cuda.launches_by_body[body]
        got = psw.run_rows(model, rows, mesh=nccl_mesh,
                           shard_axes=("data", "model"))
        assert ws_sim_cuda.launches_by_body[body] == before + 1
        want = psw.run_rows(model, rows)
        for f in ("makespan", "n_requests", "n_success", "n_fail",
                  "total_idle", "startup_end", "overflow"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for k in want.extras:
            np.testing.assert_array_equal(got.extras[k], want.extras[k])
