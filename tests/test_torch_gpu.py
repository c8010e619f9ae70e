"""The CUDA kernels on the card: every body of ``ws_sim.cu`` against its plain
version on the same CUDA tensors, every leaf ``torch.equal``; the three
language-model kernels (``rmsnorm.cu``, ``flash_attention.cu``,
``decode_attention.cu``) against their plain versions within the JAX
package's kernel tolerances, flash decode also with a device kv_len replayed
in a CUDA graph and on its split path; the reduced model on the card against
the CPU, and ``decode_batch``'s graph against the eager loop; the simulation
daemon on the card answering a client process.

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
