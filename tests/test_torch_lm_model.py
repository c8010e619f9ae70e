"""The port's language-model serving path against the JAX package, on the CPU,
at ``get_config("qwen3-1.7b").reduced()`` (2 layers, d_model 64, 4 query and
2 KV heads of 16, vocab 512), and at ``reduced()`` of every other registered
architecture (``NEW_ARCHS``: two more dense ones, command-r's parallel block,
two MoE ones with 4 experts of 64, top-2, and the recurrent ones: xLSTM's
alternating mLSTM and sLSTM, and Jamba's Mamba layers beside attention and
MoE).

The JAX package's parameters, made from ``PRNGKey(0)``, are carried into the
port by ``models.interop.params_from_jax``, so both run the same weights;
inputs are made with numpy from a seed. Module by module (layers, MLP,
attention, blocks) and for the slice as a whole (``forward``,
``build_prefill_step``, ``prefill``, ``decode_batch``). Tolerances, each with
its reason:

* float32 parameters: logits within ``1e-4 * max|logit|`` — the two
  frameworks sum in other orders (float32 rounding, ~1e-6 here);
* a float32 KV cache within atol = rtol = 1e-5 (the same rounding);
* a bf16 KV cache within one bf16 ulp (rtol 2^-7): float32 values that
  differ in their last bits may round to neighbouring bf16 values;
* the greedy decode with the bf16 cache of ``decode_batch``: those one-ulp
  differences move the step logits by up to ``1e-3 * max|logit|``; every
  row of every step must stay within half its own top-2 logit gap, so that
  a different token would be a fault, not a tie;
* bf16 parameters: ``2e-2 * max|logit|``, the bf16 tolerance of the kernel
  tests (bf16 rounds at other places in the two frameworks);
* the MoE auxiliary loss: rtol 1e-5 in float32 (float32 means over the
  tokens in other orders), rtol 2e-2 in bf16;
* ``loss_fn``: rtol 1e-5 (a float32 log-sum-exp over 512 logits);
  gradients of ``loss_fn``: each leaf within ``1e-4 * max|grad|`` of that
  leaf's JAX gradient (float32 rounding through two layers and back).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_is_runnable as j_runnable
from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.launch.steps import build_prefill_step as j_prefill_step
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.configs import SHAPES as PSHAPES
from repro_torch.configs import cell_is_runnable as p_runnable
from repro_torch.configs import get_config as pget
from repro_torch.launch import serve as pserve
from repro_torch.launch.steps import (GraphedDecodeStep, build_decode_step,
                                     build_prefill_step)
from repro_torch.models import attention as pattn
from repro_torch.models import blocks as pblk
from repro_torch.models import build_model as pbuild
from repro_torch.models import layers as players
from repro_torch.models import mlp as pmlp
from repro_torch.models.interop import params_from_jax

torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
#: the architectures this slice registers
NEW_ARCHS = ("deepseek-67b", "phi3-mini-3.8b", "command-r-35b",
             "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "xlstm-350m",
             "jamba-v0.1-52b")
B, S = 2, 32
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 24, 16, 8


def _configs(param_dtype):
    jc = dataclasses.replace(jget(ARCH).reduced(), param_dtype=param_dtype)
    pc = dataclasses.replace(pget(ARCH).reduced(), param_dtype=param_dtype)
    return jc, pc


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def built(request):
    jc, pc = _configs(request.param)
    jm, pm = jbuild(jc), pbuild(pc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pm)
    return request.param, jc, jm, jp, pm, pp


@pytest.fixture(scope="module")
def f32():
    jc, pc = _configs("float32")
    jm, pm = jbuild(jc), pbuild(pc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pm)
    return jc, jm, jp, pm, pp


def _tokens(cfg, shape, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    return t.astype(np.int32)


def _t(a, dtype=None):
    """numpy -> torch (bf16 leaves by their bits, like params_from_jax)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _logit_tol(param_dtype, ref) -> float:
    scale = float(np.abs(_np(ref)).max())
    return (1e-4 if param_dtype == "float32" else 2e-2) * scale


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_config_is_a_copy_of_the_jax_packages():
    for j, p in ((jget(ARCH), pget(ARCH)),
                 (jget(ARCH).reduced(), pget(ARCH).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert (j.hd, j.padded_vocab, j.n_layers) == \
            (p.hd, p.padded_vocab, p.n_layers)
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        pget("no-such-arch")


def test_param_tree_and_count_match_the_jax_package(built):
    _dt, jc, jm, jp, pm, pp = built
    jshapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    pshapes = jax.tree.map(lambda s: (s[0], str(s[1]).split(".")[-1]),
                           pm.param_shapes(), is_leaf=lambda x:
                           isinstance(x, tuple))
    assert jshapes == pshapes
    assert pm.param_count() == jm.param_count()
    full = pbuild(pget(ARCH), device="cpu")
    assert full.param_count() == jbuild(jget(ARCH)).param_count() \
        == 2_031_739_904


def test_params_from_jax_refuses_a_tree_that_does_not_fit(f32):
    _jc, _jm, jp, pm, _pp = f32
    tree = jax.tree.map(np.asarray, jp)
    missing = dict(tree, layers={"slot0": {
        k: v for k, v in tree["layers"]["slot0"].items() if k != "norm2"}})
    with pytest.raises(ValueError, match="missing.*norm2"):
        params_from_jax(missing, pm)
    with pytest.raises(ValueError, match="not expected.*extra"):
        params_from_jax(dict(tree, extra=np.zeros(3, np.float32)), pm)
    with pytest.raises(ValueError, match="tok_embed"):
        params_from_jax(dict(tree, tok_embed=tree["tok_embed"][:-1]), pm)
    with pytest.raises(TypeError):
        params_from_jax(dict(tree, final_norm=tree["final_norm"]
                             .astype(np.float64)), pm)


def test_params_from_jax_carries_bf16_bits_exactly():
    jc, pc = _configs("bfloat16")
    jp = jbuild(jc).init_params(jax.random.PRNGKey(1))
    pp = params_from_jax(jax.tree.map(np.asarray, jp),
                         pbuild(pc, device="cpu"))
    a = np.asarray(jp["layers"]["slot0"]["attn"]["wq"]).view(np.int16)
    b = pp["layers"]["slot0"]["attn"]["wq"].view(torch.int16).numpy()
    assert pp["layers"]["slot0"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_vs_jax(dtype):
    """RoPE, dense, RMSNorm: a few float32 ulps apart in float32 (atol = rtol
    = 1e-5); at most one bf16 ulp apart in bf16 (rtol 2^-7), since both
    compute in float32 and round once."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=1e-6, rtol=2.0 ** -7)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 8, 4, 16)), jnp.float32).astype(jdt)
    pos = jnp.asarray(np.broadcast_to(np.arange(8) * 37, (2, 8)), jnp.int32)
    np.testing.assert_allclose(
        _np(players.apply_rope(_t(x), _t(pos), 1e6)),
        _np(jlayers.apply_rope(x, pos, 1e6)), **tol)
    w = jnp.asarray(rng.standard_normal((16, 24)) / 4, jnp.float32).astype(jdt)
    np.testing.assert_allclose(_np(players.dense(_t(x), _t(w))),
                               _np(jlayers.dense(x, w)), **tol)
    s = jnp.asarray(rng.standard_normal(16), jnp.float32).astype(jdt)
    np.testing.assert_allclose(_np(players.rms_norm(_t(x), _t(s))),
                               _np(jlayers.rms_norm(x, s)), **tol)
    table = jnp.asarray(rng.standard_normal((50, 16)), jnp.float32).astype(jdt)
    ids = rng.integers(0, 50, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(_np(players.embed(_t(ids, torch.int64),
                                                    _t(table))),
                                  _np(jlayers.embed(jnp.asarray(ids), table)))
    np.testing.assert_allclose(_np(players.rope_frequencies(16, 1e6)),
                               _np(jlayers.rope_frequencies(16, 1e6)),
                               rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_vs_jax(act):
    p = jmlp.mlp_init(jax.random.PRNGKey(2), 32, 64, jnp.float32, act)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 5, 32)),
                    jnp.float32)
    got = pmlp.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = jmlp.mlp_apply(p, x, act)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_attention_vs_jax():
    """chunked_attention (through ops.flash_attention) against the JAX
    package's chunked_attention and ref_attention; decode_attention (through
    ops.flash_decode) against its decode_attention, float32 q beside a bf16
    cache."""
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((2, 40, 4, 16)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((2, 40, 2, 16)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((2, 40, 2, 16)), jnp.float32)
    for win in (0, 9):
        got = _np(pattn.chunked_attention(_t(q), _t(k), _t(v), window=win))
        np.testing.assert_allclose(got, _np(jattn.chunked_attention(
            q, k, v, window=win, block_kv=16)), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, _np(jattn.ref_attention(
            q, k, v, window=win)), atol=2e-5, rtol=2e-5)
    kc, vc = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    q1 = q[:, :1]
    for kv_len in (1, 23, 40):
        np.testing.assert_allclose(
            _np(pattn.decode_attention(_t(q1), _t(kc), _t(vc), kv_len)),
            _np(jattn.decode_attention(q1, kc, vc, kv_len)), atol=2e-5,
            rtol=2e-5)


def test_blocks_vs_jax(f32):
    """One layer: slot_apply over a sequence and slot_decode of one token
    into a cache, against the JAX package's."""
    jc, _jm, jp, _pm, pp = f32
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"]["slot0"])
    player = jax.tree.map(lambda a: a[1], pp["layers"]["slot0"])
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, 12, jc.d_model)), jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(12), (B, 12)), jnp.int32)
    want, _aux = jblk.slot_apply(jlayer, jc, "attn", "dense", x, pos)
    got, aux = pblk.slot_apply(player, jc, "attn", "dense", _t(x), _t(pos))
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    jcache = jblk.slot_cache_init(jc, "attn", B, 16, jnp.float32)
    pcache = pblk.slot_cache_init(jc, "attn", B, 16, torch.float32)
    for i in range(3):
        xi = x[:, i:i + 1]
        want, jcache, _ = jblk.slot_decode(jlayer, jc, "attn", "dense", xi,
                                           jcache, i)
        got, pcache, _aux = pblk.slot_decode(player, jc, "attn", "dense",
                                             _t(xi), pcache, i)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(pcache[key]), _np(jcache[key]),
                                       atol=1e-5, rtol=1e-5)
    # context-parallel decode runs on a live mesh only
    with pytest.raises(ValueError, match="live mesh"):
        pblk.slot_decode(player, jc, "attn", "dense", _t(x[:, :1]), pcache,
                         3, cp_axes=(("model",), ()))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_forward_vs_jax(built):
    dt, jc, jm, jp, pm, pp = built
    tok = _tokens(jc, (B, S))
    want, want_aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})
    got, aux = pm.forward(pp, {"tokens": _t(tok, torch.int64)})
    assert got.dtype == torch.float32 and got.shape == (B, S, jc.padded_vocab)
    assert aux.dtype == torch.float32 and aux.shape == () \
        and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol(dt, want))


def test_prefill_step_vs_jax(built):
    dt, jc, jm, jp, pm, pp = built
    tok = _tokens(jc, (B, S), seed=1)
    want = jax.jit(j_prefill_step(jm))(jp, {"tokens": jnp.asarray(tok)})
    got = build_prefill_step(pm, device="cpu")(
        pp, {"tokens": _t(tok, torch.int64)})
    assert got.shape == (B, 1, jc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol(dt, want))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_vs_jax(f32, cache_dtype):
    jc, jm, jp, pm, pp = f32
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    tok = _tokens(jc, (B, S), seed=2)
    jcache, jlog = jm.prefill(jp, {"tokens": jnp.asarray(tok)},
                              max_seq=S + 4, dtype=jdt)
    pcache, plog = pm.prefill(pp, {"tokens": _t(tok, torch.int64)},
                              max_seq=S + 4, dtype=tdt)
    np.testing.assert_allclose(_np(plog), _np(jlog), rtol=0,
                               atol=_logit_tol("float32", jlog))
    for key in ("k", "v"):
        got = pcache["layers"]["slot0"][key]
        want = jcache["layers"]["slot0"][key]
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        if cache_dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), _np(want), atol=0,
                                       rtol=2.0 ** -7)
    # the decode path agrees with forward (tests/test_models_smoke.py)
    if cache_dtype == "float32":
        fwd = pm.forward(pp, {"tokens": _t(tok, torch.int64)})[0][:, -1]
        diff = float((fwd - plog[:, 0]).abs().max())
        assert diff < 1e-3 * float(fwd.abs().max()) + 1e-3


def test_decode_step_with_a_device_position_vs_jax(built):
    """``pos`` as an int32 tensor (the JAX package's traced ``jnp.int32``):
    the same bits as the int position, logits and caches, step by step; and
    the JAX package's jitted ``decode_step`` given ``jnp.int32(pos)``."""
    dt, jc, jm, jp, pm, pp = built
    tok = _tokens(jc, (B, 5), seed=7)
    jcache = jm.init_cache(B, 8)
    ca, cb = pm.init_cache(B, 8), pm.init_cache(B, 8)
    jstep = jax.jit(jm.decode_step)
    for i in range(5):
        t = _t(tok[:, i:i + 1], torch.int64)
        la, _ = pm.decode_step(pp, ca, t, i)
        lb, _ = pm.decode_step(pp, cb, t, torch.tensor(i, dtype=torch.int32))
        assert torch.equal(la, lb)
        for key in ("k", "v"):
            assert torch.equal(ca["layers"]["slot0"][key],
                               cb["layers"]["slot0"][key])
        want, jcache = jstep(jp, jcache, jnp.asarray(tok[:, i:i + 1]),
                             jnp.int32(i))
        np.testing.assert_allclose(_np(lb), _np(want), rtol=0,
                                   atol=_logit_tol(dt, want))


def test_decode_step_refuses_a_position_it_cannot_take(f32):
    _jc, _jm, _jp, pm, pp = f32
    cache = pm.init_cache(B, 4)
    tok = torch.zeros((B, 1), dtype=torch.int64)
    for bad in (torch.tensor(1), torch.tensor([1, 2], dtype=torch.int32),
                torch.ones(1, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="int32 tensor of one element"):
            pm.decode_step(pp, cache, tok, bad)


def test_prefill_runs_the_step_it_is_given(f32):
    """``Model.prefill(step=...)`` runs every step through the callable
    (``decode_batch`` gives it a CUDA-graph runner): here one that passes
    the position on the device; the same bits as the default step."""
    jc, _jm, _jp, pm, pp = f32
    tok = _t(_tokens(jc, (B, 6), seed=8), torch.int64)
    seen = []

    def step(params, cache, tokens, pos):
        seen.append(pos)
        return pm.decode_step(params, cache, tokens,
                              torch.tensor(pos, dtype=torch.int32))
    ca, la = pm.prefill(pp, {"tokens": tok}, max_seq=8)
    cb, lb = pm.prefill(pp, {"tokens": tok}, max_seq=8, step=step)
    assert seen == list(range(6))
    assert torch.equal(la, lb)
    for key in ("k", "v"):
        assert torch.equal(ca["layers"]["slot0"][key],
                           cb["layers"]["slot0"][key])


def test_graphed_decode_step_needs_the_card(f32):
    """The CUDA-graph runner refuses a model on the CPU (decode_batch runs
    the CPU's steps eagerly and records no graph)."""
    _jc, _jm, _jp, pm, _pp = f32
    with pytest.raises(ValueError, match="on the card"):
        GraphedDecodeStep(pm)


def _replay(jm, jp, pm, pp, prompts, tokens):
    """The greedy decode of ``decode_batch`` step by step in both packages,
    fed the same tokens: yields (jax logits, port logits) per step, (B, V)."""
    n_new = tokens.shape[1]
    jcache, jlog = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                              max_seq=prompts.shape[1] + n_new)
    pcache, plog = pm.prefill(pp, {"tokens": _t(prompts, torch.int64)},
                              max_seq=prompts.shape[1] + n_new)
    jstep = jax.jit(jm.decode_step)
    pstep = build_decode_step(pm, device="cpu")
    for i in range(n_new):
        yield np.asarray(jlog)[:, -1], _np(plog)[:, -1]
        pos = prompts.shape[1] + i
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, i:i + 1]), pos)
        plog, pcache = pstep(pp, pcache, _t(tokens[:, i:i + 1], torch.int64),
                             pos)


def test_decode_batch_tokens_equal_the_jax_packages(f32):
    """serve.decode_batch at serve.py's defaults (24 requests, prompt 16, 8
    new tokens, float32 weights, the default bf16 cache): the same tokens;
    every row of every step within half its own top-2 gap."""
    jc, jm, jp, pm, pp = f32
    rng = np.random.default_rng(6)
    prompts = rng.integers(1, jc.vocab_size,
                           (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    want = jserve.decode_batch(
        jm, jp, [jserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], jc.padded_vocab)
    got = pserve.decode_batch(
        pm, pp, [pserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], device="cpu")
    assert got.dtype == np.int32 and got.shape == (SERVE_REQUESTS, SERVE_NEW)
    np.testing.assert_array_equal(got, want)
    for step, (jl, pl) in enumerate(_replay(jm, jp, pm, pp, prompts, got)):
        err = np.abs(jl - pl).max(axis=-1)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert (err <= 1e-3 * np.abs(jl).max()).all(), step
        assert (err < gap / 2).all(), (step, err, gap)
        np.testing.assert_array_equal(pl.argmax(-1), got[:, step])


# ---------------------------------------------------------------------------
# the architectures of the MoE slice: dense, parallel block, MoE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _arch(name, param_dtype, **over):
    """(jax cfg, jax model, jax params, port model, port params) of
    ``name``'s reduced config; the JAX weights carried into the port."""
    jc = dataclasses.replace(jget(name).reduced(), param_dtype=param_dtype,
                             **over)
    pc = dataclasses.replace(pget(name).reduced(), param_dtype=param_dtype,
                             **over)
    jm, pm = jbuild(jc), pbuild(pc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(sum(map(ord, name))))
    return jc, jm, jp, pm, params_from_jax(jax.tree.map(np.asarray, jp), pm)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_is_a_copy_of_the_jax_packages(name):
    for j, p in ((jget(name), pget(name)),
                 (jget(name).reduced(), pget(name).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert (j.hd, j.padded_vocab, j.n_layers, j.expert_d_ff,
                j.sub_quadratic) == (p.hd, p.padded_vocab, p.n_layers,
                                     p.expert_d_ff, p.sub_quadratic)
    # the long-context flag of every shape (mixtral's window qualifies it,
    # as the recurrent state of xLSTM and Jamba does: the JAX package's
    # test_long_context_skip_flags)
    for shape in JSHAPES:
        assert p_runnable(pget(name), PSHAPES[shape]) == \
            j_runnable(jget(name), JSHAPES[shape]), shape
    assert p_runnable(pget(name), PSHAPES["long_500k"])[0] == \
        (name in ("mixtral-8x7b", "xlstm-350m", "jamba-v0.1-52b"))


#: parameter counts of the full configs (JAX ``param_count``)
FULL_COUNTS = {"deepseek-67b": 67_425_001_472,
               "phi3-mini-3.8b": 3_821_472_768,
               "command-r-35b": 30_283_538_432,
               "mixtral-8x7b": 46_702_792_704,
               "phi3.5-moe-42b-a6.6b": 41_873_051_648,
               "xlstm-350m": 353_993_728,
               "jamba-v0.1-52b": 51_477_887_488}


def _jax_shapes(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


def _port_shapes(model):
    return jax.tree.map(lambda s: (s[0], str(s[1]).split(".")[-1]),
                        model.param_shapes(),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_param_tree_and_count_match_the_jax_package(name):
    _jc, jm, jp, pm, _pp = _arch(name, "bfloat16")
    assert _port_shapes(pm) == _jax_shapes(jp)
    assert pm.param_count() == jm.param_count()
    full_j, full_p = jbuild(jget(name)), pbuild(pget(name), device="cpu")
    assert _port_shapes(full_p) == _jax_shapes(full_j.abstract_params())
    assert full_p.param_count() == full_j.param_count() == FULL_COUNTS[name]


def test_params_from_jax_carries_the_router_and_experts_unchanged():
    """The float32 router and the (R, E, d, f) bf16 experts of a MoE slot
    cross bit for bit."""
    _jc, _jm, jp, _pm, pp = _arch("mixtral-8x7b", "bfloat16")
    jf, pf = jp["layers"]["slot0"]["ffn"], pp["layers"]["slot0"]["ffn"]
    assert pf["router"].dtype == torch.float32
    np.testing.assert_array_equal(pf["router"].numpy(),
                                  np.asarray(jf["router"]))
    for key in ("w_gate", "w_up", "w_down"):
        assert pf[key].dtype == torch.bfloat16
        assert tuple(pf[key].shape) == jf[key].shape and len(jf[key].shape) == 4
        np.testing.assert_array_equal(pf[key].view(torch.int16).numpy(),
                                      np.asarray(jf[key]).view(np.int16))


#: archs whose bf16 forward is held against the JAX package's forward run op
#: by op (``jax.disable_jit``), as the port runs: under ``jit`` XLA keeps
#: some bf16 intermediates in float32, and at jamba-v0.1-52b's 16 reduced
#: layers the jitted and the op-by-op forward of the same code differ by
#: about 1.0 in the logits (one layer routes a token to another expert),
#: while the port is within 0.07 of the op-by-op forward
BF16_OP_BY_OP = ("jamba-v0.1-52b",)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_forward_vs_jax(name, dtype):
    """The reference is the JAX package's jitted forward, but for the archs
    of ``BF16_OP_BY_OP`` in bf16."""
    jc, jm, jp, pm, pp = _arch(name, dtype)
    tok = _tokens(jc, (B, S), seed=11)
    if dtype == "bfloat16" and name in BF16_OP_BY_OP:
        with jax.disable_jit():
            want, want_aux = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    else:
        want, want_aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})
    got, aux = pm.forward(pp, {"tokens": _t(tok, torch.int64)})
    assert got.dtype == torch.float32 and got.shape == (B, S, jc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol(dtype, want))
    assert aux.dtype == torch.float32 and aux.shape == ()
    if jc.n_experts:
        assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_decode_matches_forward(name):
    """tests/test_models_smoke.py's parity in the port: float32, and for
    MoE a capacity no token overflows with the rebalance off (batched and
    per-token routing then keep the same assignments)."""
    over = dict(capacity_factor=64.0, ws_rebalance=False) \
        if pget(name).n_experts else {}
    jc, _jm, _jp, pm, pp = _arch(name, "float32", **over)
    tok = _t(_tokens(jc, (B, S), seed=12), torch.int64)
    fwd = pm.forward(pp, {"tokens": tok})[0][:, -1]
    _cache, dec = pm.prefill(pp, {"tokens": tok}, max_seq=S,
                             dtype=torch.float32)
    diff = float((fwd - dec[:, 0]).abs().max())
    assert diff < 1e-3 * float(fwd.abs().max()) + 1e-3, diff


def _labels(cfg, seed):
    return _tokens(cfg, (B, S), seed=seed)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_loss_fn_vs_jax(name):
    jc, jm, jp, pm, pp = _arch(name, "float32")
    tok, lab = _tokens(jc, (B, S), seed=13), _labels(jc, 14)
    want, wm = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(tok),
                                        "labels": jnp.asarray(lab)})
    got, gm = pm.loss_fn(pp, {"tokens": _t(tok, torch.int64),
                              "labels": _t(lab, torch.int64)})
    assert set(gm) == set(wm) == {"loss", "xent", "moe_aux"}
    for key in gm:
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(got) == float(gm["loss"])
    if jc.n_experts:
        assert float(gm["moe_aux"]) > 0


def test_phi3_at_head_dim_96_vs_jax():
    """phi3-mini-3.8b's full-width head dim at reduced width
    (``reduced(head_dim=96)``, float32): forward through the attention
    wrapper and five decode steps through flash decode, against the JAX
    package's."""
    jc, jm, jp, pm, pp = _arch("phi3-mini-3.8b", "float32", head_dim=96)
    assert jc.hd == 96
    tok = _tokens(jc, (B, S), seed=22)
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})
    got, _ = pm.forward(pp, {"tokens": _t(tok, torch.int64)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol("float32", want))
    jcache, pcache = jm.init_cache(B, 8), pm.init_cache(B, 8)
    jstep = jax.jit(jm.decode_step)
    for i in range(5):
        want, jcache = jstep(jp, jcache, jnp.asarray(tok[:, i:i + 1]), i)
        got, pcache = pm.decode_step(pp, pcache, _t(tok[:, i:i + 1],
                                                    torch.int64), i)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_logit_tol("float32", want))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_and_layer_norm_vs_jax(masked):
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4) if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = players.softmax_xent(_t(logits), _t(labels, torch.int64),
                               None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    x = jnp.asarray(rng.standard_normal((3, 24)) * 2 + 1, jnp.float32)
    sc = jnp.asarray(rng.standard_normal(24), jnp.float32)
    bi = jnp.asarray(rng.standard_normal(24), jnp.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        np.testing.assert_allclose(
            _np(players.layer_norm(_t(x.astype(dt)), _t(sc.astype(dt)),
                                   _t(bi.astype(dt)))),
            _np(jlayers.layer_norm(x.astype(dt), sc.astype(dt),
                                   bi.astype(dt))),
            atol=1e-5, rtol=1e-5 if dt == jnp.float32 else 2.0 ** -7)


def test_parallel_block_vs_jax():
    """command-r's block: attention and FFN from one normed input, added as
    x + attn + ffn; slot_apply over a sequence and slot_decode token by
    token against the JAX package's."""
    jc, _jm, jp, _pm, pp = _arch("command-r-35b", "float32")
    assert jc.parallel_block
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["slot0"])
    player = jax.tree.map(lambda a: a[0], pp["layers"]["slot0"])
    rng = np.random.default_rng(16)
    x = jnp.asarray(rng.standard_normal((B, 10, jc.d_model)), jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(10), (B, 10)), jnp.int32)
    want, _ = jblk.slot_apply(jlayer, jc, "attn", "dense", x, pos)
    got, aux = pblk.slot_apply(player, jc, "attn", "dense", _t(x), _t(pos))
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # the sequential block of the same weights gives another answer
    seq = dataclasses.replace(jc, parallel_block=False)
    other, _ = pblk.slot_apply(player, seq, "attn", "dense", _t(x), _t(pos))
    assert float((other - got).abs().max()) > 1e-2
    jcache = jblk.slot_cache_init(jc, "attn", B, 12, jnp.float32)
    pcache = pblk.slot_cache_init(jc, "attn", B, 12, torch.float32)
    for i in range(4):
        want, jcache, _ = jblk.slot_decode(jlayer, jc, "attn", "dense",
                                           x[:, i:i + 1], jcache, i)
        got, pcache, _ = pblk.slot_decode(player, jc, "attn", "dense",
                                          _t(x[:, i:i + 1]), pcache, i)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)


def test_moe_block_vs_jax():
    """A mixtral layer (attention + MoE with the rebalance on): slot_apply's
    (x, aux) and slot_decode's (x, cache, aux) against the JAX package's."""
    jc, _jm, jp, _pm, pp = _arch("mixtral-8x7b", "float32")
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"]["slot0"])
    player = jax.tree.map(lambda a: a[1], pp["layers"]["slot0"])
    rng = np.random.default_rng(17)
    x = jnp.asarray(rng.standard_normal((B, 12, jc.d_model)), jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(12), (B, 12)), jnp.int32)
    want, want_aux = jblk.slot_apply(jlayer, jc, "attn", "moe", x, pos)
    got, aux = pblk.slot_apply(player, jc, "attn", "moe", _t(x), _t(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    jcache = jblk.slot_cache_init(jc, "attn", B, 12, jnp.float32)
    pcache = pblk.slot_cache_init(jc, "attn", B, 12, torch.float32)
    for i in range(3):
        want, jcache, want_aux = jblk.slot_decode(
            jlayer, jc, "attn", "moe", x[:, i:i + 1], jcache, i)
        got, pcache, aux = pblk.slot_decode(
            player, jc, "attn", "moe", _t(x[:, i:i + 1]), pcache, i)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_decode_batch_of_mixtral_equals_the_jax_packages():
    """serve.decode_batch of the reduced mixtral-8x7b (float32 weights, the
    default bf16 cache, the config's capacity with the rebalance on) at
    serve.py's defaults: the same tokens; every row of every step within
    half its own top-2 gap."""
    jc, jm, jp, pm, pp = _arch("mixtral-8x7b", "float32")
    rng = np.random.default_rng(18)
    prompts = rng.integers(1, jc.vocab_size,
                           (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    want = jserve.decode_batch(
        jm, jp, [jserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], jc.padded_vocab)
    got = pserve.decode_batch(
        pm, pp, [pserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], device="cpu")
    assert got.dtype == np.int32 and got.shape == (SERVE_REQUESTS, SERVE_NEW)
    np.testing.assert_array_equal(got, want)
    for step, (jl, pl) in enumerate(_replay(jm, jp, pm, pp, prompts, got)):
        err = np.abs(jl - pl).max(axis=-1)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert (err <= 1e-3 * np.abs(jl).max()).all(), step
        assert (err < gap / 2).all(), (step, err, gap)


class _Float32Cache:
    """``model`` whose ``prefill`` makes a float32 cache (``dtype``: the
    package's float32) and is otherwise the model itself."""

    def __init__(self, model, dtype):
        self._model, self._dtype = model, dtype

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, *args, **kw):
        return self._model.prefill(*args, dtype=self._dtype, **kw)


@pytest.mark.parametrize("name", ["xlstm-350m", "jamba-v0.1-52b"])
def test_decode_batch_of_the_recurrent_models_equals_the_jax_packages(name):
    """serve.decode_batch of the reduced xlstm-350m and jamba-v0.1-52b with
    float32 weights at serve.py's defaults: the same tokens; every row of
    every step within half its own top-2 gap. xLSTM's states are float32 in
    any cache, so it runs the default bf16 cache. Jamba runs a float32
    cache on both sides: the JAX package's float32 Jamba cannot prefill into
    a bf16 one (jnp.concatenate promotes Mamba's conv window to float32 and
    lax.scan refuses the changed carry), and in bf16 the JAX package's
    jitted and op-by-op runs of one layer already route a token to other
    experts (see test_new_config_forward_vs_jax)."""
    jc, jm, jp, pm, pp = _arch(name, "float32")
    f32_cache = name == "jamba-v0.1-52b"
    if f32_cache:
        jm, pm = _Float32Cache(jm, jnp.float32), _Float32Cache(pm,
                                                              torch.float32)
    rng = np.random.default_rng(21)
    prompts = rng.integers(1, jc.vocab_size,
                           (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    want = jserve.decode_batch(
        jm, jp, [jserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], jc.padded_vocab)
    got = pserve.decode_batch(
        pm, pp, [pserve.Request(i, p, SERVE_NEW)
                 for i, p in enumerate(prompts)], device="cpu")
    assert got.dtype == np.int32 and got.shape == (SERVE_REQUESTS, SERVE_NEW)
    np.testing.assert_array_equal(got, want)
    for step, (jl, pl) in enumerate(_replay(jm, jp, pm, pp, prompts, got)):
        err = np.abs(jl - pl).max(axis=-1)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        assert (err <= 1e-3 * np.abs(jl).max()).all(), step
        assert (err < gap / 2).all(), (step, err, gap)


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", [ARCH, "mixtral-8x7b"])
def test_loss_fn_gradients_vs_jax_grad(name):
    """The port's ``loss_fn`` differentiated by torch.autograd (on the CPU:
    the plain versions) against ``jax.grad`` of the JAX package's, leaf by
    leaf: every parameter, the router and the experts included."""
    jc, jm, jp, pm, pp = _arch(name, "float32")
    tok, lab = _tokens(jc, (B, S), seed=19), _labels(jc, 20)
    want = jax.jit(jax.grad(lambda q: jm.loss_fn(
        q, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})[0]))(jp)
    leaves = dict(_leaves_with_paths(pp))
    params = {}

    def leaf(path, t):
        t = t.detach().clone().requires_grad_(True)
        params[path] = t
        return t

    def rebuild(tree, path=""):
        return {k: rebuild(v, f"{path}/{k}") if isinstance(v, dict)
                else leaf(f"{path}/{k}", v) for k, v in tree.items()}
    loss, _ = pm.loss_fn(rebuild(pp), {"tokens": _t(tok, torch.int64),
                                       "labels": _t(lab, torch.int64)})
    loss.backward()
    wanted = dict(_leaves_with_paths(want))
    assert set(params) == set(wanted) == set(leaves)
    for path, t in params.items():
        w = np.asarray(wanted[path])
        assert t.grad is not None, path
        scale = float(np.abs(w).max())
        if "ffn/router" in path or "ffn/w_" in path:
            assert scale > 0, path
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
