"""The port's encoder-decoder and vision-prefix paths against the JAX
package's, on the CPU, at ``reduced()`` of ``whisper-large-v3`` (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, 16 frames, learned
positions, a cross-attention in every decoder layer) and of
``internvl2-76b`` (2 layers, a vision prefix of 8 patch embeddings).

The JAX package's parameters, made from ``PRNGKey``s, are carried into the
port by ``models.interop.params_from_jax``; tokens, frames and patch
embeddings are made with numpy from a seed, frames and patches in bf16 and
scaled by 0.02 as ``tests/test_models_smoke.py`` draws them. Module by
module (the ``xattn`` slot, the encoder) and for the slice as a whole
(``forward``, ``build_prefill_step``, ``prefill`` and every cache leaf, the
decode step). Tolerances are those of ``tests/test_torch_lm_model.py``,
each with its reason there:

* float32 parameters: logits within ``1e-4 * max|logit|``, hidden states
  and float32 caches within atol = rtol = 1e-5 (float32 sums in other
  orders);
* a bf16 cache within one bf16 ulp (rtol 2^-7); the logits, and the cache
  leaves written after a read of it, also within ``1e-3`` of their largest
  value (those one-ulp differences move them);
* bf16 parameters: ``2e-2 * max|logit|``, the bf16 tolerance of the kernel
  tests;
* decode against forward within the port, in float32: ``1e-3 * max|logit|
  + 1e-3`` (``tests/test_models_smoke.py``'s parity).
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
from repro.launch.steps import build_prefill_step as j_prefill_step
from repro.models import blocks as jblk
from repro.models import build_model as jbuild
from repro_torch.configs import SHAPES as PSHAPES
from repro_torch.configs import cell_is_runnable as p_runnable
from repro_torch.configs import get_config as pget
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import blocks as pblk
from repro_torch.models import build_model as pbuild
from repro_torch.models.interop import params_from_jax

torch.set_num_threads(1)

ARCHS = ("whisper-large-v3", "internvl2-76b")
#: parameter counts of the full configs (JAX ``param_count``)
FULL_COUNTS = {"whisper-large-v3": 1_645_114_880,
               "internvl2-76b": 70_553_706_496}
B, S = 2, 12
F32 = dict(atol=1e-5, rtol=1e-5)


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


@functools.lru_cache(maxsize=None)
def _arch(name, param_dtype):
    """(jax cfg, jax model, jax params, port model, port params) of
    ``name``'s reduced config; the JAX weights carried into the port."""
    jc = dataclasses.replace(jget(name).reduced(), param_dtype=param_dtype)
    pc = dataclasses.replace(pget(name).reduced(), param_dtype=param_dtype)
    jm, pm = jbuild(jc), pbuild(pc, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(sum(map(ord, name))))
    return jc, jm, jp, pm, params_from_jax(jax.tree.map(np.asarray, jp), pm)


def _batch(cfg, seed, s=S):
    """(the JAX package's batch, the port's): tokens, and the frames or the
    patch embeddings the config takes, in bf16 (tests/test_models_smoke.py)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok)}
    if cfg.is_encoder_decoder:
        jb["frames"] = jnp.asarray(rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)) * 0.02, jnp.bfloat16)
    if cfg.vision_prefix_len:
        jb["vis_embeds"] = jnp.asarray(rng.normal(
            size=(B, cfg.vision_prefix_len, cfg.d_model)) * 0.02,
            jnp.bfloat16)
    pb = {k: _t(v, torch.int64) if k == "tokens" else _t(v)
          for k, v in jb.items()}
    return jb, pb


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_is_a_copy_of_the_jax_packages(name):
    for j, p in ((jget(name), pget(name)),
                 (jget(name).reduced(), pget(name).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert (j.hd, j.padded_vocab, j.n_layers, j.sub_quadratic) == \
            (p.hd, p.padded_vocab, p.n_layers, p.sub_quadratic)
    for shape in JSHAPES:
        assert p_runnable(pget(name), PSHAPES[shape]) == \
            j_runnable(jget(name), JSHAPES[shape]), shape


def _jax_shapes(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


def _port_shapes(model):
    return jax.tree.map(lambda s: (s[0], str(s[1]).split(".")[-1]),
                        model.param_shapes(),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("name", ARCHS)
def test_param_tree_and_count_match_the_jax_package(name):
    _jc, jm, jp, pm, _pp = _arch(name, "bfloat16")
    assert _port_shapes(pm) == _jax_shapes(jp)
    assert pm.param_count() == jm.param_count()
    full_j, full_p = jbuild(jget(name)), pbuild(pget(name), device="cpu")
    assert _port_shapes(full_p) == _jax_shapes(full_j.abstract_params())
    assert full_p.param_count() == full_j.param_count() == FULL_COUNTS[name]


def test_params_from_jax_carries_and_checks_the_new_leaves():
    """pos_embed, the encoder's subtree and each slot's xnorm/xattn cross
    leaf for leaf, bf16 by its bits; a missing or extra leaf raises."""
    _jc, _jm, jp, pm, pp = _arch("whisper-large-v3", "bfloat16")
    for path in (("pos_embed",), ("encoder", "pos"),
                 ("encoder", "layers", "slot0", "attn", "wq"),
                 ("layers", "slot0", "xattn", "wk"),
                 ("layers", "slot0", "xnorm")):
        a, b = jp, pp
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    tree = jax.tree.map(np.asarray, jp)
    slot = {k: v for k, v in tree["layers"]["slot0"].items() if k != "xnorm"}
    with pytest.raises(ValueError, match="missing.*xnorm"):
        params_from_jax(dict(tree, layers={"slot0": slot}), pm)
    with pytest.raises(ValueError, match="missing.*encoder"):
        params_from_jax({k: v for k, v in tree.items() if k != "encoder"},
                        pm)
    enc = dict(tree["encoder"], extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="not expected.*extra"):
        params_from_jax(dict(tree, encoder=enc), pm)
    with pytest.raises(ValueError, match="pos_embed"):
        params_from_jax(dict(tree, pos_embed=tree["pos_embed"][:-1]), pm)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

def test_xattn_slot_vs_jax():
    """One decoder layer of Whisper (self-attention without RoPE, then
    non-causal cross-attention over an encoder output, then the GeLU MLP):
    slot_apply over a sequence, and slot_decode token by token into a cache
    whose cross leaves hold the encoder output's projections."""
    jc, _jm, jp, _pm, pp = _arch("whisper-large-v3", "float32")
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"]["slot0"])
    player = jax.tree.map(lambda a: a[1], pp["layers"]["slot0"])
    assert "q_norm" not in player["xattn"] and set(player) == {
        "norm1", "attn", "xnorm", "xattn", "norm2", "ffn"}
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, 10, jc.d_model)), jnp.float32)
    enc = jnp.asarray(rng.standard_normal((B, jc.encoder_seq_len,
                                           jc.d_model)), jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(10), (B, 10)), jnp.int32)
    want, _ = jblk.slot_apply(jlayer, jc, "xattn", "dense", x, pos,
                              enc_out=enc)
    got, aux = pblk.slot_apply(player, jc, "xattn", "dense", _t(x), _t(pos),
                               enc_out=_t(enc))
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    jcache = jblk.slot_cache_init(jc, "xattn", B, 12, jnp.float32)
    pcache = pblk.slot_cache_init(jc, "xattn", B, 12, torch.float32)
    assert {k: tuple(v.shape) for k, v in pcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    xk, xv = pblk.cross_kv(player["xattn"], jc, _t(enc))
    pcache["xk"].copy_(xk)
    pcache["xv"].copy_(xv)
    jcache = dict(jcache, xk=jnp.asarray(_np(xk)), xv=jnp.asarray(_np(xv)))
    for i in range(4):
        want, jcache, _ = jblk.slot_decode(jlayer, jc, "xattn", "dense",
                                           x[:, i:i + 1], jcache, i)
        got, pcache, _ = pblk.slot_decode(player, jc, "xattn", "dense",
                                          _t(x[:, i:i + 1]), pcache, i)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for key in jcache:
            np.testing.assert_allclose(_np(pcache[key]), _np(jcache[key]),
                                       **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_vs_jax(dtype):
    """The encoder: frames plus learned positions, non-causal layers without
    RoPE, the final norm."""
    jc, jm, jp, pm, pp = _arch("whisper-large-v3", dtype)
    jb, pb = _batch(jc, 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax.jit(lambda p, f: jm._encode(p, f.astype(jdt), "chunked"))(
        jp, jb["frames"])
    got = pm._encode(pp, pb["frames"].to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_logit_tol(dtype, want))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_vs_jax(name, dtype):
    """Logits at the text positions only (the vision prefix's rows are
    dropped before the head)."""
    jc, jm, jp, pm, pp = _arch(name, dtype)
    jb, pb = _batch(jc, 11)
    want, _ = jax.jit(jm.forward)(jp, jb)
    got, aux = pm.forward(pp, pb)
    assert got.dtype == torch.float32 and got.shape == (B, S, jc.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol(dtype, want))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_step_vs_jax(name):
    jc, jm, jp, pm, pp = _arch(name, "float32")
    jb, pb = _batch(jc, 12)
    want = jax.jit(j_prefill_step(jm))(jp, jb)
    got = build_prefill_step(pm, device="cpu")(pp, pb)
    assert got.shape == (B, 1, jc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_logit_tol("float32", want))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_every_cache_leaf_vs_jax(name, cache_dtype):
    """Sequential prefill: the encoder and the cross caches (Whisper), the
    prefix's steps on embeddings then the text's (InternVL); the last
    logits and every leaf of every layer's cache."""
    jc, jm, jp, pm, pp = _arch(name, "float32")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    jb, pb = _batch(jc, 13)
    max_seq = jc.vision_prefix_len + S + 3
    jcache, jlog = jm.prefill(jp, jb, max_seq=max_seq, dtype=jdt)
    pcache, plog = pm.prefill(pp, pb, max_seq=max_seq, dtype=tdt)
    # a bf16 cache's one-ulp differences move the logits by up to
    # 1e-3 * max|logit| (tests/test_torch_lm_model.py's decode_batch bound)
    scale = 1.0 if cache_dtype == "float32" else 10.0
    np.testing.assert_allclose(_np(plog), _np(jlog), rtol=0,
                               atol=scale * _logit_tol("float32", jlog))
    leaves = jcache["layers"]["slot0"]
    assert set(pcache["layers"]["slot0"]) == set(leaves) == (
        {"k", "v", "xk", "xv"} if jc.is_encoder_decoder else {"k", "v"})
    for key, want in leaves.items():
        got = pcache["layers"]["slot0"][key]
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        if cache_dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), **F32)
        else:
            # a leaf written after reads of the bf16 cache carries their
            # one-ulp differences, as the logits do
            np.testing.assert_allclose(
                _np(got), _np(want), rtol=2.0 ** -7,
                atol=1e-3 * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_with_a_device_position_vs_jax(name):
    """After prefill, steps with ``pos`` as an int32 tensor (the learned
    position's row read on the device): the same bits as the int position,
    and the JAX package's jitted ``decode_step`` given ``jnp.int32(pos)``."""
    jc, jm, jp, pm, pp = _arch(name, "bfloat16")
    jb, pb = _batch(jc, 14)
    P = jc.vision_prefix_len
    max_seq = P + S + 4
    jcache, _ = jm.prefill(jp, jb, max_seq=max_seq)
    ca, _ = pm.prefill(pp, pb, max_seq=max_seq)
    cb, _ = pm.prefill(pp, pb, max_seq=max_seq)
    tok = np.random.default_rng(15).integers(
        0, jc.vocab_size, (B, 4)).astype(np.int32)
    jstep = jax.jit(jm.decode_step)
    for i in range(4):
        t = _t(tok[:, i:i + 1], torch.int64)
        pos = P + S + i
        la, _ = pm.decode_step(pp, ca, t, pos)
        lb, _ = pm.decode_step(pp, cb, t, torch.tensor(pos,
                                                       dtype=torch.int32))
        assert torch.equal(la, lb)
        for key in ca["layers"]["slot0"]:
            assert torch.equal(ca["layers"]["slot0"][key],
                               cb["layers"]["slot0"][key])
        want, jcache = jstep(jp, jcache, jnp.asarray(tok[:, i:i + 1]),
                             jnp.int32(pos))
        np.testing.assert_allclose(_np(lb), _np(want), rtol=0,
                                   atol=_logit_tol("bfloat16", want))


def test_prefill_passes_the_prefix_embeddings_to_its_step():
    """``Model.prefill(step=)`` runs the vision prefix through the step with
    ``embeds=`` (zero tokens, positions 0 ... P - 1), then the text at P +
    i: the same bits as the default step."""
    jc, _jm, _jp, pm, pp = _arch("internvl2-76b", "float32")
    _jb, pb = _batch(jc, 16, s=5)
    seen = []

    def step(params, cache, tokens, pos, embeds=None):
        seen.append((pos, embeds is not None, int(tokens.abs().sum())))
        return pm.decode_step(params, cache, tokens,
                              torch.tensor(pos, dtype=torch.int32), embeds)
    P = jc.vision_prefix_len
    ca, la = pm.prefill(pp, pb, max_seq=P + 5)
    cb, lb = pm.prefill(pp, pb, max_seq=P + 5, step=step)
    assert [(p, e) for p, e, _ in seen] == \
        [(i, i < P) for i in range(P + 5)]
    assert all(n == 0 for _p, e, n in seen if e)
    assert torch.equal(la, lb)
    for key in ("k", "v"):
        assert torch.equal(ca["layers"]["slot0"][key],
                           cb["layers"]["slot0"][key])
    with pytest.raises(ValueError, match="prefill cache too small"):
        pm.prefill(pp, pb, max_seq=P + 4)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """tests/test_models_smoke.py's parity in the port, float32: the last
    position's logits of forward against sequential prefill."""
    jc, _jm, _jp, pm, pp = _arch(name, "float32")
    _jb, pb = _batch(jc, 17, s=32)
    fwd = pm.forward(pp, pb)[0][:, -1]
    _cache, dec = pm.prefill(pp, pb, max_seq=jc.vision_prefix_len + 32,
                             dtype=torch.float32)
    diff = float((fwd - dec[:, 0]).abs().max())
    assert diff < 1e-3 * float(fwd.abs().max()) + 1e-3, diff


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_neither_syncs_nor_copies(name):
    """The dispatch lint's record of the reduced decode step (the position
    on the device): no read of a device value on the host, no copy back;
    Whisper's reads its learned position's row with ``index_select``."""
    from repro_torch.check import dispatch_lint as dl
    ops = dl.decode_step_ops(torch.device("cpu"), name)
    assert ops and not [op.name for op in ops
                        if op.name == dl.SYNC_OP or op.to_host]
    assert ("aten::index_select" in {op.name for op in ops}) == \
        (name == "whisper-large-v3")


@pytest.mark.parametrize("name", ARCHS)
def test_every_kernel_operand_is_contiguous(name, monkeypatch):
    """On the card the kernel wrappers refuse a non-contiguous operand; on
    the CPU they run the plain version, which would not notice. So each
    wrapper is wrapped here to check the rule through forward, prefill
    (the prefix's rows are slices of ``vis_embeds``) and a decode step."""
    from repro_torch.kernels import ops
    for fn in ("rms_norm", "flash_attention", "flash_decode"):
        def checked(*args, _real=getattr(ops, fn), _fn=fn, **kw):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and a.ndim > 1:
                    assert a.is_contiguous(), (_fn, i, tuple(a.shape))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, fn, checked)
    jc, _jm, _jp, pm, pp = _arch(name, "bfloat16")
    _jb, pb = _batch(jc, 18, s=4)
    pm.forward(pp, pb)
    cache, logits = pm.prefill(pp, pb, max_seq=jc.vision_prefix_len + 5)
    pm.decode_step(pp, cache, torch.ones((B, 1), dtype=torch.int64),
                   jc.vision_prefix_len + 4)
