"""The port's recurrent mixers (``models/xlstm.py``: mLSTM and sLSTM;
``models/ssm.py``: Mamba in the SSD form) against the JAX package's, on the
CPU, at small widths (``reduced()`` widths of xlstm-350m and
jamba-v0.1-52b, or smaller for the scans alone).

The JAX package's weights, made from ``PRNGKey``s, are carried into the port
as numpy arrays (bf16 by their bits); inputs are made with numpy from a
seed. Lengths S < chunk, S = chunk and S = 4 chunks, so that the state
carry crosses chunks; gates reach values near 0 and near 1. Tolerances,
each with its reason:

* the scans, the causal conv and the mixers in float32: atol = rtol = 1e-5
  (float32 sums in other orders, as ``tests/test_torch_lm_model.py``);
  but the SSD scan's atol is ``1e-5 * max|y|`` (and ``max|h|``): its
  intra-chunk decays are exponentials of differences of float32 cumulative
  sums that reach |cs| ~ 10^3 at these decays, so each package carries a
  relative error of about |cs| 2^-24 in a decay; both then lie about 1e-4
  from a float64 recurrence at |y| ~ 60, which the test also checks (the
  port no further from it than twice the JAX package's distance);
* the causal conv in bf16: one bf16 ulp (rtol 2^-7), since both sum the
  taps in float32 in the same order and round once;
* the mixers in bf16: ``2e-2 * max|y|``, the bf16 tolerance of the kernel
  tests (bf16 rounds at other places in the two frameworks);
* within the port, the decode steps run in sequence against ``*_apply`` at
  every position: ``1e-4 * max|y|`` in float32 (the chunked scan and the
  recurrence are the same sums in other orders; float32 rounding ~1e-6).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import xlstm as jx
from repro_torch.models import ssm as pssm
from repro_torch.models import xlstm as px

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32 = dict(atol=1e-5, rtol=1e-5)
#: the chunk of the scans alone, and S below, at and four times over it
CHUNK = 16
LENGTHS = (5, CHUNK, 4 * CHUNK)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tree(jtree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in jtree.items()}


def _rng(seed):
    return np.random.default_rng(seed)


def _gates(rng, shape):
    """Gates in (0, 1) from logits spread wide: many within 1e-3 of 0 or 1."""
    return 1.0 / (1.0 + np.exp(-4.0 * rng.standard_normal(shape)))


# ---------------------------------------------------------------------------
# the scans and the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", LENGTHS)
def test_mlstm_chunked_vs_jax(S):
    rng = _rng(S)
    B, H, P = 2, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    i_g, f_g = (_gates(rng, (B, S, H)).astype(np.float32) for _ in range(2))
    # one forget gate a sequence near 0 and one near 1
    f_g[:, 0], f_g[:, S - 1] = 1e-4, 1 - 1e-4
    want_y, (want_C, want_n) = jx._mlstm_chunked(
        *map(jnp.asarray, (q, k, v, i_g, f_g)), CHUNK)
    got_y, (got_C, got_n) = px._mlstm_chunked(
        *map(torch.from_numpy, (q, k, v, i_g, f_g)), CHUNK)
    assert got_y.dtype == torch.float32 and tuple(got_y.shape) == (B, S, H, P)
    for got, want in ((got_y, want_y), (got_C, want_C), (got_n, want_n)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("S", LENGTHS)
def test_ssd_chunked_vs_jax(S):
    rng = _rng(100 + S)
    B, Hm, P, N = 2, 4, 8, 6
    xh = rng.standard_normal((B, S, Hm, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    # dt = softplus of a wide normal, up to several units (decays near 0),
    # and one step a sequence at 1e-4 (a decay near 1)
    dt = np.log1p(np.exp(3.0 * rng.standard_normal((B, S, Hm)))).astype(
        np.float32)
    dt[:, S // 2] = 1e-4
    A = -np.linspace(1.0, 16.0, Hm).astype(np.float32)
    assert dt.min() < 1e-3 and (np.exp(dt * A[-1]) < 1e-3).any()
    want_y, want_h = jssm._ssd_chunked(*map(jnp.asarray, (xh, Bm, Cm, dt, A)),
                                       CHUNK)
    got_y, got_h = pssm._ssd_chunked(*map(torch.from_numpy,
                                          (xh, Bm, Cm, dt, A)), CHUNK)
    for got, want in ((got_y, want_y), (got_h, want_h)):
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=1e-5,
            atol=1e-5 * float(np.abs(_np(want)).max()))
    # the recurrence in float64: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    # y_t = h_t C_t
    h = np.zeros((B, Hm, P, N))
    ys = []
    for t in range(S):
        h = h * np.exp(dt[:, t].astype(np.float64) * A)[..., None, None] + \
            np.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t][..., None], Bm[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    exact = np.stack(ys, axis=1)
    ref_err = np.abs(_np(want_y) - exact).max()
    assert np.abs(_np(got_y) - exact).max() <= \
        2 * ref_err + 1e-6 * np.abs(exact).max()


def test_scans_refuse_a_length_that_is_not_a_multiple_of_the_chunk():
    x = torch.zeros((1, 20, 2, 4))
    g = torch.full((1, 20, 2), 0.5)
    with pytest.raises(AssertionError):
        px._mlstm_chunked(x, x, x, g, g, CHUNK)
    with pytest.raises(AssertionError, match="not divisible"):
        pssm._ssd_chunked(x, torch.zeros((1, 20, 3)), torch.zeros((1, 20, 3)),
                          g, -torch.ones(2), CHUNK)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENGTHS)
def test_causal_conv_vs_jax(S, dtype):
    rng = _rng(200 + S)
    x = jnp.asarray(rng.standard_normal((2, S, 24)), jnp.float32).astype(
        JDT[dtype])
    w = jnp.asarray(rng.standard_normal((4, 24)) / 2, jnp.float32).astype(
        JDT[dtype])
    got = pssm._causal_conv(_t(x), _t(w))
    want = jssm._causal_conv(x, w)
    assert got.dtype == TDT[dtype]
    tol = F32 if dtype == "float32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_softplus_is_logaddexp_at_every_x():
    """jax.nn.softplus above F.softplus's threshold of 20 too."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(_np(pssm._softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

#: d_model and heads of the reduced configs; Mamba at jamba's reduced dims
D, NH = 64, 4
XD = jx.xlstm_dims(D, NH)
MD = jssm.mamba_dims(D, 2, 16, 8, 4)

_MIXERS = {
    "mlstm": (jx.mlstm_init, jx.mlstm_apply, px.mlstm_apply, XD, CHUNK),
    "slstm": (jx.slstm_init, jx.slstm_apply, px.slstm_apply, XD, CHUNK),
    "mamba": (jssm.mamba_init, jssm.mamba_apply, pssm.mamba_apply, MD, CHUNK),
}


def _mixer(name, dtype, seed=0):
    init = _MIXERS[name][0]
    jp = init(jax.random.PRNGKey(seed), _MIXERS[name][3], JDT[dtype])
    return jp, _tree(jp)


def _x(S, dtype, seed):
    x = jnp.asarray(_rng(seed).standard_normal((2, S, D)), jnp.float32)
    return x.astype(JDT[dtype])


def test_float32_leaves_of_bf16_mixers():
    """Mamba's A_log, D and dt_bias and sLSTM's bias stay float32 in a bf16
    model, in both packages; every other leaf is bf16."""
    for name, f32 in (("mamba", {"A_log", "D", "dt_bias"}),
                      ("slstm", {"bias"}), ("mlstm", set())):
        jp, pp = _mixer(name, "bfloat16")
        for key, leaf in pp.items():
            want = torch.float32 if key in f32 else torch.bfloat16
            assert leaf.dtype == want and str(jp[key].dtype) == \
                str(want).split(".")[-1], (name, key)
        init = {"mamba": pssm.mamba_init, "slstm": px.slstm_init,
                "mlstm": px.mlstm_init}[name]
        shapes = init(None, _MIXERS[name][3], torch.bfloat16)
        assert {k: (tuple(v.shape), v.dtype) for k, v in shapes.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in pp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_MIXERS))
def test_mixer_apply_vs_jax(name, dtype):
    _init, japply, papply, dims, chunk = _MIXERS[name]
    jp, pp = _mixer(name, dtype, seed=len(name))
    x = _x(4 * CHUNK, dtype, seed=3)
    want = japply(jp, x, dims, chunk)
    got = papply(pp, _t(x), dims, chunk)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0,
            atol=2e-2 * float(np.abs(_np(want)).max()))


_DECODE = {
    "mlstm": (jx.mlstm_cache_init, jx.mlstm_decode_step,
              px.mlstm_cache_init, px.mlstm_decode_step, XD),
    "slstm": (jx.slstm_cache_init, jx.slstm_decode_step,
              px.slstm_cache_init, px.slstm_decode_step, XD),
    "mamba": (jssm.mamba_cache_init, jssm.mamba_decode_step,
              pssm.mamba_cache_init, pssm.mamba_decode_step, MD),
}


@pytest.mark.parametrize("name", sorted(_DECODE))
def test_decode_step_and_state_vs_jax(name):
    """Five decode steps in float32, each output and every state leaf
    against the JAX package's; the port writes its state into the cache it
    was given (the same tensors, in place)."""
    jinit, jstep, pinit, pstep, dims = _DECODE[name]
    jp, pp = _mixer(name, "float32", seed=7)
    x = _x(5, "float32", seed=8)
    jc = jinit(dims, 2) if name != "mamba" else jinit(dims, 2, jnp.float32)
    pc = pinit(dims, 2) if name != "mamba" else pinit(dims, 2, torch.float32)
    held = dict(pc)
    for i in range(5):
        want, jc = jstep(jp, x[:, i:i + 1], jc, dims)
        got, out_cache = pstep(pp, _t(x[:, i:i + 1]), pc, dims)
        assert out_cache is pc
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        assert set(pc) == set(jc)
        for key in jc:
            assert pc[key] is held[key], key
            np.testing.assert_allclose(_np(pc[key]), _np(jc[key]), **F32,
                                       err_msg=f"{name} {key} step {i}")


@pytest.mark.parametrize("name", sorted(_DECODE))
def test_decode_steps_reproduce_apply(name):
    """Within the port: the decode steps run in sequence from an empty
    state give ``*_apply``'s output at every position (S = 4 chunks)."""
    _jinit, _jstep, pinit, pstep, dims = _DECODE[name]
    _jp, pp = _mixer(name, "float32", seed=9)
    x = _t(_x(4 * CHUNK, "float32", seed=10))
    want = _MIXERS[name][2](pp, x, dims, CHUNK)
    cache = pinit(dims, 2) if name != "mamba" else pinit(dims, 2,
                                                        torch.float32)
    got = torch.cat([pstep(pp, x[:, i:i + 1], cache, dims)[0]
                     for i in range(x.shape[1])], dim=1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_mamba_decode_with_a_bf16_conv_window_beside_float32_x():
    """A float32 x beside a bf16 cache: the window is formed in float32
    (the JAX package's promotion), the step's output matches the JAX
    package's given the same float32 window, and the cache keeps bf16 (the
    new window rounded into it)."""
    jp, pp = _mixer("mamba", "float32", seed=11)
    x = _x(1, "float32", seed=12)
    rng = _rng(13)
    conv = rng.standard_normal((2, MD.d_conv - 1, MD.d_inner))
    conv16 = jnp.asarray(conv, jnp.float32).astype(jnp.bfloat16)
    h = jnp.asarray(rng.standard_normal((2, MD.n_heads, MD.head_p,
                                         MD.d_state)), jnp.float32)
    want, jc = jssm.mamba_decode_step(jp, x, {"h": h, "conv": conv16}, MD)
    pc = {"h": _t(h), "conv": _t(conv16)}
    got, pc = pssm.mamba_decode_step(pp, _t(x), pc, MD)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(pc["h"]), _np(jc["h"]), **F32)
    assert jc["conv"].dtype == jnp.float32 and \
        pc["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pc["conv"].view(torch.int16).numpy(),
        np.asarray(jc["conv"].astype(jnp.bfloat16)).view(np.int16))
