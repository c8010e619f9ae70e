"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's (``repro.optim``), on the CPU, from the same
numpy inputs; then the port's twins of ``tests/test_substrates.py``'s
optimizer and compression tests.

Tolerances, each with its reason:

* ``schedule`` and the ``lr`` metric: rtol 1e-6 — float32 ``cos`` and
  ``pow`` of two libraries may differ in the last bit;
* ``grad_norm``: rtol 1e-6 — float32 sums in other orders;
* ``m`` and ``v``: rtol 1e-5 and atol 1e-6 · max|leaf| — the same
  float32 operations in the same order on inputs that differ by the clip
  scale's last bit at most; XLA may fuse b1 · m + (1 - b1) · g into one
  multiply-add, so where the two terms cancel an element differs by an ulp
  of the larger one;
* float32 parameters: within 1e-6 · |p| + 1e-6 · lr per step — the update
  is lr · m̂ / (√v̂ + eps) with |m̂ / √v̂| ≤ 1 here (gradients far from
  0), so float32 rounding of the direction moves a parameter by well under
  1e-6 · lr; bf16 parameters within one bf16 step (2^-7 · |p|): the same
  float32 value rounds to neighbouring bf16 values where it sits on a
  rounding boundary;
* ``step``, the int8 payload, the scale and the error-feedback residuals:
  equal (the same float32 operations on the same inputs).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor of the same dtype and bits."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def tree_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_torch(v) for k, v in tree.items()}
    return to_torch(tree)


def _params(rng):
    """bf16 and float32 leaves of 1 and 2 dims, nested."""
    return {"w": rng.normal(size=(6, 5)).astype(ml_dtypes.bfloat16),
            "norm": rng.normal(size=(5,)).astype(np.float32),
            "blk": {"a": rng.normal(size=(4, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(ml_dtypes.bfloat16)}}


def _grads(rng, params, scale):
    return {k: _grads(rng, v, scale) if isinstance(v, dict)
            else (rng.normal(size=v.shape) * scale).astype(v.dtype)
            for k, v in params.items()}


def _walk(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_apply_vs_jax_for_five_steps(clip):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip)
    jcfg, pcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.init(jp)
    pp, ps = tree_torch(p0), adamw.init(tree_torch(p0))
    for step in range(5):
        # gradients large enough that clipping acts when it is on
        g = _grads(rng, p0, 3.0)
        jp, js, jm = jax.jit(lambda p, s, gr: jadamw.apply(jcfg, p, s, gr))(
            jp, js, jax.tree.map(jnp.asarray, g))
        pp, ps, pm = adamw.apply(pcfg, pp, ps, tree_torch(g))
        assert int(ps.step) == int(js.step) == step + 1
        assert ps.step.dtype == torch.int32
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for tree_p, tree_j in ((ps.m, js.m), (ps.v, js.v)):
            for path, a, b in _walk(tree_p, tree_np(tree_j)):
                assert a.dtype == torch.float32, path
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max(),
                    err_msg=path)
        for path, a, b in _walk(pp, tree_np(jp)):
            assert to_np(a).dtype == b.dtype, path
            got, want = to_np(a).astype(np.float32), b.astype(np.float32)
            if a.dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           err_msg=path)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=1e-6,
                    atol=1e-6 * cfg_kw["lr"] * (step + 1), err_msg=path)


def test_adamw_writes_into_none_of_its_inputs():
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    params = tree_torch(p0)
    state = adamw.init(params)
    grads = tree_torch(_grads(rng, p0, 1.0))
    keep = [t.clone() for t in (params["w"], params["blk"]["a"],
                                grads["w"], state.step)]
    new_p, new_s, _ = adamw.apply(adamw.AdamWConfig(), params, state, grads)
    new_p, new_s, _ = adamw.apply(adamw.AdamWConfig(), params, new_s, grads)
    for a, b in zip(keep, (params["w"], params["blk"]["a"], grads["w"],
                           state.step)):
        assert torch.equal(a, b)
    assert int(state.step) == 0 and int(new_s.step) == 2
    assert float(state.m["w"].abs().max()) == 0.0
    # the zero moments take no memory: one element a leaf
    assert state.m["w"].stride() == (0, 0)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_schedule_vs_jax(step):
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.int32(step)))
    got = adamw.schedule(adamw.AdamWConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_state_shapes_allocate_nothing_and_match_init():
    shapes = {"w": ((6, 5), torch.bfloat16), "n": ((5,), torch.float32)}
    st = adamw.state_shapes(shapes)
    assert st.step == ((), torch.int32)
    assert st.m == {"w": ((6, 5), torch.float32), "n": ((5,), torch.float32)}
    assert st.v == st.m
    ef = comp.ef_shapes(shapes)
    assert ef.error == st.m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_vs_jax(seed):
    x = (np.random.default_rng(seed).normal(size=(257,)) * 5).astype(
        np.float32)
    jq, js = jcomp.compress(jnp.asarray(x))
    pq, ps = comp.compress(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert float(ps) == float(js)
    np.testing.assert_array_equal(comp.decompress(pq, ps).numpy(),
                                  np.asarray(jcomp.decompress(jq, js)))


def test_compress_rounds_half_to_even_as_jnp_round():
    # 127 * x / max|x| lands on .5 exactly for these values
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    jq, _ = jcomp.compress(jnp.asarray(x))
    pq, _ = comp.compress(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pq.numpy()[:5], [0, 2, 2, 0, -2])


def test_ef_compress_tree_vs_jax_over_three_steps():
    rng = np.random.default_rng(11)
    p0 = _params(rng)
    jef = jcomp.init_ef(jax.tree.map(jnp.asarray, p0))
    pef = comp.init_ef(tree_torch(p0))
    for _ in range(3):
        g = _grads(rng, p0, 0.3)
        jg, jef = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, g), jef)
        pg, pef = comp.ef_compress_tree(tree_torch(g), pef)
        for path, a, b in _walk(pg, tree_np(jg)):
            assert to_np(a).dtype == b.dtype, path
            np.testing.assert_array_equal(to_np(a), b, err_msg=path)
        for path, a, b in _walk(pef.error, tree_np(jef.error)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


def test_wire_bytes_vs_jax():
    p0 = _params(np.random.default_rng(0))
    assert comp.wire_bytes(tree_torch(p0)) == jcomp.wire_bytes(
        jax.tree.map(jnp.asarray, p0))
    shapes = {"a": ((10, 10), torch.float32), "b": ((5,), torch.float32)}
    assert comp.wire_bytes(shapes) == (4 * 105, 105 + 8)


# ---------------------------------------------------------------------------
# twins of tests/test_substrates.py
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0, clip_norm=0)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw.apply(cfg, params, state, {"w": g})
    assert float((params["w"] - target).abs().max()) < 0.05
    assert int(state.step) == 200


def test_adamw_clip_and_schedule():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                            clip_norm=1.0)
    i32 = torch.int32
    assert float(adamw.schedule(cfg, torch.tensor(0, dtype=i32))) == 0.0
    assert float(adamw.schedule(cfg, torch.tensor(10, dtype=i32))) == \
        pytest.approx(1e-2)
    assert float(adamw.schedule(cfg, torch.tensor(100, dtype=i32))) == \
        pytest.approx(1e-3)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init(params)
    _, _, m = adamw.apply(cfg, params, state, {"w": torch.full((4,), 100.0)})
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_adamw_bf16_params_f32_state():
    params = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state.m["w"].dtype == torch.float32
    new_p, new_s, _ = adamw.apply(adamw.AdamWConfig(), params, state,
                                  {"w": torch.ones((8, 8),
                                                   dtype=torch.bfloat16)})
    assert new_p["w"].dtype == torch.bfloat16
    assert new_s.m["w"].dtype == new_s.v["w"].dtype == torch.float32


def test_compress_roundtrip_error_bounded():
    x = torch.randn(128, generator=torch.Generator().manual_seed(0)) * 5
    q, s = comp.compress(x)
    err = (comp.decompress(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_converges():
    """EF-compressed gradient descent reaches the optimum despite int8."""
    target = torch.tensor([1.0, -4.0, 2.5, 0.1])
    params = {"w": torch.zeros(4)}
    ef = comp.init_ef(params)
    lr = 0.05
    for _ in range(400):
        g = {"w": 2 * (params["w"] - target)}
        gq, ef = comp.ef_compress_tree(g, ef)
        params = {"w": params["w"] - lr * gq["w"]}
    assert float((params["w"] - target).abs().max()) < 0.02


def test_wire_bytes():
    params = {"a": torch.zeros((10, 10)), "b": torch.zeros(5)}
    raw, compressed = comp.wire_bytes(params)
    assert raw == 4 * 105
    assert compressed < raw / 3
