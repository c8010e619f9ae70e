"""The port's MoE layer (``models/moe.py``) against the JAX package's, on the
CPU, at the widths of ``get_config("mixtral-8x7b").reduced()`` (d_model 64,
4 experts of 64, top-2).

The JAX package's weights, made from ``PRNGKey``s, are carried into the port
as numpy arrays (bf16 by their bits); inputs are made with numpy from a
seed. Tolerances, each with its reason:

* routing — every expert index, slot, keep mask and gate-free integer
  tensor — and the ``dropped``/``stolen`` fractions: exact. Both packages
  compute the router's float32 product and softmax; a different order of
  summation could only move a choice where two probabilities are within a
  few float32 ulps, so each case first checks that every token's adjacent
  top-(k+1) probabilities are at least 1e-6 apart and reports the case if
  not (a near-tie, not a fault);
* float32: ``y`` within atol = rtol = 1e-5 (float32 sums in other orders);
  gates, ``aux`` and ``load_std`` within rtol 1e-6;
* bfloat16: ``y`` within ``2e-2 * max|y|``, the bf16 tolerance of the
  kernel tests (bf16 rounds at other places in the two frameworks).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.check import dispatch_lint as dl
from repro_torch.configs import get_config
from repro_torch.models import moe as pmoe
from repro_torch.models.model import Model

torch.set_num_threads(1)

E, K, D, F = 4, 2, 64, 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _params(dtype, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, F, E, JDT[dtype])
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, dtype, seed=1, skew=0.0):
    """Normal tokens; ``skew`` adds one shared random direction to every
    token, which pushes them all towards the same experts (overflow)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    return jnp.asarray(x, jnp.float32).astype(JDT[dtype])


def _assert_no_near_tie(xt, router, k):
    logits = np.asarray(xt, np.float64) @ np.asarray(router, np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    gap = float(np.diff(-top, axis=-1).min())
    assert gap > 1e-6, f"near-tie in the router (gap {gap}): report it"


def test_capacity_is_the_jax_expression():
    """Python's round, half to even: decode at B = 24 gives 8 slots, the
    prefill of 4 x 2048 tokens 2560 (mixtral: 8 experts, top-2, 1.25)."""
    assert pmoe.capacity(24, 2, 1.25, 8) == 8 == round(7.5)
    assert pmoe.capacity(8192, 2, 1.25, 8) == 2560
    assert pmoe.capacity(20, 2, 1.25, 8) == 6 == round(6.25)
    assert pmoe.capacity(2, 1, 0.1, 8) == 1


def test_init_tree_matches_the_jax_package():
    jp, _ = _params("bfloat16")
    got = pmoe.moe_init(torch.Generator().manual_seed(0), D, F, E,
                        torch.bfloat16)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == want
    assert got["router"].dtype == torch.float32
    assert float(got["router"].std()) == pytest.approx(0.02, rel=0.1)
    meta = pmoe.moe_init(None, D, F, E, torch.bfloat16)
    assert all(v.device.type == "meta" for v in meta.values())


#: (capacity factor, ws_rebalance, skew) of the routing cases: tight and
#: loose capacity, with and without stealing, skewed tokens
ROUTE_CASES = [(1.0, True, 0.0), (1.0, False, 0.0), (1.25, True, 1.0),
               (0.75, True, 1.0), (64.0, False, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,rebalance,skew", ROUTE_CASES)
def test_route_group_vs_jax(dtype, cf, rebalance, skew):
    jp, pp = _params(dtype)
    x = _x((64, D), dtype, seed=2, skew=skew)
    _assert_no_near_tie(np.asarray(x.astype(jnp.float32)), jp["router"], K)
    C = pmoe.capacity(64, K, cf, E)
    want = jmoe._route_group(x, jp["router"], E, K, C, rebalance)
    got = pmoe._route_group(_t(x), pp["router"], E, K, C, rebalance)
    names = ("flat_e", "slot_c", "keep", "gates", "aux", "dropped",
             "stolen", "load")
    for name, a, b in zip(names, want, got):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        if name in ("gates", "aux"):
            np.testing.assert_allclose(_np(b), a, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    # every kept (expert, slot) holds one assignment, within capacity
    flat_e, slot_c, keep = got[0], got[1], got[2]
    kept = (flat_e * C + slot_c)[keep]
    assert len(set(kept.tolist())) == int(keep.sum())
    assert bool((slot_c[keep] < C).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rebalance", [True, False])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_apply_vs_jax(dtype, rebalance, n_groups):
    jp, pp = _params(dtype, seed=3)
    x = _x((4, 16, D), dtype, seed=4, skew=0.5)
    for g in range(n_groups):
        _assert_no_near_tie(np.asarray(x.astype(jnp.float32)).reshape(
            n_groups, -1, D)[g], jp["router"], K)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.0,
              ws_rebalance=rebalance, n_groups=n_groups)
    jy, jaux, jst = jmoe.moe_apply(jp, x, **kw)
    py, paux, pst = pmoe.moe_apply(pp, _t(x), **kw)
    assert py.dtype == _t(jy).dtype and tuple(py.shape) == jy.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(py), _np(jy), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(py), _np(jy), rtol=0,
                                   atol=2e-2 * float(np.abs(_np(jy)).max()))
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    assert float(pst.dropped) == float(jst.dropped)
    assert float(pst.stolen) == float(jst.stolen)
    np.testing.assert_allclose(float(pst.load_std), float(jst.load_std),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stealing_and_dropping_after_it_vs_jax(dtype):
    """Capacity 1.0 at T = 64 with skewed tokens: overflowing assignments
    are stolen (stolen > 0) and nothing is dropped; capacity 0.75: the free
    slots run out, so some are stolen and the rest dropped."""
    jp, pp = _params(dtype, seed=5)
    x = _x((1, 64, D), dtype, seed=6, skew=1.0)
    _assert_no_near_tie(np.asarray(x.astype(jnp.float32))[0], jp["router"],
                        K)
    seen = {}
    for cf in (1.0, 0.75):
        kw = dict(n_experts=E, top_k=K, capacity_factor=cf,
                  ws_rebalance=True)
        jy, _ja, jst = jmoe.moe_apply(jp, x, **kw)
        py, _pa, pst = pmoe.moe_apply(pp, _t(x), **kw)
        assert (float(pst.stolen), float(pst.dropped)) == \
            (float(jst.stolen), float(jst.dropped))
        seen[cf] = (float(pst.stolen), float(pst.dropped))
        tol = 1e-5 if dtype == "float32" else \
            2e-2 * float(np.abs(_np(jy)).max())
        np.testing.assert_allclose(_np(py), _np(jy), rtol=0, atol=tol)
    assert seen[1.0][0] > 0 and seen[1.0][1] == 0
    assert seen[0.75][0] > 0 and seen[0.75][1] > 0


def test_top_k_order_on_a_tie_is_the_jax_packages():
    """A token with equal probabilities (a zero input): the lower expert
    index first, as ``jax.lax.top_k``."""
    jp, pp = _params("float32")
    x = np.zeros((3, D), np.float32)
    want = jmoe._route_group(jnp.asarray(x), jp["router"], E, K, 4, True)
    got = pmoe._route_group(torch.from_numpy(x), pp["router"], E, K, 4, True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0][:2].tolist() == [0, 1]


def test_expert_ffn_vs_jax():
    jp, pp = _params("float32", seed=7)
    xb = jnp.asarray(np.random.default_rng(8).standard_normal((E, 5, D)),
                     jnp.float32)
    np.testing.assert_allclose(_np(pmoe._expert_ffn(pp, _t(xb))),
                               _np(jmoe._expert_ffn(jp, xb)),
                               atol=1e-5, rtol=1e-5)


def test_decode_sized_batch_routes_as_one_group():
    """A decode step routes B tokens of one position: capacity from B, one
    group; the layer's output keeps the input's shape and dtype."""
    _jp, pp = _params("bfloat16")
    x = _t(_x((24, 1, D), "bfloat16", seed=9))
    y, aux, st = pmoe.moe_apply(pp, x, n_experts=E, top_k=K,
                                ws_rebalance=True)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert aux.shape == () and st.dropped.shape == ()


def test_moe_bodies_are_sync_free_and_an_item_is_flagged():
    """``moe_apply``, ``moe_output``, ``_route_group`` and the helpers they
    run are in the dispatch lint's ``SYNC_FREE`` set, clean in the tree,
    and a ``.item()`` put into ``moe_apply`` (or the layer's body,
    ``_moe``) is flagged there."""
    funcs = {fn for rel, fn in dl.SYNC_FREE if rel == "models/moe.py"}
    assert {"moe_apply", "moe_output", "_moe", "_route_group", "_route",
            "_top_k", "_slots", "_route_stats"} <= funcs
    src = open(pmoe.__file__).read()
    assert dl.lint_host_sync_source(src, "moe.py", funcs) == []
    for line, symbol in (("    y, routes = _moe(", "moe_apply"),
                         ("    T = B * S\n", "_moe")):
        bad = src.replace(line, "    _ = x.sum().item()\n" + line, 1)
        assert bad != src
        found = dl.lint_host_sync_source(bad, "moe.py", funcs)
        assert [(f.rule, f.symbol) for f in found] == [("host_sync.item",
                                                        symbol)]


@pytest.mark.parametrize("rebalance", [True, False])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_output_is_moe_apply_y(rebalance, n_groups):
    """``moe_output`` (the decode step's MoE layer, no aux or statistics)
    returns exactly ``moe_apply``'s y."""
    _jp, pp = _params("bfloat16", seed=10)
    x = _t(_x((4, 16, D), "bfloat16", seed=11, skew=0.5))
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.0,
              ws_rebalance=rebalance, n_groups=n_groups)
    assert torch.equal(pmoe.moe_output(pp, x, **kw),
                       pmoe.moe_apply(pp, x, **kw)[0])


def test_decode_step_of_reduced_mixtral_neither_syncs_nor_copies():
    ops = dl.decode_step_ops(torch.device("cpu"), "mixtral-8x7b")
    assert any(op.name.startswith("aten::sort") for op in ops)
    assert not [op.name for op in ops if op.name == dl.SYNC_OP or op.to_host]


def test_decode_step_of_reduced_mixtral_computes_no_aux():
    """The decode step drops the MoE aux loss and statistics, so it runs
    none of their operations (the std of the load, the full-tensor means of
    the aux and the fractions); ``forward`` runs them."""
    ops = {op.name for op in dl.decode_step_ops(torch.device("cpu"),
                                                "mixtral-8x7b")}
    assert "aten::sort.stable" in ops
    assert not ops & {"aten::std.correction", "aten::mean"}
    cfg = get_config("mixtral-8x7b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 3), dtype=torch.int64)
    _, ops = dl.record_ops(lambda: model.forward(params, {"tokens": tokens}))
    assert {"aten::std.correction", "aten::mean"} <= {op.name for op in ops}
