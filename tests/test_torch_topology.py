"""Port of ``core/topology.py``: the torch PRNG twins against the numpy twins
and the JAX package's, and the topology constructors array for array."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as JT
from repro_torch.core import topology as PT

N_STEPS = 10_000


def _start_states(seed, n=4):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 2**32, size=n, dtype=np.uint64)
    s[0] = 0xFFFFFFFF          # high bit set: a signed shift would differ
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_xorshift32_stream(seed):
    start = _start_states(seed)
    # JAX package: the whole stream in one scan
    _, jax_stream = jax.lax.scan(
        lambda s, _: (JT.xorshift32(s), JT.xorshift32(s)),
        jnp.asarray(start, jnp.uint32), None, length=N_STEPS)
    jax_stream = np.asarray(jax_stream).astype(np.int64)
    s = torch.as_tensor(start.astype(np.int64))
    port_stream = np.empty((N_STEPS, len(start)), np.int64)
    for k in range(N_STEPS):
        s = PT.xorshift32(s)
        port_stream[k] = s.numpy()
    np.testing.assert_array_equal(port_stream, jax_stream)
    # numpy twins of both packages, lane 0 (the 0xFFFFFFFF start)
    a = b = int(start[0])
    for k in range(N_STEPS):
        a, b = int(PT.np_xorshift32(a)), int(JT.np_xorshift32(b))
        assert a == b == port_stream[k, 0], k


def test_seed_state_grid():
    rng = np.random.default_rng(3)
    seeds = np.concatenate([
        np.array([0, 1, 2**31, 2**32 - 1], np.uint64),
        rng.integers(0, 2**32, size=60, dtype=np.uint64)])
    lanes = np.arange(1024, dtype=np.int64)
    got = PT.seed_state(torch.as_tensor(seeds.astype(np.int64)).unsqueeze(1),
                        torch.as_tensor(lanes).unsqueeze(0)).numpy()
    expect = np.asarray(jax.vmap(
        lambda sd: jax.vmap(lambda i: JT.seed_state(sd, i))(
            jnp.asarray(lanes, jnp.uint32)))(jnp.asarray(seeds, jnp.uint32)))
    np.testing.assert_array_equal(got, expect.astype(np.int64))
    assert got.min() >= 1 and got.max() < 2**32
    for sd in (0, 2**32 - 1, int(seeds[7])):
        for i in (0, 5, 1023):
            assert int(PT.np_seed_state(sd, i)) == int(JT.np_seed_state(sd, i))
            assert int(PT.np_seed_state(sd, i)) == got[list(seeds).index(sd), i]


CONSTRUCTORS = [
    ("one_cluster", (16, 7), {}),
    ("one_cluster", (256, 1), {}),
    ("two_clusters", (6, 9), {}),
    ("two_clusters", (64, 100), {"lam_local": 2, "split": 20}),
    ("multi_cluster", (4, 3, 7, 2, "ring"), {}),
    ("multi_cluster", (5, 2, 11), {"inter": "complete"}),
    ("multi_cluster", (4, 4, 3), {"inter": "line"}),
    ("multi_cluster", (4, 2, 5), {"inter": "star"}),
    ("tpu_fleet", (3, 4), {"dcn_delay": 40}),
]


@pytest.mark.parametrize("name,args,kw", CONSTRUCTORS,
                         ids=[f"{b[0]}-{k}" for k, b in enumerate(CONSTRUCTORS)])
def test_constructors_equal(name, args, kw):
    a = getattr(JT, name)(*args, **kw)
    b = getattr(PT, name)(*args, **kw)
    for f in ("cluster_id", "hops"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.lam_local, a.lam_remote, a.strategy, a.remote_prob, a.name) == \
        (b.lam_local, b.lam_remote, b.strategy, b.remote_prob, b.name)
    assert a.p == b.p and a.n_clusters == b.n_clusters
    np.testing.assert_array_equal(a.materialize(3, 11), b.materialize(3, 11))
    assert a.distance(0, a.p - 1) == b.distance(0, b.p - 1)
    # content hash/eq survive strategy and latency edits the same way
    b2 = b.with_strategy(PT.LOCAL_FIRST, 0.3).with_latency(2, 50)
    a2 = a.with_strategy(JT.LOCAL_FIRST, 0.3).with_latency(2, 50)
    assert (a2.strategy, a2.remote_prob, a2.lam_local, a2.lam_remote) == \
        (b2.strategy, b2.remote_prob, b2.lam_local, b2.lam_remote)
    assert b2 != b and b == getattr(PT, name)(*args, **kw)


def test_unknown_inter_cluster_network_raises():
    with pytest.raises(ValueError):
        PT.multi_cluster(3, 2, 5, inter="torus")


@pytest.mark.parametrize("prob", [0.0, 0.25, 0.3, 0.999999, 1.0])
def test_remote_prob_fixed_point(prob):
    assert PT.remote_prob_u32(prob) == JT.remote_prob_u32(prob)


def test_strategy_ids_and_names():
    for sid in (JT.UNIFORM, JT.LOCAL_FIRST, JT.INV_DISTANCE, JT.ROUND_ROBIN):
        assert PT.strategy_name(sid) == JT.strategy_name(sid)
    assert (PT.UNIFORM, PT.LOCAL_FIRST, PT.INV_DISTANCE, PT.ROUND_ROBIN) == \
        (JT.UNIFORM, JT.LOCAL_FIRST, JT.INV_DISTANCE, JT.ROUND_ROBIN)
