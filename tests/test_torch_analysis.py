"""The port's analysis layer (``repro_torch.core.analysis``) against the JAX
package's: every function on arrays and on scalars gives equal float64
results (``assert_array_equal``, no tolerance), and the paper-law cases of
``tests/test_analysis.py`` hold on the port."""
import numpy as np
import pytest

from repro.core import analysis as janalysis
from repro_torch.core import analysis

RNG = np.random.default_rng(1234)
W = np.array([10**5, 10**6, 10**7, 10**8, 3, 1000], np.int64)
P = np.array([32, 64, 128, 256, 2, 7], np.int64)
LAM = np.array([2, 62, 262, 482, 5, 1000], np.int64)
#: makespans at and around W/p, as int32 like the engine's
SIM = (W / P + RNG.integers(-5, 10**5, W.shape)).astype(np.int32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_the_public_names_are_the_jax_packages():
    assert analysis.__all__ == janalysis.__all__
    assert analysis.GAMMA == janalysis.GAMMA


@pytest.mark.parametrize("k", [None, 0, 3, 4])
def test_every_function_equals_the_jax_package(k):
    """On the whole vectors (``k=None``) and on single Python/numpy
    scalars."""
    pick = (lambda x: x) if k is None else (lambda x: x[k].item())
    w, p, lam, sim = pick(W), pick(P), pick(LAM), pick(SIM)
    for name, args in (("overhead_term", (w, lam)),
                       ("makespan_bound", (w, p, lam)),
                       ("overhead_ratio", (sim, w, p, lam)),
                       ("fitted_constant", (sim, w, p, lam)),
                       ("predicted_makespan", (w, p, lam))):
        _same(getattr(analysis, name)(*args),
              getattr(janalysis, name)(*args))
    _same(analysis.overhead_term(w, lam, gamma=3.0),
          janalysis.overhead_term(w, lam, gamma=3.0))
    _same(analysis.predicted_makespan(w, p, lam, c=4.1),
          janalysis.predicted_makespan(w, p, lam, c=4.1))


@pytest.mark.parametrize("W_, p_", [(10**5, 32), (10**6, 64), (10**7, 128),
                                    (10**8, 256), (50, 64)])
def test_limit_latencies_equal_the_jax_package(W_, p_):
    for kw in ({}, dict(c=3.0, overhead=0.2)):
        assert analysis.theoretical_limit_latency(W_, p_, **kw) == \
            janalysis.theoretical_limit_latency(W_, p_, **kw)
    by_lam = {int(lam): (W_ / p_) * (1 + RNG.random(5) * 0.2)
              for lam in (2, 10, 100, 500)}
    for ov in (0.1, 0.15):
        assert analysis.experimental_limit_latency(by_lam, W_, p_, ov) == \
            janalysis.experimental_limit_latency(by_lam, W_, p_, ov)


def test_summarize_equals_the_jax_package():
    for v in (np.arange(101, dtype=np.float64), SIM, [3.5], list(SIM[:3])):
        assert analysis.summarize(v) == janalysis.summarize(v)


# --- the paper-law cases of tests/test_analysis.py, on the port -----------

def test_bound_formula():
    b = analysis.makespan_bound(2**20, 32, 2)
    expect = 2**20 / 32 + 16 * 2 * np.log2(2**20 / 2)
    assert abs(b - expect) < 1e-6


def test_overhead_ratio_inverts_term():
    W_, p_, lam = 10**6, 64, 50
    sim_time = W_ / p_ + analysis.overhead_term(W_, lam) / 4.5
    assert abs(analysis.overhead_ratio(sim_time, W_, p_, lam) - 4.5) < 1e-9


def test_fitted_constant_roundtrip():
    W_, p_, lam, c = 10**7, 128, 100, 3.8
    sim = analysis.predicted_makespan(W_, p_, lam, c=c)
    assert abs(analysis.fitted_constant(sim, W_, p_, lam) - c) < 1e-9


def test_limit_latency_monotone_and_solves_its_equation():
    lams = [analysis.theoretical_limit_latency(w, 32)
            for w in (10**5, 10**6, 10**7)]
    assert lams[0] < lams[1] < lams[2]
    W_, p_ = 10**7, 64
    lam = analysis.theoretical_limit_latency(W_, p_)
    lhs = 3.8 * lam * np.log2(W_ / lam)
    assert abs(lhs - 0.1 * W_ / p_) / (0.1 * W_ / p_) < 1e-6


def test_paper_linear_law_shape():
    """Paper §4.2: W/p ≈ 470·λ_limit, near-linear over three decades."""
    r = np.asarray([(w / p) / analysis.theoretical_limit_latency(w, p)
                    for w, p in [(10**6, 32), (10**7, 64), (10**8, 256)]])
    assert (r > 200).all() and (r < 1200).all()
    assert r.max() / r.min() < 2.5


def test_experimental_limit_latency_and_summarize():
    W_, p_ = 10**6, 32
    data = {10: [W_ / p_ * 1.01] * 5, 100: [W_ / p_ * 1.05] * 5,
            500: [W_ / p_ * 1.5] * 5}
    assert analysis.experimental_limit_latency(data, W_, p_) == 100
    s = analysis.summarize(np.arange(101, dtype=np.float64))
    assert s["median"] == 50 and s["q1"] == 25 and s["q3"] == 75
    assert s["n"] == 101
