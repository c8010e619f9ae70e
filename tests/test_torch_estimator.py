"""The port's streaming estimators (``repro_torch.service.estimator``) against
the JAX package's (``repro.service.estimator``): the same numpy-made streams
go into both, and every field that comes out is compared with
``assert_array_equal`` — the tolerance is none. Both are numpy float64 in
the same order of operations, so the answers are the same bits."""
import dataclasses

import numpy as np
import pytest

from repro.core import sweep as jsw
from repro.service import estimator as je
from repro_torch.core import sweep as psw
from repro_torch.service import estimator as pe

CONFIDENCES = (0.5, 0.8, 0.9, 0.95, 0.975, 0.99, 0.999)


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{msg}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _eq_dataclass(a, b, msg=""):
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)], msg
    for name in fa:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, (float, int, tuple, bool)):
            assert x == y, f"{msg} {name}: {x} != {y}"
        else:
            _eq(x, y, f"{msg} {name}")


def _batches(seed, n_cells, n_batches, size, scale=50.0):
    """(cell index, makespan-like integer values) batches from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, n_cells, size=size)
        base = 1000.0 + 100.0 * idx
        vals = np.rint(base + rng.normal(0.0, scale, size=size))
        out.append((idx, vals))
    return out


@pytest.mark.parametrize("confidence", CONFIDENCES)
def test_z_value(confidence):
    assert pe.z_value(confidence) == je.z_value(confidence)


def test_z_value_refuses_what_the_reference_refuses():
    for bad in (0.0, 1.0, -0.2, 1.5):
        with pytest.raises(ValueError):
            je.z_value(bad)
        with pytest.raises(ValueError):
            pe.z_value(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_welford_stream(seed):
    jw, pw = je.Welford.zeros(5), pe.Welford.zeros(5)
    for idx, vals in _batches(seed, 5, 6, 1 + 7 * seed):
        jw.update(idx, vals)
        pw.update(idx, vals)
        _eq_dataclass(jw, pw, "welford")
        _eq(jw.var(), pw.var(), "var")
        for c in (0.9, 0.95):
            _eq(jw.half_width(c), pw.half_width(c), "half_width")
    # an empty batch is a no-op in both
    jw.update(np.zeros(0, int), np.zeros(0))
    pw.update(np.zeros(0, int), np.zeros(0))
    _eq_dataclass(jw, pw, "welford after an empty batch")


@pytest.mark.parametrize("qs", [(0.1, 0.5, 0.9), (0.25, 0.75), (0.5,)])
def test_p2_quantile_stream(qs):
    jp, pp = je.P2Quantiles.zeros(4, qs), pe.P2Quantiles.zeros(4, qs)
    for idx, vals in _batches(len(qs), 4, 8, 11, scale=200.0):
        jp.update(idx, vals)
        pp.update(idx, vals)
        _eq_dataclass(jp, pp, "p2")
        _eq(jp.quantile(), pp.quantile(), "quantile")
        _eq(jp.half_width(0.95), pp.half_width(0.95), "quantile half_width")
    with pytest.raises(ValueError):
        pe.P2Quantiles.zeros(2, (0.5, 1.0))


def _policies(pkg):
    return (
        pkg.AdaptivePolicy(ci_half_width=0.01, relative=True, batch_reps=8,
                           min_reps=8, max_reps=64),
        pkg.AdaptivePolicy(ci_half_width=12.5, confidence=0.9),
        pkg.QuantilePolicy(ci_half_width=0.05, relative=True, min_reps=16,
                           max_reps=128),
        pkg.PairedPolicy(ci_half_width=3.0, batch_reps=4, min_reps=4,
                         max_reps=32),
        pkg.PairedPolicy(),
    )


def test_policies_canonical_and_masks():
    streams = _batches(7, 3, 5, 12)
    for jpol, ppol in zip(_policies(je), _policies(pe)):
        assert jpol.canonical() == ppol.canonical()
        quant = isinstance(ppol, pe.QuantilePolicy)
        js = je.P2Quantiles.zeros(3, jpol.quantiles) if quant \
            else je.Welford.zeros(3)
        ps = pe.P2Quantiles.zeros(3, ppol.quantiles) if quant \
            else pe.Welford.zeros(3)
        for idx, vals in streams:
            js.update(idx, vals)
            ps.update(idx, vals)
            _eq(jpol.unconverged(js), ppol.unconverged(ps),
                f"{type(ppol).__name__} unconverged")
            if hasattr(ppol, "converged"):
                _eq(jpol.converged(js), ppol.converged(ps), "converged")


def test_paired_policy_stops_on_a_degenerate_difference():
    pol = pe.PairedPolicy(min_reps=2)
    w = pe.Welford.zeros(1)
    w.update(np.zeros(4, int), np.zeros(4))      # identical arms
    assert not pol.unconverged(w)[0]
    jw = je.Welford.zeros(1)
    jw.update(np.zeros(4, int), np.zeros(4))
    assert not je.PairedPolicy(min_reps=2).unconverged(jw)[0]


def test_unique_cells_first_appearance_order():
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 4, size=(40, 3))
    jc, ji = je.unique_cells(cols)
    pc, pi = pe.unique_cells(cols)
    _eq(jc, pc, "cells")
    _eq(ji, pi, "index")
    # first appearance: the first row is cell 0
    assert pi[0] == 0 and (pc[0] == cols[0]).all()


def _grids(seed, n_cells=3, reps=9, p=4, overflow_every=0, theta_b=None):
    """A JAX and a port GridResult holding the same numpy columns."""
    rng = np.random.default_rng(seed)
    n = n_cells * reps
    W = np.repeat(np.arange(1, n_cells + 1, dtype=np.int32) * 1000, reps)
    lam = np.full(n, 2, np.int32)
    ts = np.zeros(n, np.int32)
    tc = np.zeros(n, np.int32) if theta_b is None \
        else np.full(n, theta_b, np.int32)
    ms = (W // p + rng.integers(0, 60, size=n)).astype(np.int32)
    ovf = np.zeros(n, bool)
    if overflow_every:
        ovf[::overflow_every] = True
    cols = dict(W=W, lam=lam, theta_static=ts, theta_comm=tc,
                seed=np.arange(n, dtype=np.uint32) * 7 + 1, makespan=ms,
                n_requests=np.full(n, 5, np.int32),
                n_success=np.full(n, 3, np.int32),
                n_fail=np.full(n, 2, np.int32),
                total_idle=np.zeros(n, np.int32),
                startup_end=np.zeros(n, np.int32), overflow=ovf)
    extras = {"lam_local": lam.copy(),
              "n_events": rng.integers(10, 99, size=n).astype(np.int32)}
    return (jsw.GridResult(p=p, extras=dict(extras), **cols),
            psw.GridResult(p=p, extras=dict(extras), **cols))


@pytest.mark.parametrize("overflow_every", [0, 4, 1])
def test_summarize_cells_with_overflow_rows(overflow_every):
    jg, pg = _grids(overflow_every, overflow_every=overflow_every)
    jc, ji = je.cell_index(jg)
    pc, pi = pe.cell_index(pg)
    _eq(jc, pc, "cell_index cells")
    _eq(ji, pi, "cell_index index")
    for conf, qs in ((0.95, je.DEFAULT_QUANTILES), (0.9, (0.25, 0.75))):
        jt = je.summarize_cells(jg, conf, qs)
        pt = pe.summarize_cells(pg, conf, qs)
        _eq_dataclass(jt, pt, f"CellTable overflow_every={overflow_every}")
        assert len(pt) == len(jt) == 3
        for q in pt.quantile_fracs:
            _eq(jt.quantile(q), pt.quantile(q), "CellTable.quantile")
    if overflow_every == 4:
        assert (pt.n_overflow > 0).all() and (pt.n < 9).all()
    with pytest.raises(KeyError):
        pt.quantile(0.33)


def test_paired_summary():
    ja, pa = _grids(11)
    jb, pb = _grids(12, theta_b=2)
    ja.overflow[3] = pa.overflow[3] = True       # dropped pairwise
    jp = je.paired_summary(ja, jb, 0.95)
    pp = pe.paired_summary(pa, pb, 0.95)
    _eq_dataclass(jp, pp, "PairedCells")
    _eq(jp.significant, pp.significant, "significant")
    _eq(jp.faster, pp.faster, "faster")
    _eq(jp.independent_half_width(), pp.independent_half_width(),
        "independent_half_width")
    assert int(pp.theta_comm_b[0]) == 2 and int(pp.n[0]) == 8
    # the arms must run the same workload rows
    _, other = _grids(13)
    other.seed[0] += 1
    with pytest.raises(ValueError, match="seed"):
        pe.paired_summary(pa, other)


@pytest.mark.parametrize("std,hw,conf", [(8.0, 1.0, 0.95), (3.5, 0.25, 0.99),
                                         (0.1, 5.0, 0.9)])
def test_fixed_reps_for_width(std, hw, conf):
    assert pe.fixed_reps_for_width(std, hw, conf) == \
        je.fixed_reps_for_width(std, hw, conf)
    with pytest.raises(ValueError):
        pe.fixed_reps_for_width(std, 0.0)
