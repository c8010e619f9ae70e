"""Streaming Monte-Carlo estimation.

The paper reports distributional statistics of Cmax over fixed-size
Monte-Carlo ensembles ("1000 simulations per point"). Following the latency
analysis of Gast–Khatiri–Trystram, the service instead treats each grid cell
as a streaming estimation problem: a Welford/Chan accumulator maintains mean
and variance of the makespan per cell, a normal-approximation confidence
interval is attached to the running mean, and *adaptive replication* keeps
submitting fresh seed batches through the batched core only for cells whose
CI half-width still exceeds the requested target. Easy cells (low variance —
e.g. low λ, big W/p) stop after ``min_reps``; hard cells get the replication
budget a fixed-``reps`` sweep would have wasted uniformly.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.sweep import GridResult


def z_value(confidence: float) -> float:
    """Two-sided normal quantile z with P(|Z| <= z) = confidence.

    Acklam's rational approximation of the inverse normal CDF (|rel err| <
    1.2e-9) — keeps the estimator dependency-free and deterministic.
    """
    p = 0.5 + 0.5 * float(confidence)
    if not 0.5 < p < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    if p < 0.97575:
        q = p - 0.5
        r = q * q
        num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
        den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
        return num * q / den
    q = math.sqrt(-2.0 * math.log(1.0 - p))
    num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
    den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
    return -num / den    # upper tail: the c/d rational gives the lower tail


@dataclasses.dataclass
class Welford:
    """Vectorized Welford accumulator over a fixed set of cells, merged
    batch-at-a-time with Chan's parallel-update formula."""
    n: np.ndarray       # int64[cells]
    mean: np.ndarray    # float64[cells]
    m2: np.ndarray      # float64[cells]

    @classmethod
    def zeros(cls, n_cells: int) -> "Welford":
        return cls(n=np.zeros(n_cells, np.int64),
                   mean=np.zeros(n_cells, np.float64),
                   m2=np.zeros(n_cells, np.float64))

    def update(self, cell_idx: np.ndarray, values: np.ndarray):
        """Fold ``values`` (grouped by ``cell_idx``) into the accumulator.

        Fully vectorized: one stable argsort groups the batch by cell, one
        ``reduceat`` per moment computes each group's sub-mean/sub-M2, and
        Chan's merge folds every group in simultaneously — no per-cell
        Python loop.
        """
        cell_idx = np.asarray(cell_idx, np.intp).ravel()
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        order = np.argsort(cell_idx, kind="stable")
        ci = cell_idx[order]
        x = values[order]
        cells, starts = np.unique(ci, return_index=True)
        nb = np.diff(np.append(starts, ci.size))
        mb = np.add.reduceat(x, starts) / nb
        m2b = np.add.reduceat((x - np.repeat(mb, nb)) ** 2, starts)
        na = self.n[cells]
        delta = mb - self.mean[cells]
        n = na + nb
        self.mean[cells] += delta * nb / n
        self.m2[cells] += m2b + delta * delta * na * nb / n
        self.n[cells] = n

    def var(self) -> np.ndarray:
        """Unbiased sample variance; NaN below two samples."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self.n > 1, self.m2 / np.maximum(self.n - 1, 1),
                            np.nan)

    def half_width(self, confidence: float = 0.95) -> np.ndarray:
        """Normal-approx CI half-width of the mean; inf below two samples."""
        with np.errstate(invalid="ignore", divide="ignore"):
            hw = z_value(confidence) * np.sqrt(self.var() / np.maximum(self.n, 1))
        return np.where(self.n > 1, hw, np.inf)


#: Quantile fractions every cell summary tracks by default (the paper's
#: boxplot-style median + decile whiskers).
DEFAULT_QUANTILES = (0.1, 0.5, 0.9)


@dataclasses.dataclass
class P2Quantiles:
    """Vectorized streaming P² quantile estimator (Jain–Chlamtac 1985) over a
    fixed set of cells × quantile fractions.

    Each (cell, quantile) pair maintains the classic five markers (heights +
    positions); the first five observations of a cell are buffered and sorted
    into the initial markers. Updates are vectorized across every cell and
    quantile at once — a batch of B observations per cell costs O(B) small
    numpy steps regardless of the number of cells — so the estimator holds
    O(cells × quantiles) state instead of the full ensemble.
    """
    qs: np.ndarray       # float64[nq] quantile fractions
    n: np.ndarray        # int64[cells] observations folded in per cell
    buf: np.ndarray      # float64[cells, 5] first-five buffer
    h: np.ndarray        # float64[cells, nq, 5] marker heights
    pos: np.ndarray      # float64[cells, nq, 5] marker positions (1-based)

    @classmethod
    def zeros(cls, n_cells: int, qs=DEFAULT_QUANTILES) -> "P2Quantiles":
        qs = np.asarray(sorted(float(q) for q in qs), np.float64)
        if qs.size == 0 or (qs <= 0).any() or (qs >= 1).any():
            raise ValueError(f"quantile fractions must be in (0,1): {qs}")
        nq = qs.shape[0]
        return cls(qs=qs,
                   n=np.zeros(n_cells, np.int64),
                   buf=np.zeros((n_cells, 5), np.float64),
                   h=np.zeros((n_cells, nq, 5), np.float64),
                   pos=np.zeros((n_cells, nq, 5), np.float64))

    @property
    def _dn(self) -> np.ndarray:
        """Desired-position increments per marker: [0, q/2, q, (1+q)/2, 1]."""
        q = self.qs[:, None]
        return np.concatenate(
            [np.zeros_like(q), q / 2, q, (1 + q) / 2, np.ones_like(q)],
            axis=1)                                     # [nq, 5]

    def update(self, cell_idx: np.ndarray, values: np.ndarray):
        """Fold a batch of observations (grouped by ``cell_idx``) in, keeping
        each cell's per-observation order (P² estimates are order-dependent,
        so a round-by-round stream and a one-shot replay of the concatenated
        ensemble produce identical markers)."""
        cell_idx = np.asarray(cell_idx, np.intp).ravel()
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        order = np.argsort(cell_idx, kind="stable")
        ci = cell_idx[order]
        x = values[order]
        _, starts, counts = np.unique(ci, return_index=True,
                                      return_counts=True)
        offs = np.arange(ci.size) - np.repeat(starts, counts)
        for k in range(int(counts.max())):
            sel = offs == k
            self._step(ci[sel], x[sel])

    def _step(self, cells: np.ndarray, x: np.ndarray):
        """One observation for each of a set of *distinct* cells."""
        n_prev = self.n[cells]
        self.n[cells] = n_prev + 1
        # --- init phase: buffer the first five, then sort into markers.
        init = n_prev < 5
        if init.any():
            ic, ix, ip = cells[init], x[init], n_prev[init]
            self.buf[ic, ip] = ix
            full = ip == 4
            if full.any():
                fc = ic[full]
                srt = np.sort(self.buf[fc], axis=1)      # [m, 5]
                nq = self.qs.shape[0]
                self.h[fc] = np.repeat(srt[:, None, :], nq, axis=1)
                self.pos[fc] = np.arange(1.0, 6.0)
        # --- steady phase: classic P² marker update, vectorized.
        steady = ~init
        if not steady.any():
            return
        sc = cells[steady]
        xm = x[steady][:, None]                          # [m, 1]
        hh = self.h[sc]                                  # [m, nq, 5]
        pp = self.pos[sc]
        xq = xm[..., None]                               # [m, 1, 1]
        # Interval k in {0..3}: h[k] <= x < h[k+1]; extremes clamp markers.
        below = xq[..., 0] < hh[..., 0]
        above = xq[..., 0] >= hh[..., 4]
        hh[..., 0] = np.where(below, xq[..., 0], hh[..., 0])
        hh[..., 4] = np.where(above, xq[..., 0], hh[..., 4])
        k = np.clip((xq >= hh).sum(-1) - 1, 0, 3)        # [m, nq]
        # Markers strictly above interval k shift one position right.
        pp += np.arange(5) > k[..., None]
        n_new = (n_prev[steady] + 1).astype(np.float64)[:, None, None]
        desired = 1.0 + (n_new - 1.0) * self._dn         # [m, nq, 5]
        with np.errstate(invalid="ignore", divide="ignore"):
            for i in (1, 2, 3):
                di = desired[..., i] - pp[..., i]
                up = (di >= 1.0) & (pp[..., i + 1] - pp[..., i] > 1.0)
                dn = (di <= -1.0) & (pp[..., i - 1] - pp[..., i] < -1.0)
                s = np.where(up, 1.0, np.where(dn, -1.0, 0.0))
                active = s != 0.0
                if not active.any():
                    continue
                dp_r = pp[..., i + 1] - pp[..., i]
                dp_l = pp[..., i] - pp[..., i - 1]
                dh_r = hh[..., i + 1] - hh[..., i]
                dh_l = hh[..., i] - hh[..., i - 1]
                hp = hh[..., i] + s / (pp[..., i + 1] - pp[..., i - 1]) * (
                    (dp_l + s) * dh_r / dp_r + (dp_r - s) * dh_l / dp_l)
                mono = (hh[..., i - 1] < hp) & (hp < hh[..., i + 1])
                # Non-monotone parabolic prediction -> linear fallback
                # toward the neighbor in the move direction.
                h_nb = np.where(s > 0, hh[..., i + 1], hh[..., i - 1])
                p_nb = np.where(s > 0, pp[..., i + 1], pp[..., i - 1])
                hl = hh[..., i] + s * (h_nb - hh[..., i]) / (p_nb - pp[..., i])
                h_new = np.where(mono, hp, hl)
                hh[..., i] = np.where(active, h_new, hh[..., i])
                pp[..., i] = pp[..., i] + np.where(active, s, 0.0)
        self.h[sc] = hh
        self.pos[sc] = pp

    def quantile(self) -> np.ndarray:
        """Current estimates, float64[cells, nq]. Cells still in the init
        phase fall back to the exact quantile of their buffer; empty cells
        are NaN."""
        out = np.full((self.n.shape[0], self.qs.shape[0]), np.nan)
        steady = self.n >= 5
        out[steady] = self.h[steady][..., 2]
        for c in np.nonzero(~steady & (self.n > 0))[0]:
            out[c] = np.quantile(self.buf[c, : self.n[c]], self.qs)
        return out

    def half_width(self, confidence: float = 0.95) -> np.ndarray:
        """Asymptotic CI half-width of each quantile estimate,
        float64[cells, nq]: z·sqrt(q(1-q)/n) / f̂, with the density at the
        quantile estimated from the flanking P² markers at fractions q/2 and
        (1+q)/2: f̂ ≈ 0.5 / (h[3] - h[1]). Inf until the markers exist
        (n < 5)."""
        z = z_value(confidence)
        n = np.maximum(self.n, 1).astype(np.float64)[:, None]
        spread = self.h[..., 3] - self.h[..., 1]         # [cells, nq]
        hw = z * np.sqrt(self.qs * (1.0 - self.qs) / n) * 2.0 * spread
        return np.where((self.n >= 5)[:, None], hw, np.inf)


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """Adaptive-stopping criterion: replicate until the CI half-width of the
    mean makespan is below ``ci_half_width`` in every cell (absolute units,
    or a fraction of the running mean when ``relative``)."""
    ci_half_width: float
    relative: bool = False
    confidence: float = 0.95
    batch_reps: int = 16          # fresh seeds per round per pending cell
    min_reps: int = 8             # floor before the variance is trusted
    max_reps: int = 1024          # per-cell hard budget cap

    def canonical(self) -> dict:
        """JSON-able form for store keying (float targets are rounded to a
        fixed decimal encoding so keys never depend on repr vagaries)."""
        return {
            "kind": "adaptive",
            "ci_half_width": f"{float(self.ci_half_width):.9e}",
            "relative": bool(self.relative),
            "confidence": f"{float(self.confidence):.9e}",
            "batch_reps": int(self.batch_reps),
            "min_reps": int(self.min_reps),
            "max_reps": int(self.max_reps),
        }

    def unconverged(self, w: Welford) -> np.ndarray:
        """Bool mask of cells that still need replication this round."""
        hw = w.half_width(self.confidence)
        target = self.ci_half_width * (np.abs(w.mean) if self.relative
                                       else 1.0)
        need = (w.n < self.min_reps) | (hw > target)
        return need & (w.n < self.max_reps)

    def converged(self, w: Welford) -> np.ndarray:
        hw = w.half_width(self.confidence)
        target = self.ci_half_width * (np.abs(w.mean) if self.relative
                                       else 1.0)
        return (w.n >= self.min_reps) & (hw <= target)


@dataclasses.dataclass(frozen=True)
class QuantilePolicy:
    """Quantile-targeted stopping rule: replicate until every tracked
    quantile's CI half-width is below ``ci_half_width`` in every cell
    (absolute, or a fraction of the quantile estimate when ``relative``).
    The paper reports medians/boxplots, and the Gast–Khatiri–Trystram
    latency analysis motivates tail estimates — this is the stopping rule
    that serves them with a guarantee instead of a fixed rep count."""
    ci_half_width: float
    quantiles: tuple = DEFAULT_QUANTILES
    relative: bool = False
    confidence: float = 0.95
    batch_reps: int = 16
    min_reps: int = 16            # P² markers need a few batches to settle
    max_reps: int = 4096

    def canonical(self) -> dict:
        return {
            "kind": "quantile",
            "ci_half_width": f"{float(self.ci_half_width):.9e}",
            "quantiles": [f"{float(q):.9e}" for q in sorted(self.quantiles)],
            "relative": bool(self.relative),
            "confidence": f"{float(self.confidence):.9e}",
            "batch_reps": int(self.batch_reps),
            "min_reps": int(self.min_reps),
            "max_reps": int(self.max_reps),
        }

    def _need(self, p2: P2Quantiles) -> np.ndarray:
        hw = p2.half_width(self.confidence)
        target = self.ci_half_width * (np.abs(p2.quantile()) if self.relative
                                       else 1.0)
        with np.errstate(invalid="ignore"):
            wide = hw > target
        return (p2.n < self.min_reps) | wide.any(axis=1)

    def unconverged(self, p2: P2Quantiles) -> np.ndarray:
        """Bool mask of cells that still need replication this round."""
        return self._need(p2) & (p2.n < self.max_reps)

    def converged(self, p2: P2Quantiles) -> np.ndarray:
        return (p2.n >= self.min_reps) & ~self._need(p2)


@dataclasses.dataclass(frozen=True)
class PairedPolicy:
    """Stopping rule for paired (common-random-numbers) A/B policy queries:
    replicate until the CI on the mean per-seed makespan *difference* either
    excludes zero (a significant verdict, when ``stop_when_significant``) or
    is narrower than ``ci_half_width`` (absolute units; 0 disables the width
    criterion and stops on significance / ``max_reps`` only)."""
    ci_half_width: float = 0.0
    stop_when_significant: bool = True
    confidence: float = 0.95
    batch_reps: int = 16
    min_reps: int = 8
    max_reps: int = 2048

    def canonical(self) -> dict:
        return {
            "kind": "paired",
            "ci_half_width": f"{float(self.ci_half_width):.9e}",
            "stop_when_significant": bool(self.stop_when_significant),
            "confidence": f"{float(self.confidence):.9e}",
            "batch_reps": int(self.batch_reps),
            "min_reps": int(self.min_reps),
            "max_reps": int(self.max_reps),
        }

    def unconverged(self, w: "Welford") -> np.ndarray:
        """``w`` is the Welford accumulator over per-seed deltas ΔCmax."""
        hw = w.half_width(self.confidence)
        narrow = (hw <= self.ci_half_width) if self.ci_half_width > 0 \
            else np.zeros(w.n.shape, bool)
        sig = (np.abs(w.mean) > hw) if self.stop_when_significant \
            else np.zeros(w.n.shape, bool)
        # Zero observed difference variance with zero mean (identical arms,
        # e.g. a policy compared against itself): no amount of replication
        # adds information — stop instead of spinning to max_reps.
        degenerate = (hw == 0.0) & (w.mean == 0.0)
        done = (w.n >= self.min_reps) & (narrow | sig | degenerate)
        return ~done & (w.n < self.max_reps)


@dataclasses.dataclass
class CellTable:
    """Per-cell summary of a GridResult: one row per unique
    (W, lam_local, lam_remote, theta) cell, in order of first appearance."""
    W: np.ndarray
    lam_local: np.ndarray
    lam_remote: np.ndarray
    theta_static: np.ndarray
    theta_comm: np.ndarray
    n: np.ndarray             # valid (non-overflow) samples
    n_overflow: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    half_width: np.ndarray
    median: np.ndarray
    confidence: float
    quantile_fracs: tuple     # tracked fractions, e.g. (0.1, 0.5, 0.9)
    quantiles: np.ndarray     # float64[cells, nq] streaming P² estimates
    quantile_hw: np.ndarray   # float64[cells, nq] asymptotic CI half-widths

    def __len__(self):
        return int(self.W.shape[0])

    def quantile(self, q: float) -> np.ndarray:
        """Column of streaming P² estimates for tracked fraction ``q``."""
        for j, f in enumerate(self.quantile_fracs):
            if abs(f - q) < 1e-12:
                return self.quantiles[:, j]
        raise KeyError(f"quantile {q} not tracked; have {self.quantile_fracs}")


def unique_cells(cols: np.ndarray):
    """(unique rows of ``cols`` in first-appearance order, per-row cell
    index). The single definition of cell identity/ordering — the broker's
    round bookkeeping and the estimator's summaries must agree on it, so
    both call this."""
    _, first, inv = np.unique(cols, axis=0, return_index=True,
                              return_inverse=True)
    # np.unique sorts; remap to first-appearance order.
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return cols[np.sort(first)], rank[inv]


def cell_index(grid: GridResult):
    """Cell identity columns (W, λ_local, λ_remote, θs, θc) of a GridResult."""
    lam_local = grid.extras.get("lam_local", grid.lam)
    cols = np.stack([grid.W, lam_local, grid.lam,
                     grid.theta_static, grid.theta_comm], axis=1)
    return unique_cells(cols)


def summarize_cells(grid: GridResult, confidence: float = 0.95,
                    quantiles=DEFAULT_QUANTILES) -> CellTable:
    """Fold a (possibly multi-round) GridResult into per-cell statistics.

    Overflow rows (hit ``max_events`` / capacity halt) carry no valid
    makespan; they are excluded from the estimate and counted separately.
    Fully vectorized (argsort + segment reductions — no per-cell Python
    loop): the exact median comes from one lexsort, mean/CI from the
    vectorized Welford, and the ``quantiles`` columns from the streaming P²
    estimator replayed over the ensemble in grid order — so a cached grid
    and a round-by-round adaptive run summarize identically.
    """
    cells, inv = cell_index(grid)
    k = cells.shape[0]
    ok = ~np.asarray(grid.overflow, bool)
    ms = np.asarray(grid.makespan, np.float64)
    w = Welford.zeros(k)
    w.update(inv[ok], ms[ok])
    p2 = P2Quantiles.zeros(k, quantiles)
    p2.update(inv[ok], ms[ok])
    n_overflow = np.bincount(inv[~ok], minlength=k).astype(np.int64)
    # Exact per-cell median in one lexsort: within each cell's sorted run of
    # length m, the median is the mean of elements (m-1)//2 and m//2.
    median = np.full(k, np.nan)
    iv, mv = inv[ok], ms[ok]
    order = np.lexsort((mv, iv))
    sv = mv[order]
    counts = np.bincount(iv, minlength=k)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    nz = counts > 0
    lo = starts[nz] + (counts[nz] - 1) // 2
    hi = starts[nz] + counts[nz] // 2
    median[nz] = 0.5 * (sv[lo] + sv[hi])
    std = np.sqrt(w.var())
    return CellTable(
        W=cells[:, 0], lam_local=cells[:, 1], lam_remote=cells[:, 2],
        theta_static=cells[:, 3], theta_comm=cells[:, 4],
        n=w.n, n_overflow=n_overflow, mean=w.mean, std=std,
        half_width=w.half_width(confidence), median=median,
        confidence=float(confidence),
        quantile_fracs=tuple(float(q) for q in sorted(quantiles)),
        quantiles=p2.quantile(), quantile_hw=p2.half_width(confidence),
    )


@dataclasses.dataclass
class PairedCells:
    """Per-cell paired-difference summary of two CRN-aligned GridResults:
    Δ = Cmax_A − Cmax_B per shared seed, so the common noise cancels and the
    CI on E[Δ] shrinks with the *difference* variance — what makes small
    policy gaps resolvable at low rep counts. The workload columns (W, λ)
    are shared; the θ thresholds are part of each arm's *policy* and may
    differ, so both arms' columns are carried."""
    W: np.ndarray
    lam_local: np.ndarray
    lam_remote: np.ndarray
    theta_static_a: np.ndarray
    theta_comm_a: np.ndarray
    theta_static_b: np.ndarray
    theta_comm_b: np.ndarray
    n: np.ndarray             # valid pairs (both arms non-overflow)
    mean_a: np.ndarray
    mean_b: np.ndarray
    delta_mean: np.ndarray    # E[Cmax_A - Cmax_B] per cell
    delta_std: np.ndarray
    delta_half_width: np.ndarray
    var_a: np.ndarray         # per-arm variances (independent-arms baseline)
    var_b: np.ndarray
    confidence: float

    def __len__(self):
        return int(self.W.shape[0])

    @property
    def significant(self) -> np.ndarray:
        """Cells whose difference CI excludes zero."""
        return np.abs(self.delta_mean) > self.delta_half_width

    @property
    def faster(self) -> np.ndarray:
        """Per-cell verdict: -1 = A faster, +1 = B faster, 0 = unresolved."""
        return np.where(self.significant,
                        np.sign(self.delta_mean), 0.0).astype(np.int8)

    def independent_half_width(self) -> np.ndarray:
        """CI half-width the same ``n`` would give with *independent* arms
        (var_a + var_b instead of the paired difference variance) — the
        baseline the CRN pairing is judged against."""
        with np.errstate(invalid="ignore", divide="ignore"):
            hw = z_value(self.confidence) * np.sqrt(
                (self.var_a + self.var_b) / np.maximum(self.n, 1))
        return np.where(self.n > 1, hw, np.inf)


def paired_summary(grid_a: GridResult, grid_b: GridResult,
                   confidence: float = 0.95) -> PairedCells:
    """Fold two row-aligned GridResults (same workload rows, same seeds:
    common random numbers; each arm's own θ policy) into per-cell
    paired-difference statistics. Rows where either arm overflowed are
    dropped pairwise."""
    for f in ("W", "lam", "seed"):
        if not np.array_equal(getattr(grid_a, f), getattr(grid_b, f)):
            raise ValueError(f"paired grids disagree on {f}; arms must run "
                             "the same workload rows (CRN)")
    cells, inv = cell_index(grid_a)
    cells_b, inv_b = cell_index(grid_b)
    if not (np.array_equal(inv, inv_b)
            and np.array_equal(cells[:, :3], cells_b[:, :3])):
        raise ValueError("paired grids' cell structures do not align")
    k = cells.shape[0]
    ok = ~(np.asarray(grid_a.overflow, bool) | np.asarray(grid_b.overflow,
                                                          bool))
    ms_a = np.asarray(grid_a.makespan, np.float64)
    ms_b = np.asarray(grid_b.makespan, np.float64)
    wd = Welford.zeros(k)
    wd.update(inv[ok], ms_a[ok] - ms_b[ok])
    wa, wb = Welford.zeros(k), Welford.zeros(k)
    wa.update(inv[ok], ms_a[ok])
    wb.update(inv[ok], ms_b[ok])
    return PairedCells(
        W=cells[:, 0], lam_local=cells[:, 1], lam_remote=cells[:, 2],
        theta_static_a=cells[:, 3], theta_comm_a=cells[:, 4],
        theta_static_b=cells_b[:, 3], theta_comm_b=cells_b[:, 4],
        n=wd.n, mean_a=wa.mean, mean_b=wb.mean,
        delta_mean=wd.mean, delta_std=np.sqrt(wd.var()),
        delta_half_width=wd.half_width(confidence),
        var_a=wa.var(), var_b=wb.var(),
        confidence=float(confidence),
    )


def fixed_reps_for_width(std: float, half_width: float,
                         confidence: float = 0.95) -> int:
    """Replications a fixed-``reps`` sweep needs for the same CI width — the
    baseline the adaptive estimator is judged against in the
    ``service_throughput`` bench: n >= (z·σ / h)²."""
    if half_width <= 0:
        raise ValueError("half_width must be positive")
    z = z_value(confidence)
    return max(int(math.ceil((z * float(std) / float(half_width)) ** 2)), 2)
