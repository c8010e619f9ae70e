"""Analysis layer reproducing the paper's §4 methodology.

* theoretical Makespan bound of [Gast, Khatiri, Trystram, Wagner 2018]:
      E[Cmax] <= W/p + 4γ·λ·log2(W/λ),   4γ ≈ 16
* the *overhead ratio* (paper §4.1.2):
      overhead_ratio = 4γλ·log2(W/λ) / (sim_time − W/p)
  (paper observes 4–5.5, decreasing with p, ~independent of W)
* the fitted constant (paper finds ≈3.8):  Cmax ≈ W/p + c·λ·log2(W/λ)
* acceptable-latency analysis (paper §4.2): max λ with Cmax/(W/p) ≤ 1.1;
  the paper derives the near-linear law  W/p ≈ 470·λ.

The port's copy of the JAX package's analysis layer: the same float64
numpy operations in the same order, so that every result is equal, not
merely close. Not to be confused with :mod:`repro_torch.check` (the
runtime sanitizer), which checks the *code*; import both by their full
dotted path.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "GAMMA", "overhead_term", "makespan_bound", "overhead_ratio",
    "fitted_constant", "predicted_makespan", "theoretical_limit_latency",
    "experimental_limit_latency", "summarize",
]

GAMMA = 4.0  # paper: 4γ ≈ 16


def overhead_term(W, lam, gamma: float = GAMMA):
    """Second term of the theoretical bound: 4γ·λ·log2(W/λ)."""
    W = np.asarray(W, np.float64)
    lam = np.asarray(lam, np.float64)
    return 4.0 * gamma * lam * np.log2(np.maximum(W / lam, 2.0))


def makespan_bound(W, p, lam, gamma: float = GAMMA):
    return np.asarray(W, np.float64) / np.asarray(p, np.float64) + overhead_term(W, lam, gamma)


def overhead_ratio(sim_time, W, p, lam, gamma: float = GAMMA):
    """Paper §4.1.2. >1 means the bound over-estimates the simulated overhead."""
    sim_time = np.asarray(sim_time, np.float64)
    denom = np.maximum(sim_time - np.asarray(W, np.float64) / p, 1e-9)
    return overhead_term(W, lam, gamma) / denom


def fitted_constant(sim_time, W, p, lam):
    """Per-run constant c with Cmax = W/p + c·λ·log2(W/λ); paper fit ≈ 3.8."""
    sim_time = np.asarray(sim_time, np.float64)
    num = sim_time - np.asarray(W, np.float64) / p
    den = np.asarray(lam, np.float64) * np.log2(np.maximum(np.asarray(W, np.float64) / lam, 2.0))
    return num / np.maximum(den, 1e-9)


def predicted_makespan(W, p, lam, c: float = 3.8):
    """Paper's fitted expression W/p + 3.8·λ·log2(W/λ)."""
    W = np.asarray(W, np.float64)
    return W / p + c * np.asarray(lam, np.float64) * np.log2(np.maximum(W / lam, 2.0))


def theoretical_limit_latency(W: float, p: float, c: float = 3.8,
                              overhead: float = 0.1) -> float:
    """Solve  c·λ·log2(W/λ) = overhead·W/p  for λ (bisection; lhs monotone
    increasing for λ < W/e, which covers the paper's whole range)."""
    target = overhead * float(W) / float(p)

    def lhs(lam: float) -> float:
        return c * lam * np.log2(max(W / lam, 2.0))

    lo, hi = 1e-9, float(W) / np.e
    if lhs(hi) < target:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if lhs(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def experimental_limit_latency(makespans_by_lam: dict, W: float, p: float,
                               overhead: float = 0.1) -> float:
    """Max λ whose median simulated Cmax stays within (1+overhead)·W/p."""
    best = 0.0
    for lam, ms in sorted(makespans_by_lam.items()):
        med = float(np.median(np.asarray(ms, np.float64)))
        if med <= (1.0 + overhead) * float(W) / float(p):
            best = max(best, float(lam))
    return best


def summarize(values: Sequence[float]) -> dict:
    """Median/IQR summary used throughout the paper's boxplots."""
    v = np.asarray(values, np.float64)
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
            "n": int(v.size)}
