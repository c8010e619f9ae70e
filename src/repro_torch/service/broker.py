"""Query broker: coalescing concurrent sweep questions.

Many callers ask the simulator small questions at once (the planner alone
asks one per policy combination). Dispatching each as its own device program
wastes the batched core. The broker instead:

1. answers every query it can from the content-addressed store;
2. takes a best-effort advisory file lock per remaining key (``<key>.lock``
   in the store root, stale after a timeout): of N *processes* issuing the
   identical query, one computes while the rest poll the store and serve
   the freshly landed artifact — cross-process in-flight dedup on top of
   the in-flush aliasing;
3. groups the remaining queries into *buckets* of identical static
   configuration — the same canonical task-model config (topology, strategy,
   MWT, caps), the same ``remote_prob`` scalar and the same execution
   *backend* — because only static config forces a separate kernel
   launch; everything else (W, λ, θ, seed) is a per-row scenario
   field. Buckets are keyed by the *canonical model form*, not object
   identity, so structurally identical models built by different callers
   coalesce too. Under ``relax_max_events`` (the default) ``max_events`` is
   dropped from the bucket key: members' static caps are *relaxed* to the
   bucket's shared pow2 upper bound at dispatch, while each member's rows
   carry their original cap as a per-row event budget
   (``Scenario.max_events``) that truncates the loop in-engine — so every
   row, overflow columns included, is bit-identical to its unrelaxed run
   and stored results/keys stay byte-identical to the unrelaxed path;
4. concatenates every bucket's pending rows into ONE batched sweep, padded
   to the next power of two (padding rows are W=1 scenarios, which
   terminate immediately; pow-2 padding bounds the number of distinct batch
   shapes), and dispatches it through ``core/sweep`` on the bucket's
   backend (``repro_torch.core.backend``) on the broker's device;
5. fans the per-row results back to each query, rounds the adaptive
   estimator, and persists each finished answer in the store. All backends
   are bit-identical, so store keys carry no backend component: a fill
   from any backend serves every other.

The broker follows the device rule: it runs on the card unless it is built
with ``device="cpu"``, and a query that names no backend is bucketed on the
backend that device auto-selects (``cuda`` on the card, ``torch`` on the
CPU). A dispatch on the card never gives way to the plain loop or to the
host (``resilience.fallback_chain``).

Adaptive queries participate in the same rounds: round r of every pending
query lands in the same bucket dispatch, so N concurrent adaptive queries
still cost one device program per (bucket, round). Paired A/B queries
(:class:`PairedQuery`) submit both arms' rows — the *same* rows, so the
arms share seeds (common random numbers) — into their arms' buckets each
round, and replicate until the CI on the per-seed makespan difference
answers "is policy A faster" (see ``estimator.PairedPolicy``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.check import sanitizer as san
from repro_torch.core import backend as bk
from repro_torch.service import resilience as rz
from repro_torch.core import engine as eng
from repro_torch.core.sweep import (GridResult, GridRows, canonical_grid,
                                    concat_grids, grid_rows, run_rows)
from repro_torch.core.topology import remote_prob_u32
from repro_torch.service import store as store_mod
from repro_torch.service.estimator import (AdaptivePolicy, CellTable,
                                           P2Quantiles, PairedCells,
                                           PairedPolicy, QuantilePolicy,
                                           Welford, cell_index,
                                           paired_summary, summarize_cells,
                                           unique_cells)
from repro_torch.service.store import ResultStore

#: Stopping rules a SimQuery may carry (None = fixed ``reps`` ensemble).
StoppingPolicy = Union[AdaptivePolicy, QuantilePolicy]

#: A flush waiting on another process's lock polls the store with
#: decorrelated jitter from LOCK_POLL_S up to LOCK_POLL_CAP_S seconds, so N
#: waiters on a hot key spread out instead of stat()ing the store in phase.
LOCK_POLL_S = 0.05
LOCK_POLL_CAP_S = 0.5


@dataclasses.dataclass(frozen=True)
class SimQuery:
    """One sweep question: a task model + a scenario grid + a stopping rule.

    ``reps`` is the fixed ensemble size when ``adaptive`` is None; with an
    :class:`AdaptivePolicy` (CI target on E[Cmax]) or a
    :class:`QuantilePolicy` (CI target on streaming quantiles) it is ignored
    and replication is driven by the statistical target instead.

    ``backend`` names the execution substrate (``repro_torch.core.backend``);
    None lets the broker auto-select by its device (env override, else
    ``cuda`` on the card and ``torch`` on the CPU). The backend is
    deliberately NOT part of :meth:`key`: all backends are bit-identical,
    so a cached answer computed by any backend serves every other.
    """
    model: eng.TaskModel
    W_list: Tuple[int, ...] = (0,)
    lam_list: Tuple = (1,)
    theta: Tuple[Tuple[int, int], ...] = ((0, 0),)
    reps: int = 16
    seed0: int = 1
    remote_prob: float = 0.25
    adaptive: Optional[StoppingPolicy] = None
    backend: Optional[str] = None

    def grid_dict(self) -> dict:
        reps = self.adaptive.batch_reps if self.adaptive else self.reps
        return canonical_grid(self.W_list, self.lam_list, reps,
                              theta=self.theta, seed0=self.seed0,
                              remote_prob=self.remote_prob)

    def key(self) -> str:
        extra = {"adaptive": self.adaptive.canonical()} if self.adaptive \
            else None
        return store_mod.query_key(self.model, self.grid_dict(), extra=extra)

    @property
    def n_cells(self) -> int:
        return len(self.W_list) * len(self.lam_list) * len(self.theta)


@dataclasses.dataclass(frozen=True)
class PairedQuery:
    """A/B policy comparison under common random numbers: both arms run the
    *same* scenario rows (same cells, same seeds), so the per-seed makespan
    difference cancels the shared Monte-Carlo noise and small policy gaps
    become resolvable at low rep counts.

    The arms are two :class:`SimQuery` over the same grid (models and
    ``remote_prob`` may differ — that is the policy under test); their own
    ``adaptive`` must be None, because replication is driven by the pair's
    :class:`PairedPolicy` (or one fixed round of ``a.reps`` when None).
    Each arm carries its own ``backend`` field (normally equal; they may
    differ — backends are bit-identical, so the CRN pairing is unaffected).
    """
    a: SimQuery
    b: SimQuery
    policy: Optional[PairedPolicy] = None

    def __post_init__(self):
        for f in ("W_list", "lam_list", "reps", "seed0"):
            if getattr(self.a, f) != getattr(self.b, f):
                raise ValueError(f"paired arms disagree on {f}; CRN needs "
                                 "identical workload rows")
        # θ is part of the *policy*, so the arms' thresholds may differ —
        # but cell k of arm A pairs with cell k of arm B, so the θ axes
        # must have equal length.
        if len(self.a.theta) != len(self.b.theta):
            raise ValueError("paired arms need θ axes of equal length "
                             f"({len(self.a.theta)} vs {len(self.b.theta)})")
        if self.a.adaptive is not None or self.b.adaptive is not None:
            raise ValueError("paired arms must not carry their own adaptive "
                             "policy; use PairedQuery(policy=...)")

    def _arm_grid(self, arm: SimQuery) -> dict:
        reps = self.policy.batch_reps if self.policy else self.a.reps
        return canonical_grid(arm.W_list, arm.lam_list, reps,
                              theta=arm.theta, seed0=arm.seed0,
                              remote_prob=arm.remote_prob)

    def arm_keys(self) -> Tuple[str, str]:
        """Store keys of the two arm grids. With no policy the arms are
        plain fixed-reps sweeps and share keys (and cached answers) with
        solo queries; with a PairedPolicy the replication pattern depends on
        the *pair* (which cells' deltas converged), so the key carries the
        policy and the other arm's model digest."""
        if self.policy is None:
            return self.a.key(), self.b.key()
        da = store_mod.model_digest(self.a.model)
        db = store_mod.model_digest(self.b.model)
        extra_a = {"paired": self.policy.canonical(), "other_model": db,
                   "other_rp_u32": remote_prob_u32(float(self.b.remote_prob))}
        extra_b = {"paired": self.policy.canonical(), "other_model": da,
                   "other_rp_u32": remote_prob_u32(float(self.a.remote_prob))}
        return (store_mod.query_key(self.a.model, self._arm_grid(self.a),
                                    extra=extra_a),
                store_mod.query_key(self.b.model, self._arm_grid(self.b),
                                    extra=extra_b))

    def key(self) -> str:
        ka, kb = self.arm_keys()
        pol = json.dumps(self.policy.canonical()) if self.policy else "fixed"
        return hashlib.sha256(f"paired:{ka}:{kb}:{pol}".encode()).hexdigest()

    @property
    def n_cells(self) -> int:
        return self.a.n_cells


@dataclasses.dataclass
class QueryResult:
    """Answer to a SimQuery: every Monte-Carlo sample gathered (over all
    adaptive rounds) plus the per-cell statistical summary."""
    key: str
    grid: GridResult
    cells: CellTable
    from_cache: bool
    n_rounds: int

    @property
    def total_reps(self) -> int:
        return len(self.grid)

    def converged(self, policy: AdaptivePolicy) -> np.ndarray:
        target = policy.ci_half_width * (
            np.abs(self.cells.mean) if policy.relative else 1.0)
        return (self.cells.half_width <= target) & (self.cells.n
                                                    >= policy.min_reps)


@dataclasses.dataclass
class PairedResult:
    """Answer to a PairedQuery: both arms' full ensembles and summaries plus
    the per-cell paired-difference statistics (CI on E[Cmax_A − Cmax_B],
    significance verdict, independent-arms baseline width)."""
    key: str
    grid_a: GridResult
    grid_b: GridResult
    cells_a: CellTable
    cells_b: CellTable
    paired: PairedCells
    from_cache: bool
    n_rounds: int

    @property
    def total_reps(self) -> int:
        return len(self.grid_a) + len(self.grid_b)


class _Pending:
    """Per-query round state machine inside one flush."""

    def __init__(self, query: SimQuery, confidence: float):
        self.query = query
        self.confidence = confidence
        self.canon = store_mod.canonical_model(query.model)
        self.parts: List[GridResult] = []
        self.round = 0
        self.welford = Welford.zeros(query.n_cells)
        self.p2 = None
        if isinstance(query.adaptive, QuantilePolicy):
            self.p2 = P2Quantiles.zeros(query.n_cells,
                                        query.adaptive.quantiles)
        self._active_cells: Optional[np.ndarray] = None  # adaptive round mask
        # Rounds are capped so a pathological cell that only ever overflows
        # (contributing no valid samples, hence never converging) cannot
        # spin the flush loop forever.
        self._max_rounds = (
            -(-query.adaptive.max_reps // query.adaptive.batch_reps)
            if query.adaptive else 1)

    def _next_rows(self) -> Optional[GridRows]:
        """Rows this query wants simulated next, or None when finished."""
        q = self.query
        if self.round >= self._max_rounds:
            return None
        if q.adaptive is None:
            return grid_rows(q.W_list, q.lam_list, q.reps, q.theta,
                             seed0=q.seed0)
        state = self.p2 if self.p2 is not None else self.welford
        pending = q.adaptive.unconverged(state)
        if not pending.any():
            self._active_cells = None
            return None
        # Fresh seed batch for every still-pending cell: the full-grid rows
        # for stream=round are deterministic regardless of which cells are
        # active, so seeds never depend on the convergence pattern.
        full = grid_rows(q.W_list, q.lam_list, q.adaptive.batch_reps, q.theta,
                         seed0=q.seed0, stream=self.round)
        _, inv = _rows_cell_index(full)
        keep = pending[inv]
        self._active_cells = inv[keep]
        return full.take(keep)

    def wants(self) -> List[tuple]:
        """(tag, model, canonical config, remote_prob, backend, rows) work
        items this query wants simulated next round."""
        rows = self._next_rows()
        if rows is None:
            return []
        return [("solo", self.query.model, self.canon,
                 self.query.remote_prob, self.query.backend, rows)]

    def feed_part(self, tag: str, grid: GridResult):
        self.parts.append(grid)
        ok = ~np.asarray(grid.overflow, bool)
        if self.query.adaptive is None:
            _, inv = cell_index(grid)
        else:
            inv = self._active_cells
        idx = np.asarray(inv)[ok]
        vals = np.asarray(grid.makespan)[ok]
        self.welford.update(idx, vals)
        if self.p2 is not None:
            self.p2.update(idx, vals)
        self.round += 1

    def result(self, key: str):
        grid = concat_grids(self.parts)
        return QueryResult(key=key, grid=grid,
                           cells=summarize_cells(grid, self.confidence),
                           from_cache=False, n_rounds=self.round)

    def persist(self, store: ResultStore, key: str):
        store.put(key, concat_grids(self.parts),
                  meta={"grid": self.query.grid_dict(), "model": self.canon})


class _PairedPending:
    """Round state machine for a PairedQuery: both arms advance in lockstep
    on identical rows (CRN), and convergence is judged on the per-seed
    difference."""

    def __init__(self, pq: PairedQuery, confidence: float):
        self.pq = pq
        self.confidence = confidence
        self.canon_a = store_mod.canonical_model(pq.a.model)
        self.canon_b = store_mod.canonical_model(pq.b.model)
        self.parts_a: List[GridResult] = []
        self.parts_b: List[GridResult] = []
        self.round = 0
        self.delta_w = Welford.zeros(pq.n_cells)
        self._active_cells: Optional[np.ndarray] = None
        self._fed: Dict[str, GridResult] = {}
        self._max_rounds = (
            -(-pq.policy.max_reps // pq.policy.batch_reps)
            if pq.policy else 1)

    def _arm_rows(self, reps: int, stream: int,
                  keep: Optional[np.ndarray]) -> Tuple[GridRows, GridRows]:
        """Both arms' rows for one round: identical W/λ/seed columns (the
        common random numbers) with each arm's own θ thresholds — the grids
        are (W × λ × θ × rep) cross products, so cell k of arm A pairs with
        cell k of arm B positionally."""
        a, b = self.pq.a, self.pq.b
        full_a = grid_rows(a.W_list, a.lam_list, reps, a.theta,
                           seed0=a.seed0, stream=stream)
        full_b = grid_rows(b.W_list, b.lam_list, reps, b.theta,
                           seed0=b.seed0, stream=stream)
        if keep is None:
            return full_a, full_b
        return full_a.take(keep), full_b.take(keep)

    def _next_keep(self) -> Optional[Tuple[int, Optional[np.ndarray]]]:
        """(reps, row keep mask) of the next round, or None when finished."""
        pq = self.pq
        if self.round >= self._max_rounds:
            return None
        if pq.policy is None:
            return pq.a.reps, None
        pending = pq.policy.unconverged(self.delta_w)
        if not pending.any():
            self._active_cells = None
            return None
        full = grid_rows(pq.a.W_list, pq.a.lam_list, pq.policy.batch_reps,
                         pq.a.theta, seed0=pq.a.seed0, stream=self.round)
        _, inv = _rows_cell_index(full)
        keep = pending[inv]
        self._active_cells = inv[keep]
        return pq.policy.batch_reps, keep

    def wants(self) -> List[tuple]:
        nxt = self._next_keep()
        if nxt is None:
            return []
        reps, keep = nxt
        rows_a, rows_b = self._arm_rows(reps, self.round, keep)
        return [("a", self.pq.a.model, self.canon_a,
                 self.pq.a.remote_prob, self.pq.a.backend, rows_a),
                ("b", self.pq.b.model, self.canon_b,
                 self.pq.b.remote_prob, self.pq.b.backend, rows_b)]

    def feed_part(self, tag: str, grid: GridResult):
        self._fed[tag] = grid
        if len(self._fed) < 2:
            return
        ga, gb = self._fed.pop("a"), self._fed.pop("b")
        self.parts_a.append(ga)
        self.parts_b.append(gb)
        ok = ~(np.asarray(ga.overflow, bool) | np.asarray(gb.overflow, bool))
        if self.pq.policy is None:
            _, inv = cell_index(ga)
        else:
            inv = self._active_cells
        delta = (np.asarray(ga.makespan, np.float64)
                 - np.asarray(gb.makespan, np.float64))
        self.delta_w.update(np.asarray(inv)[ok], delta[ok])
        self.round += 1

    def result(self, key: str) -> PairedResult:
        ga, gb = concat_grids(self.parts_a), concat_grids(self.parts_b)
        return _paired_result(key, ga, gb, self.confidence,
                              from_cache=False, n_rounds=self.round)

    def persist(self, store: ResultStore, key: str):
        ka, kb = self.pq.arm_keys()
        meta_pol = self.pq.policy.canonical() if self.pq.policy else None
        store.put(ka, concat_grids(self.parts_a),
                  meta={"grid": self.pq._arm_grid(self.pq.a),
                        "model": self.canon_a, "paired": meta_pol})
        store.put(kb, concat_grids(self.parts_b),
                  meta={"grid": self.pq._arm_grid(self.pq.b),
                        "model": self.canon_b, "paired": meta_pol})


def _paired_result(key: str, ga: GridResult, gb: GridResult,
                   confidence: float, from_cache: bool,
                   n_rounds: int) -> PairedResult:
    return PairedResult(
        key=key, grid_a=ga, grid_b=gb,
        cells_a=summarize_cells(ga, confidence),
        cells_b=summarize_cells(gb, confidence),
        paired=paired_summary(ga, gb, confidence),
        from_cache=from_cache, n_rounds=n_rounds)


def _rows_cell_index(rows: GridRows):
    cols = np.stack([rows.W, rows.lam_local, rows.lam_remote,
                     rows.theta_static, rows.theta_comm], axis=1)
    return unique_cells(cols)


def _concat_rows(parts: Sequence[GridRows]) -> GridRows:
    return GridRows(*(np.concatenate([np.asarray(getattr(r, f))
                                      for r in parts])
                      for f in GridRows._fields))


def _pad_rows(rows: GridRows, target: int) -> GridRows:
    """Pad with W=1 filler scenarios (terminate after one event cycle)."""
    pad = target - len(rows)
    if pad <= 0:
        return rows
    filler = GridRows(
        W=np.ones(pad, np.int32),
        lam_local=np.ones(pad, np.int32),
        lam_remote=np.ones(pad, np.int32),
        theta_static=np.zeros(pad, np.int32),
        theta_comm=np.zeros(pad, np.int32),
        seed=np.ones(pad, np.uint32),
    )
    return _concat_rows([rows, filler])


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _rows_cols(rows: GridRows) -> np.ndarray:
    """(n, 5) scenario-cell columns (everything but the seed)."""
    return np.stack([np.asarray(rows.W), np.asarray(rows.lam_local),
                     np.asarray(rows.lam_remote),
                     np.asarray(rows.theta_static),
                     np.asarray(rows.theta_comm)], axis=1).astype(np.int64)


class EventHistory:
    """EMA of observed per-row event counts, keyed by (bucket signature,
    scenario cell). Drives the broker's straggler-aware ordering: sorting a
    coalesced batch by expected event count gives each contiguous device
    chunk a tight intra-chunk spread, which is exactly what the segmented
    engine's compaction (and a batch's longest row) wants. Predictions fall
    back to a λ-derived heuristic (the makespan/steal-cycle shape of
    ``divisible.default_max_events``) until a cell has been observed."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)
        self._ema: Dict[tuple, float] = {}

    def __len__(self) -> int:
        return len(self._ema)

    def observe(self, sig: str, cols: np.ndarray, n_events) -> None:
        cols = np.asarray(cols)
        ev = np.asarray(n_events, np.float64)
        uniq, inv = np.unique(cols, axis=0, return_inverse=True)
        for u in range(len(uniq)):
            mean = float(ev[inv == u].mean())
            key = (sig,) + tuple(int(v) for v in uniq[u])
            old = self._ema.get(key)
            self._ema[key] = mean if old is None else \
                (1.0 - self.alpha) * old + self.alpha * mean

    def observe_grid(self, sig: str, grid: GridResult) -> None:
        ev = grid.extras.get("n_events")
        if ev is None or len(grid) == 0:
            return
        cols = np.stack([grid.W, grid.extras["lam_local"], grid.lam,
                         grid.theta_static, grid.theta_comm],
                        axis=1).astype(np.int64)
        self.observe(sig, cols, ev)

    def to_json(self) -> dict:
        """JSON-able snapshot of the EMA state. Keys are ``(sig, *cols)``
        tuples; the wire form stores them as ``[sig, c0, c1, ...]`` lists —
        lossless because sig is a str and every col is an int."""
        return {
            "version": 1,
            "alpha": self.alpha,
            "ema": [[k[0], *[int(v) for v in k[1:]], float(ev)]
                    for k, ev in sorted(self._ema.items())],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "EventHistory":
        """Rebuild from :meth:`to_json` output. Unknown versions / malformed
        rows are skipped, never raised: a corrupt sidecar costs warm
        predictions, not daemon startup."""
        out = cls(alpha=float(doc.get("alpha", 0.5)))
        if int(doc.get("version", 0)) != 1:
            return out
        for row in doc.get("ema", []):
            try:
                sig, *cols, ev = row
                out._ema[(str(sig),) + tuple(int(c) for c in cols)] = \
                    float(ev)
            except (TypeError, ValueError):
                continue
        return out

    def merge(self, other: "EventHistory") -> None:
        """Fold another history in (EMA-blend on shared cells, adopt new
        ones) — used when a daemon loads a sidecar on top of observations
        already made this process."""
        for key, ev in other._ema.items():
            old = self._ema.get(key)
            self._ema[key] = ev if old is None else \
                (1.0 - self.alpha) * old + self.alpha * ev

    def predict(self, sig: str, p: int, cols: np.ndarray) -> np.ndarray:
        cols = np.asarray(cols)
        W = np.maximum(cols[:, 0], 1).astype(np.float64)
        lam = np.maximum((cols[:, 1] + cols[:, 2]) / 2.0, 1.0)
        makespan = W / max(p, 1) + 16.0 * lam * np.maximum(
            np.log2(np.maximum(W, 2) / lam), 1.0)
        out = p * (makespan / (2.0 * lam) + 8.0)
        uniq, inv = np.unique(cols, axis=0, return_inverse=True)
        for u in range(len(uniq)):
            got = self._ema.get((sig,) + tuple(int(v) for v in uniq[u]))
            if got is not None:
                out[inv == u] = got
        return out


class _Bucket:
    """One coalesced dispatch group: every member shares the same canonical
    static config (modulo ``max_events`` under relaxation), ``remote_prob``
    and execution backend — and therefore the same kernel launch."""

    def __init__(self, model: eng.TaskModel, canon: dict, rp: float,
                 backend: str):
        self.model = model       # dispatch vehicle (first member's object)
        self.canon = canon       # bucket-key canonical form
        self.rp = rp
        self.backend = backend
        # (query idx, tag, rows, member's own static max_events cap)
        self.members: List[Tuple[int, str, GridRows, int]] = []


class QueryBroker:
    """Accepts concurrent SimQuerys/PairedQuerys, coalesces, dispatches,
    fans back.

    ``relax_max_events`` enables cross-bucket coalescing over the static
    ``max_events`` cap (exact per-row budgets — see the module docstring);
    ``lock_wait_s`` bounds how long a flush polls the store for a key whose
    advisory lock another process holds (None disables locking entirely,
    0 takes locks but never waits); ``dispatch_log_max`` bounds the
    per-dispatch telemetry ring (oldest entries drop once full — the drop
    count lands on the ``broker.dispatch_log_dropped`` metric — so a
    long-lived process's log cannot grow without limit; 0/None unbounds
    it). ``device`` follows the device rule (None is the card, and raises
    without one); it decides the auto-selected backend and the fallback
    chain, and every dispatch runs there. A custom ``dispatch`` callable
    takes ``(model, rows, rp, backend=None, ev_budget=None)``."""

    def __init__(self, store: Optional[ResultStore] = None,
                 dispatch=None, pad_pow2: bool = True,
                 confidence: float = 0.95,
                 relax_max_events: bool = True,
                 lock_wait_s: Optional[float] = 60.0,
                 straggler_sort: bool = True,
                 dispatch_log_max: Optional[int] = 1024,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 resilience: Optional[rz.ResilienceConfig] = None,
                 device: eng.DeviceLike = None):
        self.device = eng.resolve_device(device)
        self.store = store if store is not None else ResultStore()
        self.pad_pow2 = pad_pow2
        self.confidence = float(confidence)
        self.relax_max_events = bool(relax_max_events)
        self.lock_wait_s = lock_wait_s if lock_wait_s is None \
            else float(lock_wait_s)
        # Self-healing dispatch config (retry / fallback chain / breaker /
        # bisection salvage); ResilienceConfig(enabled=False) restores the
        # raise-through behaviour.
        self.resilience = resilience if resilience is not None \
            else rz.ResilienceConfig()
        self._breaker = self.resilience.make_breaker(metrics)
        # Straggler-aware dispatch: order a bucket's rows by expected event
        # count before running (results are un-permuted before fan-back, so
        # answers and stored artifacts are byte-identical either way).
        self.straggler_sort = bool(straggler_sort)
        self.history = EventHistory()
        self._dispatch = dispatch or (
            lambda model, rows, rp, backend=None, ev_budget=None: run_rows(
                model, rows, remote_prob=rp, backend=backend,
                ev_budget=ev_budget, device=self.device))
        self._queue: List[Union[SimQuery, PairedQuery]] = []
        # Telemetry for the service_throughput bench / coalescing tests.
        # Legacy integer attributes stay (stats()/tests read them); every
        # increment is mirrored into the metrics registry via _count.
        self.metrics = metrics if metrics is not None else obs.REGISTRY
        self.n_dispatches = 0
        self.n_cache_hits = 0
        self.n_queries = 0
        self.n_lock_waits = 0     # keys found locked by another process
        self.n_lock_served = 0    # of those, answered by the other process
        self.dispatch_log_max = dispatch_log_max
        self.n_dispatch_log_dropped = 0
        self.dispatch_log: "deque[dict]" = deque(
            maxlen=int(dispatch_log_max) if dispatch_log_max else None)

    @property
    def default_backend(self) -> str:
        """The backend a query that names none is bucketed on: the device
        rule's auto-selection (``cuda`` on the card, ``torch`` on the CPU,
        unless ``REPRO_WS_BACKEND`` names another)."""
        return bk.get_backend(None, self.device).name

    def _count(self, attr: str, metric: str, n: int = 1):
        setattr(self, attr, getattr(self, attr) + n)
        self.metrics.counter(metric).inc(n)

    def submit(self, query: Union[SimQuery, PairedQuery]) -> int:
        """Enqueue; returns the query's position for the next flush()."""
        self._queue.append(query)
        return len(self._queue) - 1

    def _paired_from_cache(self, pq: PairedQuery,
                           key: str) -> Optional[PairedResult]:
        ka, kb = pq.arm_keys()
        ga = self.store.get(ka)
        if ga is None:
            return None
        gb = self.store.get(kb)
        if gb is None:
            return None
        return _paired_result(key, ga, gb, self.confidence,
                              from_cache=True, n_rounds=0)

    def _from_cache(self, q, key: str):
        if isinstance(q, PairedQuery):
            return self._paired_from_cache(q, key)
        grid = self.store.get(key)
        if grid is None:
            return None
        return QueryResult(key=key, grid=grid,
                           cells=summarize_cells(grid, self.confidence),
                           from_cache=True, n_rounds=0)

    def _make_pending(self, q):
        return _PairedPending(q, self.confidence) if isinstance(
            q, PairedQuery) else _Pending(q, self.confidence)

    def _history_sig(self, canon: dict, rp: float) -> str:
        """Event-history key: the bucket identity minus the static cap (so
        history survives cap relaxation) plus the remote-steal probability."""
        if self.relax_max_events:
            canon = {k: v for k, v in canon.items() if k != "max_events"}
        return (json.dumps(canon, sort_keys=True, separators=(",", ":"))
                + f":{remote_prob_u32(float(rp))}")

    def _observe_cached(self, q, res) -> None:
        """Feed stored event counts into the straggler history — recorded
        ``n_events`` from prior rounds (any process sharing the store) make
        the ordering exact instead of heuristic."""
        if isinstance(q, PairedQuery):
            arms = ((q.a, res.grid_a), (q.b, res.grid_b))
        else:
            arms = ((q, res.grid),)
        for arm, grid in arms:
            self.history.observe_grid(
                self._history_sig(store_mod.canonical_model(arm.model),
                                  arm.remote_prob), grid)

    def flush(self) -> List[Union[QueryResult, PairedResult]]:
        """Answer every queued query; one dispatch per (bucket, round)."""
        with obs.span("broker.flush", n_queries=len(self._queue)) as sp:
            before = self.n_dispatches
            out = self._flush()
            sp.set(n_dispatches=self.n_dispatches - before)
            return out

    def _flush(self) -> List[Union[QueryResult, PairedResult]]:
        queue, self._queue = self._queue, []
        self._count("n_queries", "broker.queries", len(queue))
        results: List[Optional[object]] = [None] * len(queue)
        pendings: Dict[int, object] = {}
        key_owner: Dict[str, int] = {}   # identical questions share one run
        aliases: Dict[int, int] = {}
        keys = [q.key() for q in queue]
        owned: set = set()               # advisory locks this flush holds
        waiting: Dict[int, str] = {}     # keys locked by another process

        for i, (q, key) in enumerate(zip(queue, keys)):
            cached = self._from_cache(q, key)
            if cached is not None:
                self._count("n_cache_hits", "broker.cache_hits")
                self._observe_cached(q, cached)
                results[i] = cached
            elif key in key_owner:
                aliases[i] = key_owner[key]
                self.metrics.counter("broker.aliased_queries").inc()
            else:
                key_owner[key] = i
                if self.lock_wait_s is not None \
                        and not self.store.try_lock(key):
                    waiting[i] = key     # someone else is computing this key
                    self._count("n_lock_waits", "broker.lock_waits")
                else:
                    if self.lock_wait_s is not None:
                        owned.add(key)
                    pendings[i] = self._make_pending(q)

        # Cross-process in-flight dedup: poll the store for locked keys
        # until the other process's answer lands (or its lock frees/goes
        # stale — then we take over), bounded by lock_wait_s. Best-effort:
        # on timeout we compute anyway; correctness never needs the lock.
        if waiting:
            with obs.span("broker.lock_wait", n_keys=len(waiting)) as lsp:
                deadline = time.monotonic() + self.lock_wait_s
                rng = random.Random()
                sleep_s = LOCK_POLL_S
                while waiting:
                    self.metrics.counter("broker.lock_polls").inc()
                    for i in list(waiting):
                        key = waiting[i]
                        cached = self._from_cache(queue[i], key)
                        if cached is not None:
                            self._count("n_cache_hits", "broker.cache_hits")
                            self._count("n_lock_served", "broker.lock_served")
                            results[i] = cached
                            del waiting[i]
                        elif self.store.try_lock(key):
                            # Lock freed — or its holder died and try_lock
                            # broke the wreck. Either way we take over.
                            owned.add(key)
                            pendings[i] = self._make_pending(queue[i])
                            del waiting[i]
                    if not waiting or time.monotonic() >= deadline:
                        break
                    # Decorrelated jitter keeps concurrent waiters from
                    # polling the store in lockstep.
                    time.sleep(min(sleep_s,
                                   max(0.0, deadline - time.monotonic())))
                    sleep_s = rz.decorrelated_jitter(
                        sleep_s, LOCK_POLL_S, LOCK_POLL_CAP_S, rng)
                lsp.set(timed_out=len(waiting))
                for i in waiting:        # wait budget spent: just compute
                    pendings[i] = self._make_pending(queue[i])

        try:
            self._run_pendings(queue, keys, results, pendings, owned)
        finally:
            for key in owned:
                self.store.unlock(key)

        for i, owner in aliases.items():
            src = results[owner]
            results[i] = dataclasses.replace(src, from_cache=True)
        return results

    def _run_pendings(self, queue, keys, results, pendings, owned):
        while True:
            # Heartbeat our advisory locks once per dispatch round so
            # cross-process waiters see a live mtime and keep waiting
            # instead of declaring us dead mid-computation.
            for key in owned:
                self.store.heartbeat(key)
            default = self.default_backend
            # (canonical static config, rp, backend) -> coalesced dispatch
            buckets: Dict[Tuple[str, int, str], _Bucket] = {}
            for i, pend in pendings.items():
                if results[i] is not None:
                    continue
                wants = pend.wants()
                if not wants:
                    results[i] = pend.result(keys[i])
                    self._observe_reps(results[i], pend)
                    pend.persist(self.store, keys[i])
                    if keys[i] in owned:
                        self.store.unlock(keys[i])
                        owned.discard(keys[i])
                    continue
                for tag, model, canon, rp, backend, rows in wants:
                    bname = backend or default
                    if self.relax_max_events:
                        # Drop the static cap from the bucket identity:
                        # members coalesce across max_events and the
                        # dispatch cap is relaxed to a shared pow2 bound.
                        canon_b = {k: v for k, v in canon.items()
                                   if k != "max_events"}
                    else:
                        canon_b = canon
                    bkey = (json.dumps(canon_b, sort_keys=True,
                                       separators=(",", ":")),
                            remote_prob_u32(float(rp)), bname)
                    bucket = buckets.get(bkey)
                    if bucket is None:
                        bucket = buckets[bkey] = _Bucket(model, canon_b, rp,
                                                         bname)
                    else:
                        assert bucket.canon == canon_b, (
                            "bucket members' canonical model configs "
                            "disagree despite equal bucket keys")
                    bucket.members.append((i, tag, rows,
                                           int(model.max_events)))
            if not buckets:
                return
            for bucket in buckets.values():
                self._dispatch_bucket(bucket, pendings)

    def _observe_reps(self, res, pend) -> None:
        """Metrics on how much replication an adaptive/paired stopping rule
        actually spent vs its worst case (``max_reps`` per cell): the 'reps
        saved by adaptive policies' series the fleet dashboard wants."""
        pending_q = getattr(pend, "query", None)
        policy = pending_q.adaptive if pending_q is not None \
            else pend.pq.policy
        if policy is None:
            return
        used = res.total_reps
        n_cells = pending_q.n_cells if pending_q is not None \
            else pend.pq.n_cells
        arms = 1 if pending_q is not None else 2
        worst = int(policy.max_reps) * int(n_cells) * arms
        self.metrics.counter("broker.adaptive_reps").inc(used)
        self.metrics.counter("broker.adaptive_reps_saved").inc(
            max(0, worst - used))

    def _dispatch_bucket(self, bucket: _Bucket, pendings):
        rows = _concat_rows([r for _, _, r, _ in bucket.members])
        n = len(rows)
        caps = [c for _, _, _, c in bucket.members]
        model = bucket.model
        if self.relax_max_events:
            # Relax the static cap to the bucket's shared pow2 upper bound;
            # every member's rows keep their own cap as an in-engine per-row
            # event budget, so results (overflow columns included) are
            # bit-identical to the member's unrelaxed dispatch. Clamped to
            # INT32_MAX: a pow2-ceil of a near-limit cap must not wrap the
            # engine's int32 event counter.
            cap = min(_next_pow2(max(caps)), int(eng.INF32))
            if cap != model.max_events:
                model = dataclasses.replace(
                    model, cfg=dataclasses.replace(model.cfg,
                                                   max_events=cap))
            budgets = np.concatenate(
                [np.full(len(r), c, np.int32)
                 for _, _, r, c in bucket.members])
        else:
            cap = int(model.max_events)
            budgets = None
        # Straggler-aware ordering: dispatch the batch sorted by expected
        # event count (history EMA, else λ heuristic), so contiguous device
        # chunks have tight intra-chunk spread and segmented compaction
        # retires whole width levels at once. The permutation is inverted
        # before fan-back: answers and stored artifacts stay byte-identical
        # to an unsorted dispatch.
        sig = self._history_sig(bucket.canon, bucket.rp)
        cols = _rows_cols(rows)
        order = None
        if self.straggler_sort and n > 1:
            srt = np.argsort(
                self.history.predict(sig, model.p, cols), kind="stable")
            if not np.array_equal(srt, np.arange(n)):
                order = srt
                rows = rows.take(order)
                if budgets is not None:
                    budgets = budgets[order]
        padded = _pad_rows(rows, _next_pow2(n)) if self.pad_pow2 else rows
        if budgets is not None and len(padded) > n:
            budgets = np.concatenate(
                [budgets, np.full(len(padded) - n, eng.INF32, np.int32)])
        entry = dict(
            n_queries=len(bucket.members), n_rows=n, n_padded=len(padded),
            backend=bucket.backend, max_events=cap,
            relaxed=bool(self.relax_max_events and len(set(caps)) > 1),
            sorted=order is not None)
        cfg = self.resilience
        # The device rule: on the card, the primary alone.
        chain = rz.fallback_chain(bucket.backend, model, self.device) \
            if cfg.enabled else [bucket.backend]

        def call(rws, buds, bname, top):
            rz.fault_point("broker.dispatch", backend=bname, n_rows=len(rws))
            return self._dispatch(model, rws, bucket.rp, backend=bname,
                                  ev_budget=buds)

        with obs.span("broker.dispatch", sig=sig[-16:], **entry):
            if cfg.enabled:
                grid, degraded = rz.dispatch_resilient(
                    call, padded, budgets, chain, retry=cfg.retry,
                    breaker=self._breaker, metrics=self.metrics,
                    salvage=cfg.salvage)
            else:
                grid, degraded = call(padded, budgets, bucket.backend,
                                      True), False
        entry["degraded"] = degraded
        self._count("n_dispatches", "broker.dispatches")
        self.metrics.counter("broker.coalesced_queries").inc(
            max(0, len(bucket.members) - 1))
        self.metrics.histogram("broker.rows_per_dispatch").observe(n)
        if self.dispatch_log.maxlen is not None \
                and len(self.dispatch_log) == self.dispatch_log.maxlen:
            self._count("n_dispatch_log_dropped",
                        "broker.dispatch_log_dropped")
        self.dispatch_log.append(entry)
        if order is not None:
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            grid = _take_grid(grid, inv)  # member order restored, pads gone
        ev = grid.extras.get("n_events")
        if ev is not None and n > 0:
            self.history.observe(sig, cols, np.asarray(ev)[:n])
            # Sanitizer: event counts sane vs the dispatch budget cap, and
            # the post-observe EMA still predicts finite positive stragglers.
            san.probe("broker.observe", sig=sig, cols=cols,
                      ev=np.asarray(ev)[:n], cap=cap, history=self.history,
                      p=model.p)
        off = 0
        for i, tag, rws, _ in bucket.members:
            part = _slice_grid(grid, off, off + len(rws))
            pendings[i].feed_part(tag, part)
            off += len(rws)


def _take_grid(grid: GridResult, idx: np.ndarray) -> GridResult:
    fields = {
        f.name: np.asarray(getattr(grid, f.name))[idx]
        for f in dataclasses.fields(GridResult)
        if f.name not in ("p", "extras")
    }
    extras = {k: np.asarray(v)[idx] for k, v in grid.extras.items()}
    return GridResult(p=grid.p, extras=extras, **fields)


def _slice_grid(grid: GridResult, lo: int, hi: int) -> GridResult:
    fields = {
        f.name: np.asarray(getattr(grid, f.name))[lo:hi]
        for f in dataclasses.fields(GridResult)
        if f.name not in ("p", "extras")
    }
    extras = {k: np.asarray(v)[lo:hi] for k, v in grid.extras.items()}
    return GridResult(p=grid.p, extras=extras, **fields)
