"""Opt-in runtime determinism sanitizer.

Enable with ``REPRO_WS_SANITIZE=1`` (or :func:`install` in-process). The
backend and the broker call :func:`probe` at two sites through the same
lazy-bridge pattern as fault injection — a disabled probe is one env read
and a boolean, so production dispatch pays nothing measurable.

Probes (each violation increments ``check.violations{pass="sanitizer",
rule=...}`` in the global metrics registry and lands in a bounded ring
surfaced by ``SimulationService.stats()["sanitizer"]``):

``backend.result`` — after every backend dispatch:
    * ``steal_accounting``   — per row, ``n_requests == n_success +
      n_fail`` (no request may vanish or double-count);
    * ``replay_mismatch``    — a seeded sample of dispatches (1 in
      ``replay_denom``, chosen by xor-folding the row seeds — no clock,
      no RNG) re-runs up to ``replay_rows`` of its rows on the oracle
      backend, on the host, under a masked fault plan and diffs every
      result column bitwise. Any difference is a determinism break of the
      backend-bit-identical invariant the store keys rely on. The replay is
      a check, not a fallback: the dispatch's answer is still the one its
      backend computed. Where the oracle cannot twin the model
      (``resilience.backend_compatible``: a DAG or adaptive model, trace
      logging), the replay is skipped.

``broker.observe`` — after the broker folds a dispatch into
    ``EventHistory``:
    * ``event_history``      — observed per-row event counts are within
      ``[1, cap]`` and the resulting straggler predictions stay finite
      and positive (a poisoned EMA silently destroys dispatch ordering,
      which byte-identical fan-back then hides).

The JAX package's third site, ``engine.segment`` (clock monotonicity, the
segment budget and work conservation at the boundaries of a segmented run),
has no caller here: the port has no segmented run yet.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Dict, List

import numpy as np

from repro_torch.check import Finding

PASS = "sanitizer"
ENV = "REPRO_WS_SANITIZE"

#: Per-dispatch sampling: replay 1 in ``replay_denom`` dispatches, at most
#: ``replay_rows`` rows each. The oracle is a serial loop on the host, far
#: slower a row than a batched backend, so per-row sampling would cost more
#: than the dispatch itself; per-dispatch sampling with a row cap keeps the
#: replay cost amortized.
DEFAULT_REPLAY_DENOM = 16
DEFAULT_REPLAY_ROWS = 2
RING_SIZE = 256


@dataclasses.dataclass
class _State:
    installed: bool = False
    replay_denom: int = DEFAULT_REPLAY_DENOM
    replay_rows: int = DEFAULT_REPLAY_ROWS
    n_probes: int = 0
    n_dispatch_probes: int = 0
    n_replayed_dispatches: int = 0
    n_replayed_rows: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    ring: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=RING_SIZE))


_STATE = _State()
_IN_REPLAY = False


def enabled() -> bool:
    if _STATE.installed:
        return True
    return os.environ.get(ENV, "") not in ("", "0", "false", "False")


def install(replay_denom: int = DEFAULT_REPLAY_DENOM,
            replay_rows: int = DEFAULT_REPLAY_ROWS) -> None:
    """Enable in-process (the env var does the same for subprocesses)."""
    _STATE.installed = True
    _STATE.replay_denom = max(1, int(replay_denom))
    _STATE.replay_rows = max(1, int(replay_rows))


def uninstall() -> None:
    _STATE.installed = False


def reset() -> None:
    """Clear accumulated violations/counters (keeps enabled-ness)."""
    _STATE.n_probes = 0
    _STATE.n_dispatch_probes = 0
    _STATE.n_replayed_dispatches = 0
    _STATE.n_replayed_rows = 0
    _STATE.counts.clear()
    _STATE.ring.clear()


def violation(rule: str, where: str, **detail) -> None:
    _STATE.counts[rule] = _STATE.counts.get(rule, 0) + 1
    entry = {"rule": rule, "where": where}
    entry.update(detail)
    _STATE.ring.append(entry)
    try:
        from repro_torch import obs
        obs.REGISTRY.counter("check.violations",
                             {"pass": PASS, "rule": rule}).inc()
    except Exception:
        pass  # metrics are best-effort; the ring is the source of truth


def violations() -> List[dict]:
    return list(_STATE.ring)


def summary() -> dict:
    """The ``stats()["sanitizer"]`` payload."""
    return {
        "enabled": enabled(),
        "replay_denom": _STATE.replay_denom,
        "replay_rows": _STATE.replay_rows,
        "n_probes": _STATE.n_probes,
        "n_dispatch_probes": _STATE.n_dispatch_probes,
        "n_replayed_dispatches": _STATE.n_replayed_dispatches,
        "n_replayed_rows": _STATE.n_replayed_rows,
        "violations_total": sum(_STATE.counts.values()),
        "violations_by_rule": dict(sorted(_STATE.counts.items())),
        "recent": list(_STATE.ring)[-20:],
    }


def probe(site: str, **ctx) -> None:
    """Single runtime entry point (called through the core lazy bridges)."""
    if not enabled():
        return
    _STATE.n_probes += 1
    if site == "backend.result":
        _probe_dispatch(**ctx)
    elif site == "broker.observe":
        _probe_bucket(**ctx)


# ---------------------------------------------------------------------------
# backend.result
# ---------------------------------------------------------------------------

_CMP_FIELDS = ("makespan", "n_requests", "n_success", "n_fail",
               "total_idle", "startup_end", "overflow")


def _probe_dispatch(backend, model, rows, remote_prob, ev_budget,
                    grid) -> None:
    global _IN_REPLAY
    if _IN_REPLAY:
        return
    _STATE.n_dispatch_probes += 1

    req = np.asarray(grid.n_requests, dtype=np.int64)
    suc = np.asarray(grid.n_success, dtype=np.int64)
    fail = np.asarray(grid.n_fail, dtype=np.int64)
    bad = req != suc + fail
    if bad.any():
        idx = np.flatnonzero(bad)[:4]
        seeds = np.asarray(rows.seed)
        violation("steal_accounting", "backend.result",
                  message="n_requests != n_success + n_fail",
                  backend=backend.name,
                  seeds=[int(seeds[i]) for i in idx],
                  got=[[int(req[i]), int(suc[i]), int(fail[i])]
                       for i in idx])

    if backend.name == "oracle":
        return  # oracle is the replay reference itself
    seeds = np.asarray(rows.seed, dtype=np.uint32)
    if seeds.size == 0 or \
            int(np.bitwise_xor.reduce(seeds)) % _STATE.replay_denom != 0:
        return
    _replay(backend, model, rows, remote_prob, ev_budget, grid)


def _replay(backend, model, rows, remote_prob, ev_budget, grid) -> None:
    global _IN_REPLAY
    from repro_torch.core import backend as be
    from repro_torch.service import resilience as rz

    oracle = be.get_backend("oracle")
    if not (oracle.capabilities().available
            and rz.backend_compatible(oracle, model)):
        return
    n = len(rows)
    k = min(_STATE.replay_rows, n)
    # Deterministic spread over the dispatch: the k smallest seeds.
    sel = np.argsort(np.asarray(rows.seed, dtype=np.uint64),
                     kind="stable")[:k]
    sub = rows.take(sel)
    budget = ev_budget
    if budget is not None and np.ndim(budget) > 0:
        budget = np.asarray(budget)[sel]

    _STATE.n_replayed_dispatches += 1
    _STATE.n_replayed_rows += int(k)
    _IN_REPLAY = True
    try:
        # Mask any ambient fault plan: replay must observe the backend's
        # *output*, not re-roll the chaos dice.
        with rz.fault_plan(rz.no_faults()):
            ogrid = oracle.run_rows(model, sub, remote_prob=remote_prob,
                                    ev_budget=budget, device="cpu")
    except Exception as e:
        violation("replay_error", "backend.result",
                  message=f"oracle replay raised {type(e).__name__}: {e}",
                  backend=backend.name)
        return
    finally:
        _IN_REPLAY = False

    seeds = np.asarray(rows.seed)
    diffs = []
    for field in _CMP_FIELDS + ("n_events",):
        a = _grid_col(grid, field)
        b = _grid_col(ogrid, field)
        if a is None or b is None:
            continue
        a = np.asarray(a)[sel]
        b = np.asarray(b)
        neq = a != b
        if neq.any():
            for i in np.flatnonzero(neq)[:4]:
                diffs.append({"seed": int(seeds[sel[i]]), "field": field,
                              "got": _scalar(a[i]), "want": _scalar(b[i])})
    if diffs:
        violation("replay_mismatch", "backend.result",
                  message=f"backend {backend.name!r} diverges bitwise from "
                  f"the oracle on replayed rows",
                  backend=backend.name, diff=diffs)


def _grid_col(grid, field):
    ex = getattr(grid, "extras", None)
    if isinstance(ex, dict) and field in ex:
        return ex[field]
    return getattr(grid, field, None)


def _scalar(v):
    v = np.asarray(v).item()
    return float(v) if isinstance(v, float) else int(v)


# ---------------------------------------------------------------------------
# broker.observe
# ---------------------------------------------------------------------------

def _probe_bucket(sig, cols, ev, cap, history, p) -> None:
    ev = np.asarray(ev, dtype=np.int64)
    if ev.size and (ev < 1).any():
        violation("event_history", "broker.observe",
                  message="observed per-row event count < 1",
                  got=int(ev.min()))
    if cap is not None and ev.size and (ev > int(cap)).any():
        violation("event_history", "broker.observe",
                  message="observed per-row event count exceeds the "
                  "dispatch budget cap",
                  got=int(ev.max()), want=int(cap))
    try:
        pred = np.asarray(history.predict(sig, int(p), np.asarray(cols)),
                          dtype=np.float64)
    except Exception as e:
        violation("event_history", "broker.observe",
                  message=f"EventHistory.predict raised "
                  f"{type(e).__name__}: {e}")
        return
    bad = ~np.isfinite(pred) | (pred <= 0)
    if bad.any():
        violation("event_history", "broker.observe",
                  message="EventHistory prediction is non-finite or "
                  "non-positive after observe",
                  got=float(pred[np.flatnonzero(bad)[0]]))


# ---------------------------------------------------------------------------
# CLI pass: a short self-checked run
# ---------------------------------------------------------------------------

def run(device=None) -> List[Finding]:
    """Run a small seeded service workload with every probe armed (replay
    sampling forced to 1/1) and convert any violation into findings.
    ``device`` follows the device rule: None is the card."""
    import tempfile

    from repro_torch.core.topology import one_cluster
    from repro_torch.service.api import SimulationService

    was_installed, denom, rows_cap = (_STATE.installed, _STATE.replay_denom,
                                      _STATE.replay_rows)
    install(replay_denom=1, replay_rows=2)
    reset()
    try:
        with tempfile.TemporaryDirectory(prefix="repro-check-") as tmp:
            svc = SimulationService(root=tmp, device=device)
            topo = one_cluster(8, 1)
            for W in (2_000, 4_000):
                svc.query(topo, W_list=[W], lam_list=[3], reps=8, seed0=7)
    finally:
        _STATE.installed, _STATE.replay_denom, _STATE.replay_rows = (
            was_installed, denom, rows_cap)

    out: List[Finding] = []
    for v in violations():
        detail = {k: val for k, val in v.items()
                  if k not in ("rule", "where", "message")}
        out.append(Finding(
            pass_name=PASS, rule=v["rule"], where=v["where"],
            symbol=str(detail.get("backend", "")),
            message=str(v.get("message", "")) + (f" {detail}" if detail
                                                 else "")))
    return out


__all__ = ["PASS", "ENV", "enabled", "install", "uninstall", "reset",
           "probe", "violation", "violations", "summary", "run"]
