"""Fault injection + retry for the sweep service (DESIGN.md §10).

The paper studies schedulers under adverse conditions; this module makes the
*execution service itself* testable under them. Two halves:

**Fault injection** — a process-global :class:`FaultPlan` deterministically
injects faults at named *sites* threaded through the request path:

======================  =====================================================
site                    where it fires / ctx fields
======================  =====================================================
``backend.run_rows``    ``ExecutionBackend.run_rows`` entry
                        (``backend``, ``n_rows``, ``row_seeds``)
``broker.dispatch``     just before a bucket dispatch (``backend``,
                        ``n_rows``)
``store.get``           inside the disk read (``key``)
``store.put``           before the atomic write (``key``); the
                        ``torn_write`` / ``bit_flip`` kinds corrupt the
                        artifact *after* the write instead
``store.lock.acquired`` right after winning an advisory key lock (``key``)
                        — ``exit`` simulates a lock holder crashing
``train.step``          ``runtime.fault.FailureInjector`` (``index``)
======================  =====================================================

Plans are seeded and scriptable —
``FaultPlan(rng_seed=7, sites={"backend.run_rows": Prob(0.2)})`` — and can be
activated for whole subprocess trees via the ``REPRO_WS_FAULT_PLAN``
environment variable (a JSON plan, see :func:`plan_from_env`), which is how
the CI chaos job sweeps seeds. ``per_row=True`` makes the draw a
deterministic function of each row's seed instead of the call sequence, so
the *same rows* fail on every retry ("poisoned rows") until the dispatcher
routes them elsewhere — the adversarial case bisection salvage exists for.

**Recovery**:

* :class:`RetryPolicy`: exponential backoff with full jitter, capped by both
  attempt count and a wall-clock deadline (store I/O, dispatch retries);
* :class:`CircuitBreaker`: per-backend CLOSED → OPEN → HALF-OPEN state
  machine, exported as the ``resilience.breaker_state{backend=…}`` gauge;
* :func:`fallback_chain` + :func:`dispatch_resilient`: the broker's
  self-healing dispatch — retry, then bisection salvage of a failing batch
  (one poisoned row in n costs O(log n) dispatches, not n), then demotion
  down the chain of bit-identical backends;
* :func:`degraded_summary`: every recovery counter on the metrics registry
  (``resilience.retries / fallbacks / salvaged_rows / dispatch_failures /
  breaker_trips``), which :meth:`SimulationService.stats` reports under
  ``"degraded"``.

**The device rule decides the chain.** A dispatch whose tensors lie on a
CUDA device has a chain of its primary alone (``cuda`` or ``torch``):
retries and bisection salvage still run, on that backend, and then the error
propagates. The ``cuda`` backend never gives way to the plain loop or to the
host: a kernel that fails to build or launch raises. Only a dispatch on the
CPU (a service built with ``device="cpu"``) may demote ``torch`` to
``oracle``, and only where the oracle twins the model.

Import discipline: this module imports only :mod:`repro_torch.obs`, so the
store and the backends can use it without cycles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs

#: JSON fault plan consumed by :func:`plan_from_env` — lets chaos tests
#: inject faults into whole subprocess trees without code changes.
FAULT_PLAN_ENV = "REPRO_WS_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """A fault raised by a :class:`FaultPlan` (``kind="raise"``)."""


class InjectedDeviceLoss(InjectedFault):
    """Simulated accelerator loss (``kind="device_loss"``): recoverable,
    but trips the backend's circuit breaker immediately."""


class InjectedTimeout(TimeoutError):
    """Simulated caller-side timeout (``kind="timeout"``): the site sleeps
    ``delay_s`` first, modelling the hang the timeout cut short."""


#: Fault kinds that *raise*; the rest return an action string (``torn_write``
#: / ``bit_flip``) for the site to apply, sleep (``hang``) or kill the
#: process (``exit``).
_RAISING_KINDS = ("raise", "oserror", "device_loss", "timeout")
_KINDS = _RAISING_KINDS + ("hang", "exit", "torn_write", "bit_flip")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One site's fault behaviour.

    ``p`` is the fire probability per call (or per row under ``per_row``);
    ``at`` fires deterministically at the given call indices (or the site's
    ``index`` ctx field when present) instead, once each; ``match`` filters
    on ctx fields (e.g. ``{"backend": "torch"}`` faults only torch dispatches);
    ``max_faults`` stops injecting after N fires; ``delay_s`` is the sleep
    of ``hang``/``timeout`` kinds; ``exc`` (not JSON-serialisable — in-process
    plans only) overrides the raised exception type.
    """
    p: float = 1.0
    kind: str = "raise"
    per_row: bool = False
    match: Tuple[Tuple[str, str], ...] = ()
    at: Tuple[int, ...] = ()
    max_faults: Optional[int] = None
    delay_s: float = 0.0
    exc: Optional[type] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")

    def matches(self, ctx: dict) -> bool:
        return all(str(ctx.get(k)) == v for k, v in self.match)

    def to_dict(self) -> dict:
        if self.exc is not None:
            raise TypeError("FaultSpec with a custom exc is in-process only")
        out = {"p": self.p, "kind": self.kind}
        if self.per_row:
            out["per_row"] = True
        if self.match:
            out["match"] = dict(self.match)
        if self.at:
            out["at"] = list(self.at)
        if self.max_faults is not None:
            out["max_faults"] = self.max_faults
        if self.delay_s:
            out["delay_s"] = self.delay_s
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(p=float(d.get("p", 1.0)), kind=str(d.get("kind", "raise")),
                   per_row=bool(d.get("per_row", False)),
                   match=tuple(sorted((str(k), str(v)) for k, v in
                                      dict(d.get("match", {})).items())),
                   at=tuple(int(v) for v in d.get("at", ())),
                   max_faults=(None if d.get("max_faults") is None
                               else int(d["max_faults"])),
                   delay_s=float(d.get("delay_s", 0.0)))


def Prob(p: float, kind: str = "raise", **kw) -> FaultSpec:
    """Shorthand: ``Prob(0.2, kind="raise", match={"backend": "torch"})``."""
    match = kw.pop("match", None)
    if match is not None:
        kw["match"] = tuple(sorted((str(k), str(v))
                                   for k, v in dict(match).items()))
    return FaultSpec(p=float(p), kind=kind, **kw)


def At(*steps: int, kind: str = "raise", **kw) -> FaultSpec:
    """Shorthand for deterministic triggers: ``At(3, 7)`` fires at call (or
    ctx ``index``) 3 and 7, once each."""
    return FaultSpec(p=1.0, kind=kind, at=tuple(int(s) for s in steps), **kw)


def _mix32(a: int, b: int) -> int:
    """Deterministic 32-bit hash of (plan seed, row seed) — the ``per_row``
    draw. splitmix-style finalizer: stable across processes and platforms."""
    x = (a * 0x9E3779B9 + b) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


class FaultPlan:
    """A deterministic, seeded script of faults keyed by site name.

    ``sites`` maps a site to one :class:`FaultSpec` (or a list tried in
    order; the first matching spec that fires wins). The per-call draws come
    from one seeded stream, so the same plan against the same call sequence
    injects the same faults; ``per_row`` specs are a pure function of
    (plan seed, row seed) and are therefore stable under retries and
    re-dispatches too.
    """

    def __init__(self, rng_seed: int = 0,
                 sites: Optional[Dict[str, Union[FaultSpec, Sequence[FaultSpec]]]] = None):
        self.rng_seed = int(rng_seed)
        self.sites: Dict[str, Tuple[FaultSpec, ...]] = {}
        for name, spec in (sites or {}).items():
            specs = (spec,) if isinstance(spec, FaultSpec) else tuple(spec)
            self.sites[str(name)] = specs
        self._rng = random.Random(self.rng_seed)
        self._lock = threading.Lock()
        self.n_calls: Dict[str, int] = {}
        self.n_fired: Dict[str, int] = {}
        self._at_fired: set = set()

    # -- construction / serialisation ---------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.rng_seed,
             "sites": {name: ([s.to_dict() for s in specs]
                              if len(specs) != 1 else specs[0].to_dict())
                       for name, specs in self.sites.items()}},
            sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        d = json.loads(blob)
        sites = {}
        for name, spec in dict(d.get("sites", {})).items():
            if isinstance(spec, list):
                sites[name] = [FaultSpec.from_dict(s) for s in spec]
            else:
                sites[name] = FaultSpec.from_dict(spec)
        return cls(rng_seed=int(d.get("seed", 0)), sites=sites)

    # -- firing --------------------------------------------------------------

    def row_poisoned(self, spec: FaultSpec, row_seed: int) -> bool:
        return _mix32(self.rng_seed, int(row_seed)) < spec.p * 4294967296.0

    def _should_fire(self, site: str, spec: FaultSpec, ctx: dict,
                     call_idx: int) -> bool:
        if not spec.matches(ctx):
            return False
        fired = self.n_fired.get(site, 0)
        if spec.max_faults is not None and fired >= spec.max_faults:
            return False
        if spec.at:
            idx = ctx.get("index", call_idx)
            tag = (site, id(spec), int(idx))
            if int(idx) in spec.at and tag not in self._at_fired:
                self._at_fired.add(tag)
                return True
            return False
        if spec.per_row:
            seeds = ctx.get("row_seeds")
            if seeds is None:
                return False
            return any(self.row_poisoned(spec, s) for s in seeds)
        return self._rng.random() < spec.p

    def fire(self, site: str, ctx: dict) -> Optional[str]:
        """Evaluate the plan at ``site``: raise, sleep, exit, or return an
        action string for the caller to apply; None = no fault."""
        specs = self.sites.get(site)
        with self._lock:
            call_idx = self.n_calls.get(site, 0)
            self.n_calls[site] = call_idx + 1
            if not specs:
                return None
            hit = None
            for spec in specs:
                if self._should_fire(site, spec, ctx, call_idx):
                    hit = spec
                    break
            if hit is None:
                return None
            self.n_fired[site] = self.n_fired.get(site, 0) + 1
        return self._apply(site, hit)

    def _apply(self, site: str, spec: FaultSpec) -> Optional[str]:
        if spec.delay_s and spec.kind in ("hang", "timeout"):
            time.sleep(spec.delay_s)
        if spec.exc is not None:
            raise spec.exc(f"injected fault at {site}")
        if spec.kind == "raise":
            raise InjectedFault(f"injected fault at {site}")
        if spec.kind == "oserror":
            raise OSError(f"injected I/O fault at {site}")
        if spec.kind == "device_loss":
            raise InjectedDeviceLoss(f"injected device loss at {site}")
        if spec.kind == "timeout":
            raise InjectedTimeout(f"injected timeout at {site}")
        if spec.kind == "exit":
            os._exit(17)
        if spec.kind == "hang":
            return None
        return spec.kind          # torn_write / bit_flip: caller applies


# -- process-global plan ------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ENV_PLAN: Union[None, bool, FaultPlan] = None   # None = not yet parsed


def plan_from_env() -> Optional[FaultPlan]:
    """Parse ``REPRO_WS_FAULT_PLAN`` (JSON) into a plan, or None."""
    blob = os.environ.get(FAULT_PLAN_ENV, "").strip()
    if not blob:
        return None
    try:
        return FaultPlan.from_json(blob)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"unparsable {FAULT_PLAN_ENV}: {e}") from e


def install(plan: Optional[FaultPlan]) -> None:
    """Set (or with None: clear) the process-global fault plan. An installed
    plan overrides the environment plan."""
    global _ACTIVE
    _ACTIVE = plan


def active_plan() -> Optional[FaultPlan]:
    """The plan :func:`fault_point` consults: the installed one, else the
    ``REPRO_WS_FAULT_PLAN`` environment plan (parsed once)."""
    if _ACTIVE is not None:
        return _ACTIVE
    global _ENV_PLAN
    if _ENV_PLAN is None:
        _ENV_PLAN = plan_from_env() or False
    return _ENV_PLAN or None


def reload_env_plan() -> None:
    """Re-parse the environment plan (tests mutate the env var)."""
    global _ENV_PLAN
    _ENV_PLAN = None


@contextlib.contextmanager
def fault_plan(plan: Optional[FaultPlan]):
    """Scoped :func:`install`; ``fault_plan(no_faults())`` masks any ambient
    environment plan for a fault-free control run."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def no_faults() -> FaultPlan:
    """An empty plan — installing it shadows any environment plan."""
    return FaultPlan(rng_seed=0, sites={})


def fault_point(site: str, **ctx) -> Optional[str]:
    """The injection hook instrumented code calls. Near-free when no plan is
    active (one global read); otherwise evaluates the plan (may raise, sleep,
    exit the process, or return an action string)."""
    plan = active_plan()
    if plan is None:
        return None
    return plan.fire(site, ctx)


# -- retry / backoff ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with *full jitter*, capped by attempts and by a
    wall-clock deadline: sleep_k ~ U(0, min(cap_s, base_s·2^k)). Full jitter
    (rather than equal or decorrelated) because retries here guard shared
    resources — the store, a device — where synchronized retry stampedes
    are the failure mode being avoided."""
    max_attempts: int = 3
    base_s: float = 0.02
    cap_s: float = 1.0
    deadline_s: float = 30.0

    def sleep_s(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        bound = min(self.cap_s, self.base_s * (2.0 ** attempt))
        return (rng or random).uniform(0.0, bound)

    def call(self, fn: Callable, *, retry_on: tuple = (OSError,),
             metrics: Optional[obs.MetricsRegistry] = None,
             label: str = "", rng: Optional[random.Random] = None):
        """Run ``fn()`` retrying on ``retry_on`` until it succeeds, attempts
        run out, or the deadline passes; the last failure re-raises."""
        deadline = time.monotonic() + self.deadline_s
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                attempt += 1
                if attempt >= self.max_attempts \
                        or time.monotonic() >= deadline:
                    raise
                if metrics is not None:
                    metrics.counter("resilience.retries").inc()
                    if label:
                        metrics.counter("resilience.retries",
                                        {"op": label}).inc()
                time.sleep(self.sleep_s(attempt - 1, rng))



def decorrelated_jitter(prev_s: float, base_s: float, cap_s: float,
                        rng: Optional[random.Random] = None) -> float:
    """Next poll interval, decorrelated-jitter style: U(base, 3·prev) capped.
    Used by the broker's lock-wait loop so N waiters on one hot key spread
    out instead of stampeding the store in phase."""
    hi = max(base_s, 3.0 * prev_s)
    return min(cap_s, (rng or random).uniform(base_s, hi))


# -- circuit breaker ----------------------------------------------------------

#: breaker_state gauge values
BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0.0, 0.5, 1.0


class CircuitBreaker:
    """Per-key (backend-name) circuit breaker: trips OPEN after
    ``k_failures`` consecutive failures, rejects while open, lets one probe
    through per ``cooldown_s`` (HALF-OPEN), closes again on a success. State
    is exported as the ``resilience.breaker_state{backend=…}`` gauge
    (0 closed / 0.5 half-open / 1 open)."""

    def __init__(self, k_failures: int = 3, cooldown_s: float = 5.0,
                 metrics: Optional[obs.MetricsRegistry] = None):
        self.k_failures = int(k_failures)
        self.cooldown_s = float(cooldown_s)
        self.metrics = metrics if metrics is not None else obs.REGISTRY
        self._fails: Dict[str, int] = {}
        self._opened_at: Dict[str, float] = {}
        self._probing: set = set()

    def _gauge(self, name: str, state: float):
        self.metrics.gauge("resilience.breaker_state",
                           {"backend": name}).set(state)

    def state(self, name: str) -> float:
        if name not in self._opened_at:
            return BREAKER_CLOSED
        if time.monotonic() - self._opened_at[name] >= self.cooldown_s:
            return BREAKER_HALF_OPEN
        return BREAKER_OPEN

    def allow(self, name: str) -> bool:
        """May a dispatch go to ``name`` right now? Open → no; half-open →
        one probe per cooldown window."""
        st = self.state(name)
        if st == BREAKER_CLOSED:
            return True
        if st == BREAKER_HALF_OPEN and name not in self._probing:
            self._probing.add(name)
            self._gauge(name, BREAKER_HALF_OPEN)
            return True
        return False

    def record_success(self, name: str):
        self._fails[name] = 0
        self._probing.discard(name)
        if self._opened_at.pop(name, None) is not None:
            self._gauge(name, BREAKER_CLOSED)

    def record_failure(self, name: str, weight: int = 1):
        self._probing.discard(name)
        if name in self._opened_at:        # failed probe: restart cooldown
            self._opened_at[name] = time.monotonic()
            self._gauge(name, BREAKER_OPEN)
            return
        self._fails[name] = self._fails.get(name, 0) + int(weight)
        if self._fails[name] >= self.k_failures:
            self._opened_at[name] = time.monotonic()
            self.metrics.counter("resilience.breaker_trips",
                                 {"backend": name}).inc()
            self._gauge(name, BREAKER_OPEN)


# -- backend fallback chain ---------------------------------------------------

#: Demotion preference among the port's backends that run on the host: the
#: plain batched loop first, the serial oracle as the dependable floor. The
#: ``cuda`` backend is never a substitute (it has no CPU form) and never
#: gives way (see :func:`fallback_chain`).
FALLBACK_ORDER = ("torch", "oracle")


def backend_compatible(be, model) -> bool:
    """Can ``be`` produce bit-identical results for ``model``? The oracle
    twins model neither trace logging nor the capacity halts of the DAG and
    adaptive engines, so only the divisible model without ``log_trace`` may
    demote onto it (the rule the sanitizer's replay follows too)."""
    from repro_torch.core import divisible as dv
    from repro_torch.core import sweep as sw
    caps = be.capabilities()
    if not caps.available:
        return False
    model = sw.as_model(model)
    if model.p > caps.max_p:
        return False
    if caps.kind == "reference":
        return isinstance(model, dv.DivisibleModel) and not model.log_trace
    return True


def fallback_chain(primary: str, model, device=None) -> List[str]:
    """Ordered backend names a dispatch of ``model`` on ``device`` may run
    on. ``device`` follows the device rule (None is the card).

    A dispatch whose tensors lie on a CUDA device, and any dispatch on the
    ``cuda`` backend, gets its primary alone: nothing on the card gives way
    to the plain loop or to the host. On the CPU the chain is the primary,
    then every other compatible backend in :data:`FALLBACK_ORDER` — so a
    CPU ``torch`` dispatch of a divisible model may demote to ``oracle``.
    All entries are bit-identical on the same rows, so demotion is
    invisible in results and store keys."""
    from repro_torch.core import backend as bk
    from repro_torch.device import resolve_device
    if resolve_device(device).type == "cuda" or primary == "cuda":
        return [primary]
    chain = [primary]
    for name in FALLBACK_ORDER:
        if name == primary or name not in bk.backend_names():
            continue
        if backend_compatible(bk.get_backend(name), model):
            chain.append(name)
    return chain


# -- salvage dispatch ---------------------------------------------------------

#: Exception classes a dispatch failure must NOT recover from: these are
#: caller/config errors (a backend that cannot take the model, oversized p,
#: type errors), where retrying or demoting would only mask the bug.
NON_RECOVERABLE = (ValueError, TypeError, NotImplementedError, KeyError,
                   KeyboardInterrupt, SystemExit)


def non_recoverable_names() -> tuple:
    """Class names of :data:`NON_RECOVERABLE`, the single source a lint of
    ``except`` clauses matches against, so it can never drift from the
    runtime tuple."""
    return tuple(e.__name__ for e in NON_RECOVERABLE)


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for the broker's self-healing dispatch. ``enabled=False``
    restores the raise-through behaviour (one attempt, exceptions
    propagate)."""
    enabled: bool = True
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(max_attempts=2, base_s=0.02,
                                            cap_s=0.5, deadline_s=30.0))
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    salvage: bool = True

    def make_breaker(self, metrics=None) -> CircuitBreaker:
        return CircuitBreaker(self.breaker_failures, self.breaker_cooldown_s,
                              metrics=metrics)


def dispatch_resilient(call: Callable, rows, budgets, chain: Sequence[str],
                       *, retry: RetryPolicy, breaker: CircuitBreaker,
                       metrics: obs.MetricsRegistry,
                       salvage: bool = True) -> Tuple[object, bool]:
    """Run ``call(rows, budgets, backend_name, primary: bool)`` with retry,
    bisection salvage and fallback-chain demotion.

    Returns ``(GridResult, degraded)`` where ``degraded`` is True iff any
    failure was recovered along the way. Row order is preserved exactly
    (halves are concatenated back in order), and every backend in ``chain``
    is bit-identical, so the result is byte-identical to a fault-free
    dispatch of the same rows on the primary.

    Failure economics: a clean dispatch costs one call. One poisoned row in
    n costs O(log n) bisection dispatches on the primary plus one fallback
    dispatch for the poisoned row itself (where the chain has a second
    entry); the clean complement is counted on ``resilience.salvaged_rows``
    — rows rescued without recomputing the whole flush. With a chain of
    one, a row that fails on every attempt raises once bisection has
    isolated it.
    """
    from repro_torch.core import sweep as sw

    def attempt(rows, budgets, ci: int, top: bool) -> Tuple[object, bool]:
        """(grid, clean) for chain[ci]; clean = no failure in this subtree.
        ``top`` marks the initial whole-batch attempt; every salvage or
        fallback sub-dispatch passes False."""
        name = chain[ci]
        last = ci == len(chain) - 1
        if not last and not breaker.allow(name):
            metrics.counter("resilience.fallbacks").inc()
            grid, _ = attempt(rows, budgets, ci + 1, False)
            return grid, False
        err = None
        deadline = time.monotonic() + retry.deadline_s
        for k in range(max(1, retry.max_attempts)):
            if k:
                metrics.counter("resilience.retries").inc()
                metrics.counter("resilience.retries",
                                {"op": "dispatch"}).inc()
                time.sleep(retry.sleep_s(k - 1))
            try:
                grid = call(rows, budgets, name, top)
            except NON_RECOVERABLE:
                raise
            except Exception as e:          # noqa: BLE001 — recovery layer
                err = e
                metrics.counter("resilience.dispatch_failures",
                                {"backend": name}).inc()
                breaker.record_failure(
                    name, weight=(breaker.k_failures
                                  if isinstance(e, InjectedDeviceLoss)
                                  else 1))
                if time.monotonic() >= deadline:
                    break
            else:
                breaker.record_success(name)
                return grid, err is None
        n = len(rows)
        if salvage and n > 1:
            # Binary bisection: isolate the failing rows instead of
            # recomputing (or abandoning) the whole dispatch.
            mid = n // 2
            bl = br = None
            if budgets is not None:
                bl, br = budgets[:mid], budgets[mid:]
            with obs.span("resilience.salvage", backend=name, n_rows=n):
                gl, cl = attempt(rows.slice(0, mid), bl, ci, False)
                gr, cr = attempt(rows.slice(mid, n), br, ci, False)
            salvaged = (mid if cl else 0) + (n - mid if cr else 0)
            if salvaged:
                metrics.counter("resilience.salvaged_rows").inc(salvaged)
            return sw.concat_grids([gl, gr]), False
        if not last:
            metrics.counter("resilience.fallbacks").inc()
            with obs.span("resilience.fallback", n_rows=n,
                          src=name, dst=chain[ci + 1]):
                grid, _ = attempt(rows, budgets, ci + 1, False)
            return grid, False
        raise err

    grid, clean = attempt(rows, budgets, 0, True)
    return grid, not clean

# -- degradation summary ------------------------------------------------------

def degraded_summary(registry: obs.MetricsRegistry) -> dict:
    """The ``stats()["degraded"]`` payload: every recovery counter plus the
    set of currently open/half-open breakers; ``degraded`` is True iff the
    service has absorbed any fault since the registry was born."""
    snap = registry.snapshot()
    cs, gs = snap["counters"], snap["gauges"]

    def labeled_total(prefix: str) -> float:
        # Labeled-only series ("name{backend=…}"): sum over every label set.
        return sum(v for k, v in cs.items() if k.startswith(prefix + "{"))

    breakers = {k: v for k, v in gs.items()
                if k.startswith("resilience.breaker_state") and v > 0}
    out = dict(
        retries=cs.get("resilience.retries", 0),
        fallbacks=cs.get("resilience.fallbacks", 0),
        salvaged_rows=cs.get("resilience.salvaged_rows", 0),
        dispatch_failures=labeled_total("resilience.dispatch_failures"),
        breaker_trips=labeled_total("resilience.breaker_trips"),
        locks_broken=cs.get("store.locks_broken", 0),
        breakers_open=sorted(breakers),
    )
    out["degraded"] = bool(any(v for v in out.values()))
    return out
