"""SimulationService: the public facade of the sweep service.

Turns the batched simulator into a query-answering system: callers ask
questions (a topology, a scenario grid, a statistical target) and get
per-cell estimates with confidence intervals back; the service routes every
question through the content-addressed store (repeat questions are free,
from any process sharing the store root, answered by any backend), the
coalescing broker (concurrent questions share kernel launches) and the
adaptive estimator (replication stops when the requested precision is met).

    svc = SimulationService(root=tmpdir)
    r = svc.query(one_cluster(64, 50), W_list=[10**6], lam_list=[50],
                  ci=0.01, ci_relative=True)       # 1% CI on E[Cmax]
    r.cells.mean, r.cells.half_width, r.cells.n
    g = svc.sweep(one_cluster(256, 1), W_list=[10**6], lam_list=[2, 62],
                  reps=256, chunk_size=256, backend="cuda")
    g.makespan, g.n_requests, g.extras["executed"]

The service runs on the GPU unless it is built with ``device="cpu"``; without
a CUDA device and without that argument the constructor raises.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.check import sanitizer as check_san
from repro_torch.core import engine as eng
from repro_torch.core.sweep import (GridResult, canonical_grid, lam_pair,
                                    resolve_model, run_grid)
from repro_torch.core.topology import Topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.service.broker import (PairedQuery, PairedResult,
                                        QueryBroker, QueryResult, SimQuery)
from repro_torch.service.estimator import (AdaptivePolicy, PairedPolicy,
                                           QuantilePolicy)
from repro_torch.service import resilience as rz
from repro_torch.service import store as store_mod
from repro_torch.service.store import ResultStore


class SimulationService:
    """Facade wiring store + broker + estimator behind :meth:`query` (one
    question), :meth:`query_many` (a coalesced batch), :meth:`query_pair`
    (a paired A/B comparison) and :meth:`sweep` (a store-backed chunked
    grid).

    ``mesh`` and ``shard_axes`` shard every dispatch's rows over a mesh
    (``sweep.simulate_sharded``; the broker's module docstring says what a
    mesh of several ranks changes): every rank builds its service on the
    same store root and asks the same questions."""

    def __init__(self, store: Optional[ResultStore] = None,
                 root: Optional[os.PathLike] = None,
                 confidence: float = 0.95, pad_pow2: bool = True,
                 relax_max_events: bool = True,
                 lock_wait_s: Optional[float] = 60.0,
                 straggler_sort: bool = True,
                 dispatch_log_max: Optional[int] = 1024,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 resilience: Optional[rz.ResilienceConfig] = None,
                 device: eng.DeviceLike = None, mesh=None,
                 shard_axes: Sequence[str] = ("data",)):
        self.device = eng.resolve_device(device)
        self.mesh, self.shard_axes = mesh, tuple(shard_axes)
        self.metrics = metrics if metrics is not None else obs.REGISTRY
        self.store = store if store is not None else ResultStore(
            root=root, metrics=self.metrics)
        if metrics is not None and store is not None:
            store.metrics = metrics     # one registry across the service
        self.broker = QueryBroker(store=self.store, confidence=confidence,
                                  pad_pow2=pad_pow2,
                                  relax_max_events=relax_max_events,
                                  lock_wait_s=lock_wait_s,
                                  straggler_sort=straggler_sort,
                                  dispatch_log_max=dispatch_log_max,
                                  metrics=self.metrics,
                                  resilience=resilience, device=self.device,
                                  mesh=mesh, shard_axes=shard_axes)
        self.confidence = float(confidence)

    # -- query construction -------------------------------------------------

    def make_query(
        self,
        topology: Topology,
        *,
        task_model="divisible",
        W_list: Sequence[int] = (0,),
        lam_list: Sequence = (1,),
        theta: Sequence = ((0, 0),),
        reps: int = 16,
        seed0: int = 1,
        remote_prob: float = 0.25,
        ci=None,
        ci_relative: bool = False,
        batch_reps: int = 16,
        max_reps: int = 1024,
        mwt: bool = False,
        max_events: Optional[int] = None,
        backend: Optional[str] = None,
        **model_kw,
    ) -> SimQuery:
        """Build a SimQuery. ``ci`` switches on adaptive estimation: either a
        target CI half-width (absolute time units, or a fraction of the mean
        when ``ci_relative``), or a full :class:`AdaptivePolicy` /
        :class:`QuantilePolicy` (the latter replicates until the streaming
        P² quantile CIs meet their target). ``backend`` selects the
        execution substrate; None lets the broker auto-select by the
        service's device (``cuda`` on the card, ``torch`` on the CPU). All
        backends are bit-identical and share cached answers."""
        lam_flat = [l for entry in lam_list for l in lam_pair(entry)]
        model = resolve_model(topology, task_model, W_list=W_list,
                              lam_list=lam_flat, mwt=mwt,
                              max_events=max_events, pow2_max_events=True,
                              backend=backend, **model_kw)
        if isinstance(ci, (AdaptivePolicy, QuantilePolicy)):
            adaptive = ci
        elif ci is not None:
            adaptive = AdaptivePolicy(
                ci_half_width=float(ci), relative=ci_relative,
                confidence=self.confidence, batch_reps=batch_reps,
                max_reps=max_reps)
        else:
            adaptive = None
        return SimQuery(
            model=model,
            W_list=tuple(int(w) for w in W_list),
            lam_list=tuple(
                tuple(l) if isinstance(l, (tuple, list)) else int(l)
                for l in lam_list),
            theta=tuple((int(a), int(b)) for a, b in theta),
            reps=int(reps), seed0=int(seed0),
            remote_prob=float(remote_prob), adaptive=adaptive,
            backend=backend)

    # -- execution ----------------------------------------------------------

    def query(self, topology: Topology, **kw) -> QueryResult:
        """Ask one question (cache -> coalesce -> simulate -> estimate)."""
        return self.query_many([self.make_query(topology, **kw)])[0]

    def query_many(
        self, queries: Sequence[Union[SimQuery, PairedQuery]]
    ) -> List[Union[QueryResult, PairedResult]]:
        """Answer a batch of concurrent questions in one coalesced flush."""
        with obs.span("service.query", n_queries=len(queries)) as sp:
            for q in queries:
                self.broker.submit(q)
            out = self.broker.flush()
            sp.set(n_cached=sum(1 for r in out if r.from_cache))
            return out

    def query_pair(self, query_a: SimQuery, query_b: SimQuery,
                   policy: Optional[PairedPolicy] = None) -> PairedResult:
        """A/B policy comparison under common random numbers: both arms run
        identical scenario rows (same seeds), and the answer carries a CI on
        the per-seed makespan difference — "is policy A faster, and by how
        much". With a :class:`PairedPolicy`, replication continues until the
        difference CI excludes zero (or meets the width target); build the
        arms with :meth:`make_query` (no ``ci``)."""
        return self.query_many(
            [PairedQuery(a=query_a, b=query_b, policy=policy)])[0]

    # -- store-backed resumable sweeps --------------------------------------

    def sweep(
        self,
        topology: Topology,
        *,
        task_model="divisible",
        W_list: Sequence[int] = (0,),
        lam_list: Sequence = (1,),
        theta: Sequence = ((0, 0),),
        reps: int = 1,
        seed0: int = 1,
        chunk_size: int = 1024,
        mwt: bool = False,
        max_events: Optional[int] = None,
        backend: Optional[str] = None,
        on_chunk: Optional[Callable[[int, GridResult], None]] = None,
        **model_kw,
    ) -> GridResult:
        """Store-backed chunked ``run_grid``: every chunk is keyed in the
        content-addressed store (``store.chunk_key``), persisted the moment
        it finishes, and looked up before being recomputed — so a sweep
        killed mid-run (any process, any host sharing the store root)
        resumes recomputing only the unfinished chunks, with no resume
        bookkeeping on the caller. Under a mesh of several ranks a chunk is
        looked up on every rank and taken from the store only if every rank
        finds it, and only the mesh's first rank writes the store; every
        rank returns the whole grid once the first rank's writes are in."""
        lam_flat = [l for entry in lam_list for l in lam_pair(entry)]
        model = resolve_model(topology, task_model, W_list=W_list,
                              lam_list=lam_flat, mwt=mwt,
                              max_events=max_events, backend=backend,
                              **model_kw)
        grid = canonical_grid(W_list, lam_list, reps, theta=theta,
                              seed0=seed0)
        canon = store_mod.canonical_model(model)

        def ckey(ci: int) -> str:
            return store_mod.chunk_key(model, grid, chunk_size, ci)

        def persist(ci: int, g: GridResult):
            if mesh_lib.is_writer(self.mesh):
                self.store.put(ckey(ci), g,
                               meta={"grid": grid, "model": canon,
                                     "chunk": {"size": int(chunk_size),
                                               "idx": int(ci)}})
            if on_chunk is not None:
                on_chunk(ci, g)

        def lookup(ci: int) -> Optional[GridResult]:
            g = self.store.get(ckey(ci))
            if mesh_lib.all_agree([g is not None], self.mesh)[0]:
                return g
            return None

        with obs.span("service.sweep", backend=str(backend)):
            out = run_grid(topology, W_list=W_list, lam_list=lam_list,
                           reps=reps, theta=theta, seed0=seed0,
                           task_model=model, chunk_size=chunk_size,
                           on_chunk=persist, backend=backend,
                           device=self.device, chunk_lookup=lookup,
                           mesh=self.mesh, shard_axes=self.shard_axes)
        mesh_lib.barrier(self.mesh)      # the first rank's writes are in
        return out

    # -- introspection ------------------------------------------------------

    @property
    def n_dispatches(self) -> int:
        return self.broker.n_dispatches

    def stats(self) -> dict:
        """Service telemetry. The flat keys are the dashboard shape (store
        and broker counters, the default backend, the recovery summary, the
        sanitizer's summary); ``metrics`` is the full metrics snapshot,
        spans' counter/gauge/histogram series included."""
        from repro_torch.core.backend import get_backend
        # The backend this service buckets a backend-less query on.
        default_backend = self.broker.default_backend
        n_devices = get_backend(default_backend,
                                self.device).capabilities().n_devices
        m = self.metrics
        m.gauge("broker.history_cells").set(len(self.broker.history))
        m.gauge("broker.dispatch_log_len").set(len(self.broker.dispatch_log))
        m.info("backend.default").set(default_backend)
        m.gauge("backend.n_devices").set(n_devices)
        m.info("engine.version").set(str(eng.ENGINE_VERSION))
        store_stats = self.store.stats()    # syncs the store.lru_len gauge
        snapshot = m.snapshot()
        if m is not obs.REGISTRY:
            # Backend instrumentation always writes to the global registry
            # (core must not depend on service wiring); graft those series
            # in so a private-registry snapshot is still complete.
            for kind, series in obs.REGISTRY.snapshot().items():
                for key, val in series.items():
                    if key.startswith(("engine.", "backend.")):
                        snapshot[kind].setdefault(key, val)
        return dict(store=store_stats,
                    n_dispatches=self.broker.n_dispatches,
                    n_cache_hits=self.broker.n_cache_hits,
                    n_queries=self.broker.n_queries,
                    n_lock_waits=self.broker.n_lock_waits,
                    n_lock_served=self.broker.n_lock_served,
                    n_dispatch_log_dropped=self.broker.n_dispatch_log_dropped,
                    n_history_cells=len(self.broker.history),
                    default_backend=default_backend,
                    n_devices=n_devices,
                    device=str(self.device),
                    engine_version=eng.ENGINE_VERSION,
                    degraded=rz.degraded_summary(m),
                    sanitizer=check_san.summary(),
                    metrics=snapshot)
