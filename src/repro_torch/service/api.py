"""SimulationService: the public facade of the sweep service.

Callers ask a question (a topology and a scenario grid); the service routes
it through the content-addressed store, so a repeated question — from any
process sharing the store root, answered by any backend — is free.

    svc = SimulationService(root=tmpdir)
    g = svc.sweep(one_cluster(256, 1), W_list=[10**6], lam_list=[2, 62],
                  reps=256, chunk_size=256, backend="cuda")
    g.makespan, g.n_requests, g.extras["executed"]

The service runs on the GPU unless it is built with ``device="cpu"``; without
a CUDA device and without that argument the constructor raises.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

from repro_torch import obs
from repro_torch.core import engine as eng
from repro_torch.core.sweep import (GridResult, canonical_grid, lam_pair,
                                    resolve_model, run_grid)
from repro_torch.core.topology import Topology
from repro_torch.service import resilience as rz
from repro_torch.service import store as store_mod
from repro_torch.service.store import ResultStore


class SimulationService:
    """Facade wiring the store behind :meth:`sweep`."""

    def __init__(self, store: Optional[ResultStore] = None,
                 root: Optional[os.PathLike] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 device: eng.DeviceLike = None):
        self.device = eng.resolve_device(device)
        self.metrics = metrics if metrics is not None else obs.REGISTRY
        self.store = store if store is not None else ResultStore(
            root=root, metrics=self.metrics)
        if metrics is not None and store is not None:
            store.metrics = metrics     # one registry across the service

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
        bookkeeping on the caller."""
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
            self.store.put(ckey(ci), g,
                           meta={"grid": grid, "model": canon,
                                 "chunk": {"size": int(chunk_size),
                                           "idx": int(ci)}})
            if on_chunk is not None:
                on_chunk(ci, g)

        with obs.span("service.sweep", backend=str(backend)):
            return run_grid(topology, W_list=W_list, lam_list=lam_list,
                            reps=reps, theta=theta, seed0=seed0,
                            task_model=model, chunk_size=chunk_size,
                            on_chunk=persist, backend=backend,
                            device=self.device,
                            chunk_lookup=lambda ci: self.store.get(ckey(ci)))

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Service telemetry: store counters, the default backend, the
        recovery summary and the full metrics snapshot."""
        from repro_torch.core.backend import (default_backend_name,
                                              get_backend)
        default_backend = default_backend_name()
        n_devices = get_backend(default_backend).capabilities().n_devices
        m = self.metrics
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
                    default_backend=default_backend,
                    n_devices=n_devices,
                    device=str(self.device),
                    engine_version=eng.ENGINE_VERSION,
                    degraded=rz.degraded_summary(m),
                    metrics=snapshot)
