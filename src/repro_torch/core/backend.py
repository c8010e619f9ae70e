"""Pluggable execution backends.

The event loop is one piece of semantics; *where* it executes is a deployment
decision. This module makes that decision a value: an
:class:`ExecutionBackend` turns canonical grid rows into a
:class:`~repro_torch.core.sweep.GridResult`, and a registry maps names to the
three substrates the port ships —

* ``oracle`` — the serial numpy twin (``repro_torch.core.oracle``): slow,
               dependency-light ground truth, always on the host;
* ``torch``  — the plain batched PyTorch loop (``engine.simulate_batch``) on
               whatever device it is given;
* ``cuda``   — the hand-written Hopper kernel
               (``repro_torch.kernels.ws_sim``): per-scenario state resident
               in shared memory for the whole event loop. Available iff
               ``torch.cuda.is_available()``; it never gives way to ``torch``
               — a kernel that fails to build or launch raises.

Every backend is **bit-identical** on the same rows, which is why the
content-addressed result store needs no backend key component: a cache fill
from any backend serves every other.

**Device rule.** ``run_rows`` and ``get_backend(None)`` run on the GPU unless
the caller passes ``device="cpu"``; with no CUDA device and no explicit
``device="cpu"`` they raise ``RuntimeError``. Auto-selection
(:func:`default_backend_name`) honours the ``REPRO_WS_BACKEND`` environment
variable, else names ``cuda``; a caller that asked for the CPU by name gets
``torch`` from auto-selection, since the kernel has no CPU form.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import adaptive as ad
from repro_torch.core import dag as dg
from repro_torch.core import divisible as dv
from repro_torch.core import engine as eng
from repro_torch.core import oracle as orc
from repro_torch.core import sweep as sw

#: Environment override consumed by :func:`default_backend_name`.
BACKEND_ENV = "REPRO_WS_BACKEND"

_fault_point_impl = None


def _fault_point(site: str, **ctx):
    """Lazy bridge to ``repro_torch.service.resilience.fault_point`` —
    imported on first use so ``repro_torch.core`` keeps no module-level
    dependency on the service layer (the service imports core, not vice
    versa)."""
    global _fault_point_impl
    if _fault_point_impl is None:
        from repro_torch.service.resilience import fault_point
        _fault_point_impl = fault_point
    return _fault_point_impl(site, **ctx)


_sanitize_impl = None


def _sanitize(site: str, **ctx):
    """Lazy bridge to the opt-in determinism sanitizer
    (``repro_torch.check.sanitizer.probe``), same shape as
    :func:`_fault_point`: a disabled probe costs one env read per
    dispatch."""
    global _sanitize_impl
    if _sanitize_impl is None:
        from repro_torch.check.sanitizer import probe
        _sanitize_impl = probe
    return _sanitize_impl(site, **ctx)


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend can run, reported without executing anything."""
    name: str
    available: bool           # can run on this host right now
    kind: str                 # "reference" | "torch" | "cuda"
    devices: Tuple[str, ...]  # device types it would execute on
    max_p: int                # largest processor count supported
    max_events_pow2: bool     # dispatcher should round static caps to pow2
    note: str = ""
    n_devices: int = 1        # local devices run_rows shards rows across


def _cuda_devices() -> Tuple[torch.device, ...]:
    if not torch.cuda.is_available():
        return ()
    return tuple(torch.device("cuda", k)
                 for k in range(torch.cuda.device_count()))


class ExecutionBackend:
    """One execution substrate: rows in, GridResult out.

    Subclasses implement :meth:`_run_batch` (model + batched Scenario on one
    device -> the model's result NamedTuple with a leading batch axis) and
    :meth:`capabilities`; :meth:`run_rows` is the shared entry point used by
    ``sweep.run_rows`` and the service. On the GPU ``run_rows`` shards row
    chunks across every local card by default (``devices=`` narrows the
    set); chunk launches are issued back-to-back before any result is pulled
    to the host, so cards compute concurrently.
    """

    name = "?"
    #: a device chunk smaller than this is not worth a separate dispatch
    min_rows_per_device = 8

    def __init__(self):
        self.n_run_rows = 0     # dispatch counter (test/bench telemetry)

    def capabilities(self) -> BackendCapabilities:
        raise NotImplementedError

    def local_devices(self, device: torch.device) -> tuple:
        """Devices this backend shards row chunks across when asked to run
        on ``device``: every local card for a GPU run, the CPU alone
        otherwise."""
        if device.type == "cuda":
            return _cuda_devices()
        return (device,)

    def _run_batch(self, model: eng.TaskModel, scn: eng.Scenario):
        raise NotImplementedError

    def _check(self, model: eng.TaskModel):
        caps = self.capabilities()
        if not caps.available:
            raise RuntimeError(
                f"backend {self.name!r} is not available on this host"
                + (f" ({caps.note})" if caps.note else ""))
        if model.p > caps.max_p:
            raise ValueError(
                f"backend {self.name!r} supports p <= {caps.max_p}, "
                f"got p={model.p}")

    def _device_chunks(self, n: int, devices: Sequence):
        """Contiguous balanced (lo, hi, device) row chunks, one per device
        actually worth dispatching to."""
        devs = tuple(devices)
        nd = max(1, min(len(devs), n // max(self.min_rows_per_device, 1)))
        bounds = np.linspace(0, n, nd + 1).astype(int)
        return [(int(lo), int(hi), devs[k])
                for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))
                if hi > lo]

    def run_rows(self, model, rows: "sw.GridRows", remote_prob: float = 0.25,
                 ev_budget=None, devices: Optional[Sequence] = None,
                 device: eng.DeviceLike = None) -> "sw.GridResult":
        """Run one batched simulation over canonical rows.

        ``ev_budget`` is an optional per-row (or scalar) event budget; rows
        behave exactly as if the model's static ``max_events`` were their
        budget (see ``engine.Scenario.max_events``). ``device`` follows the
        device rule; ``devices`` narrows the set row chunks are sharded
        across (default: every local card for a GPU run).
        """
        dev = eng.resolve_device(device)
        model = sw.as_model(model)
        self._check(model)
        # Chaos hook (repro_torch.service.resilience): a process-global
        # FaultPlan may raise/hang here to simulate backend failure or
        # device loss. No-op without a plan.
        _fault_point("backend.run_rows", backend=self.name,
                     n_rows=len(rows), row_seeds=np.asarray(rows.seed))
        self.n_run_rows += 1
        obs.REGISTRY.counter("backend.run_rows",
                             {"backend": self.name}).inc()
        with obs.span("backend.run_rows", backend=self.name,
                      n_rows=len(rows)):
            devs = (tuple(torch.device(d) for d in devices)
                    if devices is not None else self.local_devices(dev))
            out = self._run_rows(model, rows, remote_prob, ev_budget, devs)
            # Sanitizer: steal-accounting check + seeded oracle replay of a
            # sampled dispatch (repro_torch.check.sanitizer). No-op when
            # disabled.
            _sanitize("backend.result", backend=self, model=model,
                      rows=rows, remote_prob=remote_prob,
                      ev_budget=ev_budget, grid=out)
            return out

    def _run_rows(self, model, rows, remote_prob, ev_budget, devices):
        n = len(rows)
        chunks = self._device_chunks(n, devices)
        if len(chunks) <= 1:
            dev = chunks[0][2] if chunks else devices[0]
            scn = sw.scenario_from_rows(rows, remote_prob=remote_prob,
                                        ev_budget=ev_budget, device=dev)
            return sw.grid_from_result(model.p, rows,
                                       self._run_batch(model, scn))
        budgets = None if ev_budget is None else np.broadcast_to(
            np.asarray(ev_budget, np.int64), (n,))
        outs = []
        for lo, hi, dev in chunks:  # dispatch everything before any sync
            scn = sw.scenario_from_rows(
                rows.slice(lo, hi), remote_prob=remote_prob,
                ev_budget=None if budgets is None else budgets[lo:hi],
                device=dev)
            outs.append(self._run_batch(model, scn))
        return sw.concat_grids(
            [sw.grid_from_result(model.p, rows.slice(lo, hi), res)
             for (lo, hi, _), res in zip(chunks, outs)])


class OracleBackend(ExecutionBackend):
    """Serial numpy reference: loops the oracle twin row by row, on the host
    whatever ``device`` says.

    Deliberately slow; exists so any result of any other backend can be
    reproduced with no tensor library in the loop. Does not model trace
    logging — configs using it belong on the other backends.

    The DAG and adaptive twins keep their deques and task pool in unbounded
    lists, so they cannot see ``deque_cap`` or ``pool_cap``. Where a cap
    could bind, this backend raises instead of returning a row that would
    differ from the engine's (and would poison the store shared by every
    backend): a DAG model whose ``deque_cap`` is below its task count (a
    deque position can reach n - 1); an adaptive model whose ``deque_cap``
    is below 1; an adaptive row that created more than ``pool_cap`` tasks.
    An adaptive deque with one slot or more never binds: a merge readied by
    a completion is popped in the same idle event, so every push finds the
    deque empty at position 0.
    """

    name = "oracle"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.name, available=True, kind="reference",
            devices=("cpu",), max_p=256, max_events_pow2=False,
            note="serial python loop; no capacity or trace modelling")

    def _run_rows(self, model, rows, remote_prob, ev_budget,
                  devices) -> "sw.GridResult":
        if model.log_trace:
            raise ValueError("oracle backend does not record traces; "
                             "use the 'torch' backend for log_trace models")
        if not isinstance(model, (dv.DivisibleModel, dg.DagModel,
                                  ad.AdaptiveModel)):
            raise TypeError(f"oracle backend has no twin for {type(model)!r}")
        if isinstance(model, dg.DagModel) and \
                model.cfg.cap < model.cfg.dag.n:
            raise ValueError(
                f"oracle backend: deque_cap={model.cfg.cap} is below the "
                f"DAG's {model.cfg.dag.n} tasks and the numpy twin cannot see "
                "it; use the 'torch' or 'cuda' backend")
        if isinstance(model, ad.AdaptiveModel) and model.cfg.deque_cap < 1:
            raise ValueError(
                f"oracle backend: deque_cap={model.cfg.deque_cap} halts at "
                "the first push and the numpy twin cannot see it")
        n = len(rows)
        budgets = np.broadcast_to(
            np.asarray(eng.INF32 if ev_budget is None else ev_budget,
                       np.int64), (n,))
        outs = [self._run_row(model, rows, k,
                              min(int(model.max_events), int(budgets[k])),
                              float(remote_prob))
                for k in range(n)]
        res = type(outs[0])(*(np.stack(leaves) for leaves in zip(*outs)))
        return sw.grid_from_result(model.p, rows, res)

    def _run_row(self, model, rows, k: int, max_events: int, rp: float):
        kw = dict(seed=int(rows.seed[k]),
                  lam_local=int(rows.lam_local[k]),
                  lam_remote=int(rows.lam_remote[k]),
                  mwt=model.mwt, remote_prob=rp, max_events=max_events)
        i32 = np.int32
        trace = np.zeros((1, 4), np.int32)     # log_trace=False engine shape
        if isinstance(model, dv.DivisibleModel):
            o = orc.simulate_oracle(
                model.topology, int(rows.W[k]),
                theta_static=int(rows.theta_static[k]),
                theta_comm=int(rows.theta_comm[k]), **kw)
            return dv.SimResult(
                makespan=i32(o.makespan), n_events=i32(o.n_events),
                n_requests=i32(o.n_requests), n_success=i32(o.n_success),
                n_fail=i32(o.n_fail), total_idle=i32(o.total_idle),
                startup_end=i32(o.startup_end),
                executed=np.asarray(o.executed, np.int32),
                overflow=np.bool_(o.overflow), trace=trace,
                n_trace=i32(0))
        if isinstance(model, dg.DagModel):
            o = orc.simulate_dag_oracle(
                model.topology, model.cfg.dag,
                theta_static=int(rows.theta_static[k]),
                owner_lifo=model.cfg.owner_lifo, **kw)
            return dg.DagSimResult(
                makespan=i32(o["makespan"]), n_events=i32(o["n_events"]),
                n_requests=i32(o["n_requests"]),
                n_success=i32(o["n_success"]), n_fail=i32(o["n_fail"]),
                total_idle=i32(o["total_idle"]),
                startup_end=i32(o["startup_end"]),
                executed=np.asarray(o["executed"], np.int32),
                tasks_run=np.asarray(o["tasks_run"], np.int32),
                n_completed=i32(o["n_completed"]),
                overflow=np.bool_(o["overflow"]), trace=trace,
                n_trace=i32(0))
        cfg = model.cfg
        o = orc.simulate_adaptive_oracle(
            model.topology, int(rows.W[k]),
            theta_static=int(rows.theta_static[k]),
            theta_comm=int(rows.theta_comm[k]),
            merge_alpha=cfg.merge_alpha, merge_beta_num=cfg.merge_beta_num,
            merge_beta_den=cfg.merge_beta_den, **kw)
        if o["n_created"] > cfg.pool_cap:
            raise ValueError(
                f"oracle backend: row {k} created {o['n_created']} tasks, "
                f"more than pool_cap={cfg.pool_cap}; the numpy twin cannot "
                "see the cap, so the engine's answer differs. Use the "
                "'torch' or 'cuda' backend")
        return ad.AdaptiveSimResult(
            makespan=i32(o["makespan"]), n_events=i32(o["n_events"]),
            n_requests=i32(o["n_requests"]),
            n_success=i32(o["n_success"]), n_fail=i32(o["n_fail"]),
            n_splits=i32(o["n_splits"]),
            total_idle=i32(o["total_idle"]),
            startup_end=i32(o["startup_end"]),
            executed=np.asarray(o["executed"], np.int32),
            total_merge_work=i32(o["total_merge_work"]),
            n_created=i32(o["n_created"]),
            n_completed=i32(o["n_completed"]),
            overflow=np.bool_(o["overflow"]), trace=trace,
            n_trace=i32(0))


class TorchBackend(ExecutionBackend):
    """The plain batched PyTorch loop, on whatever device it is given. It is
    the kernel's plain version, and what the CPU tests run."""

    name = "torch"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.name, available=True, kind="torch",
            devices=("cpu",) + (("cuda",) if _cuda_devices() else ()),
            max_p=1 << 14, max_events_pow2=False,
            n_devices=max(len(_cuda_devices()), 1))

    def _run_batch(self, model, scn):
        return eng.simulate_batch(model, scn)


class CudaBackend(ExecutionBackend):
    """The hand-written Hopper kernel: one warp per scenario, a body per
    task model, the processors' state in registers up to p = 256 and in
    shared memory above (``kernels.ws_sim.variant``). One launch per row
    chunk."""

    name = "cuda"

    def capabilities(self) -> BackendCapabilities:
        devs = _cuda_devices()
        return BackendCapabilities(
            name=self.name, available=bool(devs), kind="cuda",
            devices=("cuda",) if devs else (), max_p=1024,
            max_events_pow2=False,
            note="" if devs else "needs a CUDA device; use 'torch' or "
                                 "'oracle' with device='cpu'",
            n_devices=max(len(devs), 1))

    def _run_rows(self, model, rows, remote_prob, ev_budget, devices):
        if any(d.type != "cuda" for d in devices):
            raise RuntimeError(
                "the 'cuda' backend launches a CUDA kernel and has no CPU "
                "form: pass a CUDA device, or name the 'torch' backend")
        return super()._run_rows(model, rows, remote_prob, ev_budget, devices)

    def _run_batch(self, model, scn):
        from repro_torch.kernels.ws_sim import ws_sim_cuda
        return ws_sim_cuda(model, scn)


_REGISTRY: Dict[str, ExecutionBackend] = {}


def register_backend(backend: ExecutionBackend) -> ExecutionBackend:
    """Add (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


for _b in (OracleBackend(), TorchBackend(), CudaBackend()):
    register_backend(_b)


def backend_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def available_backends() -> Tuple[ExecutionBackend, ...]:
    return tuple(b for b in _REGISTRY.values() if b.capabilities().available)


def default_backend_name() -> str:
    """Auto-selected backend: ``REPRO_WS_BACKEND`` env override, else
    ``cuda``."""
    env = os.environ.get(BACKEND_ENV, "").strip()
    if env:
        if env not in _REGISTRY:
            raise ValueError(
                f"{BACKEND_ENV}={env!r} is not a registered backend; "
                f"choose one of {backend_names()}")
        return env
    return "cuda"


def get_backend(
    backend: Union[None, str, ExecutionBackend] = None,
    device: eng.DeviceLike = None,
) -> ExecutionBackend:
    """Resolve a backend argument: None -> auto-select, str -> registry
    lookup, ExecutionBackend -> itself.

    Auto-selection follows the device rule: with ``device=None`` it needs a
    CUDA device and raises ``RuntimeError`` without one; a caller that
    passes ``device="cpu"`` gets the ``torch`` backend unless
    ``REPRO_WS_BACKEND`` names another."""
    if backend is None:
        dev = eng.resolve_device(device)
        name = default_backend_name()
        if dev.type != "cuda" and not os.environ.get(BACKEND_ENV, "").strip():
            name = "torch"
        return _REGISTRY[name]
    if isinstance(backend, ExecutionBackend):
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{backend_names()}") from None
