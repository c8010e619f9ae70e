"""Simulator engine (paper §3.6): scenario configuration + parallel sweeps.

The paper's simulator engine runs "several scenarios and simulation in the
same time". Here that is: build one batched Scenario per processor count
(shapes are static in p) and run the unified event core over the whole
(W, λ, θ, rep) cross product, for any task model (divisible, DAG, adaptive),
through an execution backend
(``repro_torch.core.backend``): the hand-written CUDA kernel, the plain
batched PyTorch loop, or the serial numpy oracle — all bit-identical.

Every entry point takes an explicit ``device``: ``None`` means the GPU and
raises ``RuntimeError`` without one; the CPU is used only when
``device="cpu"`` is passed.

With a ``mesh`` (a ``torch.distributed`` DeviceMesh, ``launch/mesh.py``)
the batch's rows are split over the mesh's ``shard_axes``: each rank runs
its contiguous shard (:func:`simulate_sharded`) and the ranks gather the
results, so every rank holds the whole answer, bit-identical to an
unsharded run. This is how the paper's Monte-Carlo workload maps to a
fleet.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import adaptive as ad
from repro_torch.core import dag as dg
from repro_torch.core import divisible
from repro_torch.core import engine as eng
from repro_torch.core.divisible import EngineConfig, Scenario, SimResult
from repro_torch.core.topology import Topology, one_cluster, remote_prob_u32

#: Scenario-level columns shared by every task model's result type.
_CORE_FIELDS = ("makespan", "n_requests", "n_success", "n_fail",
                "total_idle", "startup_end", "overflow")


def make_model(task_model: Union[str, eng.TaskModel] = "divisible", *,
               topology: Topology, mwt: bool = False,
               max_events: int = 1 << 20, log_trace: bool = False,
               max_trace: int = 0, dag=None, owner_lifo: bool = True,
               deque_cap: Optional[int] = None, merge_alpha: int = 1,
               merge_beta_num: int = 0, merge_beta_den: int = 16,
               pool_cap: int = 4096) -> eng.TaskModel:
    """Task-model factory: name -> configured TaskModel.

    ``task_model`` may also be an existing TaskModel/config (passed through /
    wrapped after checking it was built for ``topology``), so callers can
    hand sweeps either a name+kwargs or a prebuilt model.
    """
    if not isinstance(task_model, str):
        model = as_model(task_model)
        if model.topology != topology:
            raise ValueError("prebuilt task_model topology differs from "
                             "topology=")
        return model
    if task_model == "divisible":
        return divisible.DivisibleModel(EngineConfig(
            topology=topology, mwt=mwt, max_events=max_events,
            log_trace=log_trace, max_trace=max_trace))
    if task_model == "dag":
        if dag is None:
            raise ValueError("task_model='dag' requires dag=TaskDag(...)")
        return dg.DagModel(dg.DagEngineConfig(
            topology=topology, dag=dag, mwt=mwt, owner_lifo=owner_lifo,
            deque_cap=deque_cap, max_events=max_events,
            log_trace=log_trace, max_trace=max_trace))
    if task_model == "adaptive":
        return ad.AdaptiveModel(ad.AdaptiveEngineConfig(
            topology=topology, mwt=mwt, merge_alpha=merge_alpha,
            merge_beta_num=merge_beta_num, merge_beta_den=merge_beta_den,
            pool_cap=pool_cap,
            deque_cap=256 if deque_cap is None else deque_cap,
            max_events=max_events, log_trace=log_trace, max_trace=max_trace))
    raise ValueError(f"unknown task model {task_model!r}")


def as_model(m) -> eng.TaskModel:
    """Accept a TaskModel or any engine config and return a TaskModel."""
    if isinstance(m, EngineConfig):
        return divisible.DivisibleModel(m)
    if isinstance(m, dg.DagEngineConfig):
        return dg.DagModel(m)
    if isinstance(m, ad.AdaptiveEngineConfig):
        return ad.AdaptiveModel(m)
    if isinstance(m, eng.TaskModel):
        return m
    raise TypeError(f"not a task model or engine config: {type(m)!r}")


@dataclasses.dataclass
class GridResult:
    """Flat record-of-arrays over every (W, lam, theta, rep) cell for one p.

    ``extras`` holds model-specific per-cell columns (e.g. ``n_splits`` for
    adaptive sweeps, ``n_completed`` for DAG sweeps, per-proc ``executed``)
    and the intra-cluster latency.
    """
    p: int
    W: np.ndarray
    lam: np.ndarray
    theta_static: np.ndarray
    theta_comm: np.ndarray
    seed: np.ndarray
    makespan: np.ndarray
    n_requests: np.ndarray
    n_success: np.ndarray
    n_fail: np.ndarray
    total_idle: np.ndarray
    startup_end: np.ndarray
    overflow: np.ndarray
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __len__(self):
        return int(self.makespan.shape[0])


class GridRows(NamedTuple):
    """Flat canonical row set of a (W × λ × θ × rep) cross product.

    The single source of truth for cell ordering and per-row seeds — batch
    building, chunked execution and the service store's content addressing
    (``repro_torch.service.store``) all derive from it, so the same grid spec
    always produces bit-identical scenarios. Entries of ``lam_list`` may be
    single ints (both latencies equal, the paper's one-cluster sweeps) or
    ``(lam_local, lam_remote)`` pairs (multi-cluster fleets).
    """
    W: np.ndarray             # int32[n]
    lam_local: np.ndarray     # int32[n]
    lam_remote: np.ndarray    # int32[n]
    theta_static: np.ndarray  # int32[n]
    theta_comm: np.ndarray    # int32[n]
    seed: np.ndarray          # uint32[n]

    def __len__(self):
        return int(self.W.shape[0])

    def slice(self, lo: int, hi: int) -> "GridRows":
        return GridRows(*(a[lo:hi] for a in self))

    def take(self, idx) -> "GridRows":
        """Gather rows by any numpy fancy index (bool mask or positions),
        preserving the given order — the one sanctioned way to permute or
        subset a row set (broker straggler sort, adaptive re-replication,
        sanitizer replay sampling)."""
        idx = np.asarray(idx)
        return GridRows(*(np.asarray(a)[idx] for a in self))


def lam_pair(l) -> tuple:
    """Normalize a lam entry to an int (lam_local, lam_remote) pair."""
    if isinstance(l, (tuple, list, np.ndarray)):
        ll, lr = l
        return int(ll), int(lr)
    return int(l), int(l)


def row_seeds(n: int, seed0: int = 1, stream: int = 0) -> np.ndarray:
    """Deterministic per-row seeds. ``stream`` opens a fresh seed batch for
    the same grid — the adaptive estimator uses successive streams for
    successive Monte-Carlo replication rounds. The combined (stream, idx)
    index is multiplied by an odd constant (a bijection mod 2^32), so seeds
    are guaranteed collision-free for idx < 2^22 and stream < 2^10; stream 0
    reproduces the historical ``build_batch`` seeds bit-for-bit."""
    if n >= 1 << 22 or stream >= 1 << 10:
        raise ValueError(f"seed space exhausted: n={n}, stream={stream}")
    combined = np.arange(n, dtype=np.uint32) + np.uint32(int(stream) << 22)
    return combined * np.uint32(2654435761) + np.uint32(seed0)


def grid_rows(
    W_list: Sequence[int],
    lam_list: Sequence[int],
    reps: int,
    theta: Sequence[tuple] = ((0, 0),),
    seed0: int = 1,
    stream: int = 0,
) -> GridRows:
    """Canonical cross-product rows (W outer … rep inner) with seeds."""
    lams = [lam_pair(l) for l in lam_list]
    rows = list(itertools.product(W_list, lams, theta, range(reps)))
    return GridRows(
        W=np.array([r[0] for r in rows], np.int32),
        lam_local=np.array([r[1][0] for r in rows], np.int32),
        lam_remote=np.array([r[1][1] for r in rows], np.int32),
        theta_static=np.array([r[2][0] for r in rows], np.int32),
        theta_comm=np.array([r[2][1] for r in rows], np.int32),
        seed=row_seeds(len(rows), seed0, stream),
    )


def canonical_grid(
    W_list: Sequence[int],
    lam_list: Sequence[int],
    reps: int,
    theta: Sequence[tuple] = ((0, 0),),
    seed0: int = 1,
    remote_prob: float = 0.25,
) -> dict:
    """JSON-able canonical form of a grid spec (plain ints only; the float
    ``remote_prob`` is canonicalized through its u32 fixed-point encoding,
    which is also what the engine consumes). Two grid specs with equal
    canonical forms produce bit-identical scenario batches."""
    return {
        "W_list": [int(w) for w in W_list],
        "lam_list": [list(lam_pair(l)) for l in lam_list],
        "theta": [[int(a), int(b)] for a, b in theta],
        "reps": int(reps),
        "seed0": int(seed0),
        "remote_prob_u32": remote_prob_u32(float(remote_prob)),
    }


def scenario_from_rows(rows: GridRows, remote_prob: float = 0.25,
                       ev_budget=None,
                       device: eng.DeviceLike = None) -> Scenario:
    """Batched Scenario from canonical rows (λ sets both latency scalars),
    on ``device``.

    ``ev_budget`` (scalar or per-row array) fills the per-row event-budget
    column; None defers every row to the model's static ``max_events`` cap.
    """
    dev = eng.resolve_device(device)
    n = len(rows)
    budget = eng.INF32 if ev_budget is None else ev_budget
    return Scenario(
        W=eng._i32(rows.W, dev),
        seed=eng._u32(rows.seed, dev),
        lam_local=eng._i32(rows.lam_local, dev),
        lam_remote=eng._i32(rows.lam_remote, dev),
        theta_static=eng._i32(rows.theta_static, dev),
        theta_comm=eng._i32(rows.theta_comm, dev),
        remote_prob=eng._u32(
            np.full((n,), remote_prob_u32(float(remote_prob)), np.uint32),
            dev),
        max_events=eng._i32(
            np.broadcast_to(np.asarray(budget).astype(np.int32), (n,)), dev),
    )


def build_batch(
    W_list: Sequence[int],
    lam_list: Sequence[int],
    reps: int,
    theta: Sequence[tuple] = ((0, 0),),
    seed0: int = 1,
    remote_prob: float = 0.25,
    device: eng.DeviceLike = None,
) -> Scenario:
    """Cross-product Scenario batch. Seeds are distinct per cell."""
    return scenario_from_rows(grid_rows(W_list, lam_list, reps, theta, seed0),
                              remote_prob=remote_prob, device=device)


def grid_from_result(p: int, rows: GridRows, res) -> GridResult:
    """Assemble a :class:`GridResult` from canonical rows and the result
    tuple of a batched simulation over them (tensors on any device, or
    numpy arrays); this is where results cross to the host."""
    res = type(res)(*(_to_numpy(x) for x in res))
    extras = {k: v for k, v in res._asdict().items()
              if k in res._fields and k not in _CORE_FIELDS
              and k not in ("trace", "n_trace")}
    # lam (the sweep variable) is lam_remote; the intra-cluster latency rides
    # in extras so asymmetric (ICI/DCN) grids stay fully described.
    extras["lam_local"] = np.asarray(rows.lam_local)
    return GridResult(
        p=p,
        W=np.asarray(rows.W),
        lam=np.asarray(rows.lam_remote),
        theta_static=np.asarray(rows.theta_static),
        theta_comm=np.asarray(rows.theta_comm),
        seed=np.asarray(rows.seed),
        makespan=res.makespan,
        n_requests=res.n_requests,
        n_success=res.n_success,
        n_fail=res.n_fail,
        total_idle=res.total_idle,
        startup_end=res.startup_end,
        overflow=res.overflow,
        extras=extras,
    )


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np.asarray(x)
    return np.ascontiguousarray(x.detach().cpu().numpy())


def concat_grids(parts: Sequence[GridResult]) -> GridResult:
    """Concatenate chunked :class:`GridResult` pieces along the cell axis."""
    if not parts:
        raise ValueError("concat_grids needs at least one part")
    if len({g.p for g in parts}) != 1:
        raise ValueError("cannot concatenate grids of different p")
    if len(parts) == 1:
        return parts[0]
    fields = {
        f.name: np.concatenate([getattr(g, f.name) for g in parts])
        for f in dataclasses.fields(GridResult)
        if f.name not in ("p", "extras")
    }
    extras = {k: np.concatenate([g.extras[k] for g in parts])
              for k in parts[0].extras}
    return GridResult(p=parts[0].p, extras=extras, **fields)


def resolve_model(
    topo: Topology,
    task_model: Union[str, eng.TaskModel] = "divisible",
    W_list: Sequence[int] = (0,),
    lam_list: Sequence[int] = (1,),
    mwt: bool = False,
    max_events: Optional[int] = None,
    pow2_max_events: bool = False,
    backend=None,
    **model_kw,
) -> eng.TaskModel:
    """Grid-aware model construction shared by :func:`run_grid` and the
    service layer: defaults ``max_events`` from the worst (W, λ) cell.

    ``pow2_max_events`` rounds the *defaulted* cap up to a power of two.
    The cap only bounds the event loop (a finished simulation exits early,
    so a larger cap costs nothing), but it is static model config — rounding
    it buckets near-identical queries onto one compiled model, which is what
    lets the service broker coalesce them into one dispatch.

    ``backend`` (a name or :class:`~repro_torch.core.backend.ExecutionBackend`)
    validates the grid against the backend's capabilities up front (max p).
    It deliberately does NOT alter the model: the resolved model — and
    therefore every store/chunk key derived from its canonical form — must
    be identical whichever backend will execute it, or cross-backend cache
    sharing and chunked-sweep resume would silently break. Pow2 cap
    bounding for compile-count control happens either explicitly
    (``pow2_max_events``, as the service's ``make_query`` does) or at
    dispatch time in the broker, where it is invisible to keys.
    """
    if backend is not None:
        from repro_torch.core import backend as bk
        caps = bk.get_backend(backend).capabilities()
        if topo.p > caps.max_p:
            raise ValueError(
                f"backend {caps.name!r} supports p <= {caps.max_p}, "
                f"got p={topo.p}")
    if not isinstance(task_model, str):
        model = as_model(task_model)
        if mwt or max_events is not None or model_kw:
            raise ValueError(
                "prebuilt task_model carries its own config; mwt/max_events/"
                f"model kwargs {sorted(model_kw)} would be ignored")
        if model.topology != topo:
            raise ValueError("prebuilt task_model topology differs from topo")
        return model
    if max_events is None:
        dagf = model_kw.get("dag")
        W_eff = [dagf.total_work] if (task_model == "dag" and dagf is not None) \
            else [int(w) for w in W_list]
        lam_eff = {l for entry in lam_list for l in lam_pair(entry)}
        max_events = max(
            divisible.default_max_events(int(w), topo.p, int(l))
            for w in W_eff for l in lam_eff)
        if pow2_max_events:
            max_events = 1 << max(int(max_events) - 1, 1).bit_length()
    return make_model(task_model, topology=topo, mwt=mwt,
                      max_events=max_events, **model_kw)


def mesh_backend(backend, device: eng.DeviceLike = None):
    """The backend a mesh-sharded run uses: ``cuda`` on the card and
    ``torch`` on the CPU when ``backend`` is None (whatever
    ``REPRO_WS_BACKEND`` says: the JAX package pins its ``jax`` backend the
    same way); a named one must be one of those two."""
    from repro_torch.core import backend as bk
    dev = eng.resolve_device(device)
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "torch"
    be = bk.get_backend(backend, device=dev)
    if be.name not in ("cuda", "torch"):
        raise ValueError(f"mesh-sharded sweeps run the 'cuda' or the "
                         f"'torch' backend, got {be.name!r}")
    if be.name == "cuda" and dev.type != "cuda":
        raise RuntimeError("the 'cuda' backend launches a CUDA kernel and "
                           "has no CPU form: pass a CUDA device, or name "
                           "the 'torch' backend")
    return be


def run_rows(model: eng.TaskModel, rows: GridRows, remote_prob: float = 0.25,
             backend=None, ev_budget=None, devices=None,
             device: eng.DeviceLike = None, mesh=None,
             shard_axes: Sequence[str] = ("data",)) -> GridResult:
    """Run one batched simulation over canonical rows -> GridResult.

    ``device`` follows the device rule (module docstring). ``backend``
    selects the execution substrate (name, backend object, or None for
    auto-selection — see ``repro_torch.core.backend``); all backends are
    bit-identical on the same rows. On the GPU the backend shards contiguous
    row chunks across every local card (``devices=`` narrows the set).
    ``ev_budget`` is a per-row (or scalar) event budget truncating the loop
    below the model's static cap (exact — see ``engine.Scenario.max_events``).

    The selected backend runs every batch, whatever its size: an
    auto-selected ``cuda`` backend always launches the kernel, and nothing
    is sent to the host while ``device`` is the card.

    ``mesh`` splits the rows over its ``shard_axes`` (:func:`simulate_sharded`)
    on the backend :func:`mesh_backend` picks; every rank returns the whole
    grid.
    """
    from repro_torch.core import backend as bk
    dev = eng.resolve_device(device)
    if mesh is not None:
        be = mesh_backend(backend, dev)
        model = as_model(model)
        scn = scenario_from_rows(rows, remote_prob=remote_prob,
                                 ev_budget=ev_budget, device=dev)
        res = simulate_sharded(model, scn, mesh, shard_axes, backend=be)
        return grid_from_result(model.p, rows, res)
    be = bk.get_backend(backend, device=dev)
    return be.run_rows(model, rows, remote_prob=remote_prob,
                       ev_budget=ev_budget, devices=devices, device=dev)


def run_grid(
    topo: Topology,
    W_list: Sequence[int] = (0,),
    lam_list: Sequence[int] = (1,),
    reps: int = 1,
    theta: Sequence[tuple] = ((0, 0),),
    mwt: bool = False,
    max_events: Optional[int] = None,
    seed0: int = 1,
    task_model: Union[str, eng.TaskModel] = "divisible",
    chunk_size: Optional[int] = None,
    on_chunk: Optional[Callable[[int, GridResult], None]] = None,
    start_chunk: int = 0,
    chunk_lookup: Optional[Callable[[int], Optional[GridResult]]] = None,
    backend=None,
    device: eng.DeviceLike = None,
    mesh=None,
    shard_axes: Sequence[str] = ("data",),
    **model_kw,
) -> GridResult:
    """Simulate the full (W × λ × θ × reps) grid on topology ``topo``.

    ``task_model`` selects the task engine ("divisible" | "dag" | "adaptive",
    or a prebuilt TaskModel); ``model_kw`` is forwarded to
    :func:`make_model` (e.g. ``dag=``, ``merge_alpha=``). For DAG sweeps the
    workload is the static DAG, so ``W_list`` is typically left at ``(0,)``
    and the grid sweeps latency/threshold/rep only. A prebuilt
    model carries its own static config, so ``mwt``/``max_events``/
    ``model_kw`` must be left at their defaults and its topology must equal
    ``topo``. ``device`` follows the device rule (module docstring).

    ``backend`` selects the execution substrate per :func:`run_rows`; all
    backends produce bit-identical grids, so chunk persistence and resume
    are backend-free. ``mesh`` and ``shard_axes`` shard each chunk's rows
    (:func:`run_rows`).

    ``chunk_size`` splits the batch into fixed-size pieces executed one
    kernel launch at a time (bounds peak memory for huge grids) and makes
    the sweep *resumable*: chunk boundaries are deterministic functions of
    the grid spec, each finished chunk is handed to ``on_chunk(idx, grid)``
    for persistence, and a rerun with ``start_chunk=k`` recomputes only
    chunks ``>= k`` (stitch with :func:`concat_grids`). ``chunk_lookup``
    generalizes that to non-contiguous recovery: it is asked for each chunk
    first, and any non-None :class:`GridResult` it returns (e.g. from the
    content-addressed store — see ``SimulationService.sweep``) is used
    verbatim instead of recomputing; ``on_chunk`` only fires for chunks that
    were actually computed. ``start_chunk``/``chunk_lookup`` require
    ``chunk_size`` — without it the whole grid is one chunk 0 and a resume
    request would silently recompute and re-report everything.
    """
    if chunk_size is None and (start_chunk > 0 or chunk_lookup is not None):
        raise ValueError(
            "start_chunk/chunk_lookup require chunk_size=: without it the "
            "grid is a single chunk 0 and the resume request would be "
            "silently ignored")
    dev = eng.resolve_device(device)
    model = resolve_model(topo, task_model, W_list=W_list, lam_list=lam_list,
                          mwt=mwt, max_events=max_events, backend=backend,
                          **model_kw)
    rows = grid_rows(W_list, lam_list, reps, theta, seed0=seed0)

    if chunk_size is None:
        chunks = [(0, rows)]
    else:
        chunk_size = max(int(chunk_size), 1)
        chunks = [(ci, rows.slice(lo, lo + chunk_size))
                  for ci, lo in enumerate(range(0, len(rows), chunk_size))
                  if ci >= start_chunk]

    parts = []
    for ci, rws in chunks:
        g = chunk_lookup(ci) if chunk_lookup is not None else None
        if g is not None:
            if len(g) != len(rws) or not np.array_equal(
                    np.asarray(g.seed), np.asarray(rws.seed)):
                raise ValueError(
                    f"chunk_lookup returned a grid for chunk {ci} that does "
                    "not match the chunk's rows (stale store entry?)")
            parts.append(g)
            continue
        g = run_rows(model, rws, backend=backend, device=dev, mesh=mesh,
                     shard_axes=shard_axes)
        if on_chunk is not None:
            on_chunk(ci, g)
        parts.append(g)
    return concat_grids(parts)


def simulate_sharded(model, scn: Scenario, mesh,
                     shard_axes: Sequence[str] = ("data",), backend=None):
    """Shard the scenario batch axis over ``mesh``'s ``shard_axes`` and run
    each rank's shard.

    Works for any task model (``model`` may also be a bare engine config).
    Pads the batch to a multiple of the shard extent with rows whose every
    column is 1 (W=1: divisible/adaptive terminate immediately; DAG pad
    rows rerun the static DAG under a dummy seed; a budget of one event),
    as the JAX package does; the pad rows are dropped. Each rank runs its
    contiguous shard of the padded batch through ``backend``
    (:func:`mesh_backend`; on the card the ``ws_sim`` kernel), then the
    ranks gather the shards (``mesh.all_gather_shards``), so every rank
    returns the whole result, on ``scn``'s device.
    """
    from repro_torch.launch import mesh as mesh_lib
    model = as_model(model)
    dev = scn.W.device
    be = mesh_backend(backend, dev)
    extent = mesh_lib.axis_size(mesh, *shard_axes)
    n = int(scn.W.shape[0])
    pad = (-n) % extent
    if pad:
        scn = Scenario(*(torch.cat([x, torch.ones(pad, dtype=x.dtype,
                                                  device=dev)])
                         for x in scn))
    rows = (n + pad) // extent
    lo = mesh_lib.shard_index(mesh, shard_axes) * rows
    local = Scenario(*(x[lo:lo + rows] for x in scn))
    res = be.run_scenario(model, local)
    whole = type(res)(*(mesh_lib.all_gather_shards(x, mesh, shard_axes)
                        for x in res))
    return type(res)(*(x[:n] for x in whole))


def quick_sim(p: int, W: int, lam: int, seed: int = 1, mwt: bool = False,
              theta_static: int = 0, theta_comm: int = 0,
              device: eng.DeviceLike = None) -> SimResult:
    """One-liner single simulation on a one-cluster topology (the plain
    batched loop, on ``device``)."""
    topo = one_cluster(p, lam)
    cfg = EngineConfig(topology=topo, mwt=mwt,
                       max_events=divisible.default_max_events(W, p, lam))
    scn = divisible.make_scenario(W, seed, lam=lam, theta_static=theta_static,
                                  theta_comm=theta_comm, device=device)
    return divisible.simulate(cfg, scn)
