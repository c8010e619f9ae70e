"""Batched work-stealing simulations on the GPU: the wrapper of the
hand-written Hopper kernel ``csrc/ws_sim.cu`` (one warp per scenario, the
per-processor engine state in shared memory for the entire event loop, one
kernel body per task model).

It replaces ``ws_sim_pallas`` of the JAX package for the divisible-load, DAG
and adaptive task models. The design, and what bounds the kernel on this
card, are written at the head of the CUDA source. Its plain version is
:func:`ws_sim_ref` (``engine.simulate_batch``): every leaf of both is
bit-identical.

:func:`ws_sim_cuda` launches the kernel for tensors on a CUDA device and
raises if it cannot; only for tensors that lie on the CPU does it run the
plain version. ``ws_sim_cuda.launches`` counts kernel launches, and nothing
else; ``ws_sim_cuda.launches_by_body`` splits that count by kernel body.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import adaptive as ad
from repro_torch.core import dag as dg
from repro_torch.core import divisible as dv
from repro_torch.core import engine as eng
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ws_sim_ref

MAX_P = 1024
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ws_sim.cu"

#: kernel body (and its launcher ``ws_sim_<body>_launch``) per task model
BODIES = {dv.DivisibleModel: "divisible", dg.DagModel: "dag",
          ad.AdaptiveModel: "adaptive"}
_BODY_ID = {"divisible": 0, "dag": 1, "adaptive": 2}   # enum Model in the .cu
_CONFIGS = {dv.EngineConfig: dv.DivisibleModel,
            dg.DagEngineConfig: dg.DagModel,
            ad.AdaptiveEngineConfig: ad.AdaptiveModel}

# leaves that hold uint32 values as int64; every other leaf is int32
_U32_LEAVES = ("seed", "remote_prob")

# rows of the kernel's [13, G] scalar output, in order
_SCALAR_ROWS = ("makespan", "n_events", "n_requests", "n_success", "n_fail",
                "total_idle", "startup_end", "overflow", "n_trace",
                "n_completed", "n_splits", "total_merge_work", "n_created")

_PTR_FIELDS = ("cid", "hops", "W", "seed", "lam_local", "lam_remote",
               "theta_static", "theta_comm", "remote_prob", "max_events",
               "out_scalars", "out_executed", "out_tasks_run", "out_trace",
               "dur", "child_ptr", "child_idx", "pred_count", "slab")
_INT_FIELDS = ("G", "p", "strategy", "mwt", "model_max_events", "log_trace",
               "max_trace", "trace_rows", "n_tasks", "cap", "owner_lifo",
               "src", "pool_cap", "merge_alpha", "merge_beta_num",
               "merge_beta_den")


class WsParams(ctypes.Structure):
    """Mirror of ``WsParams`` in ``csrc/ws_sim.cu``: the same fields in the
    same order, 64-bit fields first (so no padding between fields)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [("slab_stride", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


def kernel_name(model) -> str:
    """The name a body goes by in counts and reports: ``ws_sim_<body>``."""
    return f"ws_sim_{BODIES[type(model)]}"


def _lib() -> ctypes.CDLL:
    lib = _build.load("ws_sim")
    if lib.ws_sim_error_string.restype is not ctypes.c_char_p:
        for body in BODIES.values():
            fn = getattr(lib, f"ws_sim_{body}_launch")
            fn.argtypes = [ctypes.POINTER(WsParams), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ws_sim_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ws_sim_shared_bytes.restype = ctypes.c_int
        for fn in (lib.ws_sim_scalar_rows, lib.ws_sim_params_bytes):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if lib.ws_sim_scalar_rows() != len(_SCALAR_ROWS) or \
                lib.ws_sim_params_bytes() != ctypes.sizeof(WsParams):
            raise RuntimeError("ws_sim.cu and its wrapper disagree on the "
                               "scalar output rows or the parameter block")
        lib.ws_sim_error_string.argtypes = [ctypes.c_int]
        lib.ws_sim_error_string.restype = ctypes.c_char_p
    return lib


def _check_scenario(scn: eng.Scenario) -> int:
    dev = scn.W.device
    G = None
    for name, leaf in zip(scn._fields, scn):
        want = torch.int64 if name in _U32_LEAVES else torch.int32
        if leaf.dtype != want:
            raise TypeError(f"scenario leaf {name}: expected {want}, "
                            f"got {leaf.dtype}")
        if leaf.ndim != 1:
            raise ValueError(f"scenario leaf {name}: expected a [G] vector, "
                             f"got shape {tuple(leaf.shape)}")
        if G is None:
            G = int(leaf.shape[0])
        if int(leaf.shape[0]) != G:
            raise ValueError(f"scenario leaf {name}: length {leaf.shape[0]} "
                             f"differs from {G}")
        if leaf.device != dev:
            raise ValueError(f"scenario leaf {name} lies on {leaf.device}, "
                             f"W on {dev}")
        if not leaf.is_contiguous():
            raise ValueError(f"scenario leaf {name} is not contiguous")
    return G


def _check_model(model) -> None:
    cfg = model.cfg
    if isinstance(model, dg.DagModel):
        if cfg.dag.n < 1 or cfg.cap < 1:
            raise ValueError(f"ws_sim_cuda needs a DAG with tasks and a "
                             f"deque capacity >= 1, got n={cfg.dag.n}, "
                             f"cap={cfg.cap}")
    elif isinstance(model, ad.AdaptiveModel):
        if cfg.pool_cap < 1 or cfg.deque_cap < 1 or cfg.merge_beta_den == 0:
            raise ValueError(f"ws_sim_cuda needs pool_cap >= 1, deque_cap >= "
                             f"1 and merge_beta_den != 0, got {cfg}")


def slab_words(model) -> int:
    """int32 words of the per-row global scratch slab of a model's body."""
    cfg = model.cfg
    if isinstance(model, dg.DagModel):
        return cfg.dag.n + model.p * cfg.cap
    if isinstance(model, ad.AdaptiveModel):
        return 4 * cfg.pool_cap + model.p * cfg.deque_cap
    return 0


def ws_sim_cuda(model, scn: eng.Scenario):
    """Batched simulation; ``scn`` leaves have leading batch dim G.

    ``model`` is a :class:`DivisibleModel`, :class:`DagModel` or
    :class:`AdaptiveModel`, or the engine config of one. Returns the model's
    result NamedTuple with a leading G axis on every leaf, on the device of
    ``scn``, bit-identical to ``engine.simulate_batch``. The kernel is
    launched on the current stream of that device and not waited for.
    """
    for cfg_type, model_type in _CONFIGS.items():
        if isinstance(model, cfg_type):
            model = model_type(model)
    if type(model) not in BODIES:
        raise NotImplementedError(
            f"ws_sim_cuda has kernel bodies for the divisible, DAG and "
            f"adaptive task models, got {type(model).__name__}")
    p = model.p
    if p > MAX_P or p < 2:
        raise ValueError(f"ws_sim_cuda supports 2 <= p <= {MAX_P}, got p={p}")
    _check_model(model)
    G = _check_scenario(scn)
    dev = scn.W.device
    if dev.type == "cpu":
        return ws_sim_ref(model, scn)
    if dev.type != "cuda":
        raise RuntimeError(f"ws_sim_cuda runs on CUDA devices, got {dev}")

    body = BODIES[type(model)]
    topo = model.topology
    cfg = model.cfg
    trace_rows = max(model.max_trace, 1) if model.log_trace else 1
    i32 = torch.int32
    with torch.cuda.device(dev):
        cid = torch.as_tensor(np.ascontiguousarray(topo.cluster_id, np.int32),
                              device=dev)
        hops = torch.as_tensor(np.ascontiguousarray(topo.hops, np.int32),
                               device=dev)
        scalars = torch.empty((len(_SCALAR_ROWS), G), dtype=i32, device=dev)
        executed = torch.empty((G, p), dtype=i32, device=dev)
        tasks_run = torch.empty((G, p) if body == "dag" else (0,), dtype=i32,
                                device=dev)
        trace = torch.empty((G, trace_rows, 4), dtype=i32, device=dev)
        words = slab_words(model)
        slab = torch.empty((G, words) if words else (0,), dtype=i32,
                           device=dev)
        ins = dict(zip(_PTR_FIELDS[:10], (cid, hops) + tuple(scn)))
        prm = WsParams(
            **{f: x.data_ptr() for f, x in ins.items()},
            out_scalars=scalars.data_ptr(), out_executed=executed.data_ptr(),
            out_tasks_run=tasks_run.data_ptr(), out_trace=trace.data_ptr(),
            slab=slab.data_ptr(), slab_stride=words,
            G=G, p=p, strategy=int(topo.strategy), mwt=int(bool(model.mwt)),
            model_max_events=int(min(int(model.max_events), int(eng.INF32))),
            log_trace=int(bool(model.log_trace)),
            max_trace=int(model.max_trace), trace_rows=trace_rows)
        if body == "dag":
            # the DAG's CSR arrays: read-only, shared by every row (L2)
            arrays = model.static_arrays(dev)
            for f, x in zip(("dur", "child_ptr", "child_idx", "pred_count"),
                            arrays):
                setattr(prm, f, x.data_ptr())
            prm.n_tasks, prm.cap = cfg.dag.n, cfg.cap
            prm.owner_lifo = int(bool(cfg.owner_lifo))
            prm.src = int(cfg.dag.sources[0])
        elif body == "adaptive":
            prm.cap, prm.pool_cap = cfg.deque_cap, cfg.pool_cap
            prm.merge_alpha = cfg.merge_alpha
            prm.merge_beta_num = cfg.merge_beta_num
            prm.merge_beta_den = cfg.merge_beta_den
        # The temporaries (topology, slab, DAG arrays) go back to PyTorch's
        # caching allocator when this returns, before the kernel ends; it
        # hands their memory only to work on the same stream, which runs
        # after the kernel.
        if G > 0:
            lib = _lib()
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"ws_sim_{body}_launch")(ctypes.byref(prm),
                                                        stream)
            if err != 0:
                msg = lib.ws_sim_error_string(err).decode()
                smem = lib.ws_sim_shared_bytes(_BODY_ID[body], p)
                raise RuntimeError(
                    f"ws_sim {body} kernel launch failed (G={G}, p={p}, "
                    f"shared bytes={smem}, slab words per row={words}): "
                    f"CUDA error {err}: {msg}")
            ws_sim_cuda.launches += 1
            ws_sim_cuda.launches_by_body[kernel_name(model)] += 1
    row = dict(zip(_SCALAR_ROWS, scalars))
    core = dict(makespan=row["makespan"], n_events=row["n_events"],
                n_requests=row["n_requests"], n_success=row["n_success"],
                n_fail=row["n_fail"], total_idle=row["total_idle"],
                startup_end=row["startup_end"], executed=executed,
                overflow=row["overflow"] != 0, trace=trace,
                n_trace=row["n_trace"])
    if body == "dag":
        return dg.DagSimResult(tasks_run=tasks_run,
                               n_completed=row["n_completed"], **core)
    if body == "adaptive":
        return ad.AdaptiveSimResult(
            n_splits=row["n_splits"],
            total_merge_work=row["total_merge_work"],
            n_created=row["n_created"], n_completed=row["n_completed"],
            **core)
    return dv.SimResult(**core)


def reset_counts() -> None:
    """Set every launch count to 0."""
    ws_sim_cuda.launches = 0
    ws_sim_cuda.launches_by_body = {f"ws_sim_{b}": 0 for b in BODIES.values()}


#: kernel launches made by this process through :func:`ws_sim_cuda`
ws_sim_cuda.launches = 0
ws_sim_cuda.launches_by_body = {}
reset_counts()
