"""Batched work-stealing simulations on the GPU: the wrapper of the
hand-written Hopper kernel ``csrc/ws_sim.cu`` (one warp per scenario, the
whole per-scenario engine state in shared memory for the entire event loop).

It replaces ``ws_sim_pallas`` of the JAX package for the divisible-load task
model. The design, and what bounds the kernel on this card, are written at the
head of the CUDA source. Its plain version is :func:`ws_sim_ref`
(``engine.simulate_batch``): every leaf of both is bit-identical.

:func:`ws_sim_cuda` launches the kernel for tensors on a CUDA device and
raises if it cannot; only for tensors that lie on the CPU does it run the
plain version. ``ws_sim_cuda.launches`` counts kernel launches, and nothing
else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import divisible as dv
from repro_torch.core import engine as eng
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ws_sim_ref

MAX_P = 1024
KERNEL_NAME = "ws_sim_divisible"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ws_sim.cu"

# leaves that hold uint32 values as int64; every other leaf is int32
_U32_LEAVES = ("seed", "remote_prob")

# rows of the kernel's [9, G] scalar output, in order
_SCALAR_ROWS = ("makespan", "n_events", "n_requests", "n_success", "n_fail",
                "total_idle", "startup_end", "overflow", "n_trace")


def _lib() -> ctypes.CDLL:
    lib = _build.load("ws_sim")
    fn = lib.ws_sim_divisible_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ws_sim_error_string.argtypes = [ctypes.c_int]
        lib.ws_sim_error_string.restype = ctypes.c_char_p
        lib.ws_sim_shared_bytes.argtypes = [ctypes.c_int]
        lib.ws_sim_shared_bytes.restype = ctypes.c_int
        lib.ws_sim_scalar_rows.argtypes = []
        lib.ws_sim_scalar_rows.restype = ctypes.c_int
        if lib.ws_sim_scalar_rows() != len(_SCALAR_ROWS):
            raise RuntimeError("ws_sim.cu and its wrapper disagree on the "
                               "scalar output rows")
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


def ws_sim_cuda(model, scn: eng.Scenario) -> dv.SimResult:
    """Batched simulation; ``scn`` leaves have leading batch dim G.

    ``model`` is a :class:`DivisibleModel` or an :class:`EngineConfig`.
    Returns :class:`SimResult` with a leading G axis on every leaf, on the
    device of ``scn``, bit-identical to ``engine.simulate_batch``. The kernel
    is launched on the current stream of that device and not waited for.
    """
    if isinstance(model, dv.EngineConfig):
        model = dv.DivisibleModel(model)
    if not isinstance(model, dv.DivisibleModel):
        raise NotImplementedError(
            f"ws_sim_cuda has a kernel body for the divisible model only, "
            f"got {type(model).__name__}")
    p = model.p
    if p > MAX_P or p < 2:
        raise ValueError(f"ws_sim_cuda supports 2 <= p <= {MAX_P}, got p={p}")
    G = _check_scenario(scn)
    dev = scn.W.device
    if dev.type == "cpu":
        return ws_sim_ref(model, scn)
    if dev.type != "cuda":
        raise RuntimeError(f"ws_sim_cuda runs on CUDA devices, got {dev}")

    topo = model.topology
    trace_rows = max(model.max_trace, 1) if model.log_trace else 1
    model_cap = int(min(int(model.max_events), int(eng.INF32)))
    with torch.cuda.device(dev):
        cid = torch.as_tensor(np.ascontiguousarray(topo.cluster_id, np.int32),
                              device=dev)
        hops = torch.as_tensor(np.ascontiguousarray(topo.hops, np.int32),
                               device=dev)
        scalars = torch.empty((len(_SCALAR_ROWS), G), dtype=torch.int32,
                              device=dev)
        executed = torch.empty((G, p), dtype=torch.int32, device=dev)
        trace = torch.empty((G, trace_rows, 4), dtype=torch.int32, device=dev)
        if G > 0:
            lib = _lib()
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ws_sim_divisible_launch(
                cid.data_ptr(), hops.data_ptr(),
                scn.W.data_ptr(), scn.seed.data_ptr(),
                scn.lam_local.data_ptr(), scn.lam_remote.data_ptr(),
                scn.theta_static.data_ptr(), scn.theta_comm.data_ptr(),
                scn.remote_prob.data_ptr(), scn.max_events.data_ptr(),
                scalars.data_ptr(), executed.data_ptr(), trace.data_ptr(),
                G, p, int(topo.strategy), int(bool(model.mwt)), model_cap,
                int(bool(model.log_trace)), int(model.max_trace), trace_rows,
                stream)
            if err != 0:
                msg = lib.ws_sim_error_string(err).decode()
                raise RuntimeError(
                    f"ws_sim kernel launch failed (G={G}, p={p}, shared "
                    f"bytes={lib.ws_sim_shared_bytes(p)}): CUDA error {err}: "
                    f"{msg}")
            ws_sim_cuda.launches += 1
    row = dict(zip(_SCALAR_ROWS, scalars))
    return dv.SimResult(
        makespan=row["makespan"], n_events=row["n_events"],
        n_requests=row["n_requests"], n_success=row["n_success"],
        n_fail=row["n_fail"], total_idle=row["total_idle"],
        startup_end=row["startup_end"], executed=executed,
        overflow=row["overflow"] != 0, trace=trace, n_trace=row["n_trace"])


#: kernel launches made by this process through :func:`ws_sim_cuda`
ws_sim_cuda.launches = 0
