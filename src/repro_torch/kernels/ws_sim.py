"""Batched work-stealing simulations on the GPU: the wrapper of the
hand-written Hopper kernel ``csrc/ws_sim.cu`` (one warp per scenario, one
kernel body per task model).

It replaces ``ws_sim_pallas`` of the JAX package for the divisible-load, DAG
and adaptive task models. The design, and what bounds the kernel on this
card, are written at the head of the CUDA source. Its plain version is
:func:`ws_sim_ref` (``engine.simulate_batch``): every leaf of both is
bit-identical.

Every body has one variant, ``registers``, instantiated at K = 1, 2, 4, 8,
16 and 32 slots a lane: lane l holds the event times of processors
l*K .. l*K + K - 1 in registers for a 32-bit warp argmin, the other fields
in shared memory. :func:`variant` states the one rule, the least K with
32 * K >= p, for 2 <= p <= ``MAX_P``. The kernel takes two host-made
tables: the multiply-high divisor of p - 1 for UNIFORM victims
(:func:`divisor_magic`) and, for LOCAL_FIRST, each processor's candidate
counts with their divisors (:func:`local_first_table`).

:func:`ws_sim_cuda` launches the kernel for tensors on a CUDA device and
raises if it cannot; only for tensors that lie on the CPU does it run the
plain version. ``ws_sim_cuda(..., grid_chunk=c)`` makes one launch per
chunk of c rows, and :func:`grid_shape_hazards` states the JAX package's
rules for such chunks.
``ws_sim_cuda.launches`` counts kernel launches, and nothing else;
``launches_by_body`` splits that count by kernel body and
``launches_by_variant`` by variant.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import adaptive as ad
from repro_torch.core import dag as dg
from repro_torch.core import divisible as dv
from repro_torch.core import engine as eng
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ws_sim_ref

#: slots (processors) a lane may hold, each an instantiation of the kernel
REG_SLOTS = (1, 2, 4, 8, 16, 32)
MAX_P = 32 * REG_SLOTS[-1]
VARIANTS = ("registers",)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ws_sim.cu"

#: kernel body (and its launcher ``ws_sim_<body>_launch``) per task model
BODIES = {dv.DivisibleModel: "divisible", dg.DagModel: "dag",
          ad.AdaptiveModel: "adaptive"}
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
               "dur", "child_ptr", "child_idx", "pred_count", "slab",
               "lf_div", "probe")
_INT_FIELDS = ("G", "p", "strategy", "mwt", "model_max_events", "log_trace",
               "max_trace", "trace_rows", "n_tasks", "cap", "owner_lifo",
               "src", "pool_cap", "merge_alpha", "merge_beta_num",
               "merge_beta_den", "uni_div", "uni_magic")
#: int64 words a row of a ``WS_SIM_PROBE`` build writes: the cycles of each
#: phase of an event (argmin, dispatch, handler, steal, commit) summed over
#: the row, then the cycles of its whole loop
PROBE_PHASES = ("argmin", "dispatch", "handler", "steal", "commit")


class WsParams(ctypes.Structure):
    """Mirror of ``WsParams`` in ``csrc/ws_sim.cu``: the same fields in the
    same order, 64-bit fields first (so no padding between fields)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [("slab_stride", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


def kernel_name(model) -> str:
    """The name a body goes by in counts and reports: ``ws_sim_<body>``."""
    return f"ws_sim_{BODIES[type(model)]}"


def variant(p: int) -> tuple:
    """The kernel variant that runs p processors, and its slots a lane:
    ``("registers", K)`` with the least K of ``REG_SLOTS`` such that
    32 * K >= p."""
    for k in REG_SLOTS:
        if 2 <= p <= 32 * k:
            return "registers", k
    raise ValueError(f"ws_sim_cuda supports 2 <= p <= {MAX_P}, got p={p}")


def divisor_magic(d: int) -> tuple:
    """(m, s1, s2) with ``n // d == (t + ((n - t) >> s1)) >> s2`` for every
    uint32 n, where ``t = (n * m) >> 32`` (Granlund and Montgomery's
    round-up method; m < 2**32 for every 1 <= d < 2**16)."""
    if not 1 <= d < 1 << 16:
        raise ValueError(f"divisor {d} out of range 1 .. 2**16 - 1")
    ell = (d - 1).bit_length()                   # ceil(log2(d))
    m = (1 << 32) * ((1 << ell) - d) // d + 1
    return m, min(ell, 1), max(ell - 1, 0)


def magic_mod(n: np.ndarray, d: int) -> np.ndarray:
    """``n % d`` for uint32 ``n`` the way the kernel computes it, from
    :func:`divisor_magic` (a multiply-high, two shifts, no division)."""
    m, s1, s2 = divisor_magic(d)
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    q = (t + ((n - t) >> np.uint64(s1))) >> np.uint64(s2)
    return n - q * np.uint64(d)


def _encode_divisor(d: int) -> tuple:
    """A divisor as the kernel reads it: (d | s1 << 16 | s2 << 20, m as
    int32 bits)."""
    m, s1, s2 = divisor_magic(d)
    return d | s1 << 16 | s2 << 20, m - (1 << 32) if m >= 1 << 31 else m


def local_first_table(cluster_id) -> np.ndarray:
    """int32[p, 4]: per thief j the LOCAL_FIRST candidate counts — its own
    cluster without j, then the other clusters — each at least 1 (an empty
    set draws k = 0 and finds no candidate), encoded with its divisor."""
    cid = np.asarray(cluster_id)
    size = (cid[:, None] == cid[None, :]).sum(1)
    out = [(*_encode_divisor(max(int(s) - 1, 1)),
            *_encode_divisor(max(len(cid) - int(s), 1))) for s in size]
    return np.asarray(out, dtype=np.int32).reshape(len(cid), 4)


def _lib(defines: tuple = ()) -> ctypes.CDLL:
    lib = _build.load("ws_sim", defines)
    if lib.ws_sim_error_string.restype is not ctypes.c_char_p:
        for body in BODIES.values():
            fn = getattr(lib, f"ws_sim_{body}_launch")
            fn.argtypes = [ctypes.POINTER(WsParams), ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ws_sim_shared_bytes.argtypes = [ctypes.POINTER(WsParams)]
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
        # the kernel packs a pool entry's parent (+ 1) into 29 bits
        if not 1 <= cfg.pool_cap < 1 << 29 or cfg.deque_cap < 1 \
                or cfg.merge_beta_den == 0:
            raise ValueError(f"ws_sim_cuda needs 1 <= pool_cap < 2**29, "
                             f"deque_cap >= 1 and merge_beta_den != 0, got "
                             f"{cfg}")


def slab_words(model) -> int:
    """int32 words of the per-row global scratch slab of a model's body."""
    cfg = model.cfg
    if isinstance(model, dg.DagModel):
        return cfg.dag.n + model.p * cfg.cap
    if isinstance(model, ad.AdaptiveModel):
        # pool entries of two words, read as 8 bytes (so rows start on 16
        # bytes), then the deques
        return -(-(2 * cfg.pool_cap + model.p * cfg.deque_cap) // 4) * 4
    return 0


def _as_model(model):
    for cfg_type, model_type in _CONFIGS.items():
        if isinstance(model, cfg_type):
            return model_type(model)
    if type(model) not in BODIES:
        raise NotImplementedError(
            f"ws_sim_cuda has kernel bodies for the divisible, DAG and "
            f"adaptive task models, got {type(model).__name__}")
    return model


def ws_sim_cuda(model, scn: eng.Scenario, grid_chunk: Optional[int] = None):
    """Batched simulation; ``scn`` leaves have leading batch dim G.

    ``model`` is a :class:`DivisibleModel`, :class:`DagModel` or
    :class:`AdaptiveModel`, or the engine config of one. Returns the model's
    result NamedTuple with a leading G axis on every leaf, on the device of
    ``scn``, bit-identical to ``engine.simulate_batch``. The kernel variant
    of :func:`variant` is launched on the current stream of that device and
    not waited for.

    ``grid_chunk`` splits the G rows into fixed-size chunks, one launch
    each (the JAX package's ``ws_sim_pallas(grid_chunk=)``): the batch is
    padded up to a chunk multiple with copies of row 0 whose event budget is
    zero, the chunks' results are concatenated in order and the padded rows
    dropped. Rows are independent, so every leaf is bit-identical to the
    unchunked call. On CPU tensors each chunk runs the plain version.
    """
    model = _as_model(model)
    p = model.p
    if p > MAX_P or p < 2:
        raise ValueError(f"ws_sim_cuda supports 2 <= p <= {MAX_P}, got p={p}")
    _check_model(model)
    G = _check_scenario(scn)
    if grid_chunk is not None and G > 0:
        c = max(int(grid_chunk), 1)
        pad = (-G) % c
        if pad:
            scn = eng.Scenario(*(torch.cat([x, x[:1].expand(pad)])
                                 for x in scn))
            scn.max_events[G:] = 0
        res = eng.cat_results([ws_sim_cuda(model, part)
                               for part in eng.split_rows(scn, c)])
        return type(res)(*(x[:G] for x in res)) if pad else res
    if scn.W.device.type == "cpu":
        return ws_sim_ref(model, scn)
    return _launch(model, scn, variant(p)[1])


def grid_shape_hazards(grid_chunk: Optional[int],
                       G: Optional[int] = None) -> list:
    """Shape hazards of a planned ``ws_sim_cuda`` launch plan, by the JAX
    package's rules (``grid_shape_hazards`` of its ``kernels/ws_sim.py``):
    the same inputs give a hazard in the same places, so the two packages'
    lints agree. Returns human-readable hazard strings (empty list =
    clean) for a caller that plans ``ws_sim_cuda(grid_chunk=)``; no backend
    of the port chunks, so the dispatch lint has no chunk to check.

    On CUDA the grid is a launch parameter: the kernel is specialised (one
    ``nvcc`` build, one instantiation) only on what :func:`_lib` and
    :func:`variant` key it on — the source, its defines, the body and the
    slots a lane K — never on G, so a width that is not a power of two
    costs no new build. What it costs here is the broker's pow2 padding: a
    chunk that does not divide a pow2 batch leaves a ragged last launch
    (and, with a chunk of 0, no launch plan at all).
    """
    hazards = []
    if grid_chunk is not None:
        c = int(grid_chunk)
        if c <= 0:
            hazards.append(f"grid_chunk={c} must be a positive power of two")
        elif c & (c - 1):
            hazards.append(
                f"grid_chunk={c} is not a power of two: pow2-padded broker "
                f"batches will not divide evenly, so every distinct batch "
                f"size launches a ragged last chunk of its own width")
    elif G is not None and G > 1 and (int(G) & (int(G) - 1)):
        hazards.append(
            f"unchunked grid G={int(G)} is not a power of two: a batch the "
            f"broker did not pad, so each distinct G is a launch shape of "
            f"its own")
    return hazards


def _launch(model, scn: eng.Scenario, k: int, probe=None, defines=()):
    """One launch of a body at ``k`` slots a lane, counted in every count
    of :func:`ws_sim_cuda` where the kernel is launched. :func:`ws_sim_cuda`
    passes the k of :func:`variant`; a measurement
    (``benchmarks/ws_sim_probe.py``) may name a larger k, or pass ``probe``
    (int64 [G, len(PROBE_PHASES) + 1] on the card) with ``defines =
    ("WS_SIM_PROBE",)``."""
    model = _as_model(model)
    dev = scn.W.device
    if dev.type != "cuda":
        raise RuntimeError(f"ws_sim_cuda runs on CUDA devices, got {dev}")
    with torch.cuda.device(dev):
        prm, outs, _keep = _params(model, scn, k, probe)
        # The temporaries (topology, tables, slab, DAG arrays) go back to
        # PyTorch's caching allocator when this returns, before the kernel
        # ends; it hands their memory only to work on the same stream, which
        # runs after the kernel.
        if prm.G > 0:
            lib = _lib(tuple(defines))
            body = BODIES[type(model)]
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"ws_sim_{body}_launch")(ctypes.byref(prm), k,
                                                        stream)
            if err != 0:
                msg = lib.ws_sim_error_string(err).decode()
                smem = lib.ws_sim_shared_bytes(ctypes.byref(prm))
                raise RuntimeError(
                    f"ws_sim {body} kernel launch failed (G={prm.G}, "
                    f"p={prm.p}, slots a lane={k}, shared bytes={smem}, "
                    f"slab words per row={prm.slab_stride}): CUDA error "
                    f"{err}: {msg}")
            with _count_lock:
                ws_sim_cuda.launches += 1
                ws_sim_cuda.launches_by_body[kernel_name(model)] += 1
                ws_sim_cuda.launches_by_variant["registers"] += 1
        return _result(model, outs)


def _params(model, scn: eng.Scenario, k: int, probe=None) -> tuple:
    """The ``WsParams`` of one launch, the outputs it fills (``torch.empty``
    on the device of ``scn``; :func:`_result` reads them) and the other
    tensors the parameters point into."""
    model = _as_model(model)
    p = model.p
    _check_model(model)
    G = _check_scenario(scn)
    if k not in REG_SLOTS or p > 32 * k:
        raise ValueError(f"{k} slots a lane hold p <= {32 * k}, got p={p}")
    dev = scn.W.device
    body = BODIES[type(model)]
    topo = model.topology
    cfg = model.cfg
    trace_rows = max(model.max_trace, 1) if model.log_trace else 1
    i32 = torch.int32
    cid = torch.as_tensor(np.ascontiguousarray(topo.cluster_id, np.int32),
                          device=dev)
    hops = torch.as_tensor(np.ascontiguousarray(topo.hops, np.int32),
                           device=dev)
    lf = torch.as_tensor(local_first_table(topo.cluster_id), device=dev)
    scalars = torch.empty((len(_SCALAR_ROWS), G), dtype=i32, device=dev)
    executed = torch.empty((G, p), dtype=i32, device=dev)
    tasks_run = torch.empty((G, p) if body == "dag" else (0,), dtype=i32,
                            device=dev)
    trace = torch.empty((G, trace_rows, 4), dtype=i32, device=dev)
    words = slab_words(model)
    slab = torch.empty((G, words) if words else (0,), dtype=i32, device=dev)
    keep = [cid, hops, lf, slab]
    ins = dict(zip(_PTR_FIELDS[:10], (cid, hops) + tuple(scn)))
    uni_div, uni_magic = _encode_divisor(p - 1)
    prm = WsParams(
        **{f: x.data_ptr() for f, x in ins.items()},
        out_scalars=scalars.data_ptr(), out_executed=executed.data_ptr(),
        out_tasks_run=tasks_run.data_ptr(), out_trace=trace.data_ptr(),
        slab=slab.data_ptr(), slab_stride=words, lf_div=lf.data_ptr(),
        probe=0 if probe is None else probe.data_ptr(),
        G=G, p=p, strategy=int(topo.strategy), mwt=int(bool(model.mwt)),
        model_max_events=int(min(int(model.max_events), int(eng.INF32))),
        log_trace=int(bool(model.log_trace)),
        max_trace=int(model.max_trace), trace_rows=trace_rows,
        uni_div=uni_div, uni_magic=uni_magic)
    if body == "dag":
        # the DAG's CSR arrays: read-only, shared by every row (L2)
        arrays = model.static_arrays(dev)
        keep += list(arrays)
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
    return prm, (scalars, executed, tasks_run, trace), keep


def _result(model, outs: tuple):
    """The model's result NamedTuple from a launch's outputs (call it after
    the launch: the overflow leaf is computed from them)."""
    scalars, executed, tasks_run, trace = outs
    row = dict(zip(_SCALAR_ROWS, scalars))
    core = dict(makespan=row["makespan"], n_events=row["n_events"],
                n_requests=row["n_requests"], n_success=row["n_success"],
                n_fail=row["n_fail"], total_idle=row["total_idle"],
                startup_end=row["startup_end"], executed=executed,
                overflow=row["overflow"] != 0, trace=trace,
                n_trace=row["n_trace"])
    if isinstance(model, dg.DagModel):
        return dg.DagSimResult(tasks_run=tasks_run,
                               n_completed=row["n_completed"], **core)
    if isinstance(model, ad.AdaptiveModel):
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
    ws_sim_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


#: the counts are bumped from any thread that launches (a daemon's
#: dispatch and connection threads, a client's fallback threads)
_count_lock = threading.Lock()
#: kernel launches made by this process through :func:`ws_sim_cuda`
ws_sim_cuda.launches = 0
ws_sim_cuda.launches_by_body = {}
ws_sim_cuda.launches_by_variant = {}
reset_counts()
