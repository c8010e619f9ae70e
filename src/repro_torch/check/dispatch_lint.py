"""Pass 1 — the dispatch hazard lint, the port's twin of the JAX package's
jaxpr lint (``repro/check/jaxpr_lint.py``).

A PyTorch program has no jaxpr. What stands for it here is the sequence of
aten operations one event step dispatches: :class:`OpRecorder` (a
``TorchDispatchMode``) records each operation's name, the dtypes of its
outputs and whether it copied a CUDA tensor to the host, while
``engine.advance(model, loop, max_steps=1)`` runs one step of the batched
event loop for each task model on a tiny one-cluster topology, and while
``Model.decode_step`` runs the body that ``launch/steps.py::
GraphedDecodeStep`` captures, for each architecture of
:data:`DECODE_ARCHS` (a dense one, a MoE one, xLSTM and Jamba). On the
card the ``ws_sim_cuda`` launch is recorded too (the kernel itself is a
``ctypes`` call, outside aten).

``retrace.static_args``
    The model is a key (the broker's buckets, the model-keyed maps and,
    through ``store.canonical_model``, the store keys), so the model must
    hash and every cfg field must be hashable and exact (ints/bools/str/
    None). A float field makes inexact store keys.

``retrace.shape_branch``
    The op-name sequence of one step must be the same at batch widths 4
    and 8 for each task model: a difference is a Python branch on a batch
    shape. The kernel's launch key (the body,
    :func:`~repro_torch.kernels.ws_sim.variant`'s slots a lane and every
    integer launch parameter but G) must not depend on G either: a key that
    did would pick a kernel per batch width. The build itself takes nothing
    from a launch (``ws_sim_cuda`` loads one library, with no defines).

``host_sync.item`` (the JAX rule ``host_sync.callback``)
    One step of the loop reaches ``aten::_local_scalar_dense`` exactly once
    (its loop condition, ``bool(live.any())``) and copies nothing from the
    card to the host; the decode step reaches neither, so it can be
    captured and replayed. A dispatch mode does not see ``.tolist()`` of a
    CPU tensor, so an AST rule also flags ``.item()``, ``.tolist()``,
    ``.numpy()`` and ``.cpu()`` in the bodies of :data:`SYNC_FREE`.

``dtype.f64``
    No recorded operation outputs float64 (the simulator is integer time
    with float32 aggregates; the LM path is bf16/float32), and every
    ``CoreState`` field keeps the dtype ``init_core`` gave it across a step.
    ``rng`` is int64 on purpose, holding uint32 values: its values are held
    in ``[0, 2**32)``, not its dtype. The int64 argmin key inside
    ``advance`` is a temporary and no finding.

Two JAX rules have no counterpart. ``donation.ungated``: PyTorch has no
buffer donation to gate. ``pallas.grid_chunk``: the JAX package's Pallas
backends cut each dispatch into ``grid_chunk`` rows, which that rule checks;
no backend of the port cuts one (a device chunk is one launch, and the grid
is a launch parameter, so chunks would only multiply launches: the paper's
grid would go from 96 to 768), so there is no chunk to check. A caller that
passes ``ws_sim_cuda(grid_chunk=)`` checks its chunk with
:func:`repro_torch.kernels.ws_sim.grid_shape_hazards`.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.check import Finding, repo_root

PASS = "dispatch"

#: the aten operation that reads a device value on the host
SYNC_OP = "aten::_local_scalar_dense"

#: Batch widths compared by the shape-branch rule (distinct powers of two,
#: as the JAX lint's).
SIGNATURE_WIDTHS = (4, 8)

#: host syncs one step of the event loop may make: its loop condition
STEP_SYNCS = 1

#: method calls the AST rule flags: each copies a tensor to the host
HOST_SYNC_CALLS = ("item", "tolist", "numpy", "cpu")

#: (file under src/repro_torch, function) whose bodies must not sync: the
#: event step, the kernel launcher, the captured decode step, the layer
#: dispatch it runs, the MoE layer and the recurrent mixers' decode steps
SYNC_FREE = (("core/engine.py", "advance"),
             ("kernels/ws_sim.py", "_launch"),
             ("kernels/ws_sim.py", "_params"),
             ("models/model.py", "decode_step"),
             ("models/blocks.py", "_decode"),
             ("models/xlstm.py", "mlstm_decode_step"),
             ("models/xlstm.py", "_mlstm_project"),
             ("models/xlstm.py", "_mlstm_out"),
             ("models/xlstm.py", "slstm_decode_step"),
             ("models/xlstm.py", "_slstm_cell"),
             ("models/ssm.py", "mamba_decode_step"),
             ("models/ssm.py", "_softplus"),
             ("models/moe.py", "moe_apply"),
             ("models/moe.py", "moe_output"),
             ("models/moe.py", "_moe"),
             ("models/moe.py", "_route_group"),
             ("models/moe.py", "_route"),
             ("models/moe.py", "_top_k"),
             ("models/moe.py", "_slots"),
             ("models/moe.py", "_route_stats"))

#: the architectures whose reduced decode step the lint records: a dense
#: one, a MoE one, the recurrent mixers (xLSTM; Mamba beside attention and
#: MoE in Jamba), the encoder-decoder's (Whisper: cross-attention, learned
#: positions) and a vision model's (InternVL)
DECODE_ARCHS = ("qwen3-1.7b", "mixtral-8x7b", "xlstm-350m", "jamba-v0.1-52b",
                "whisper-large-v3", "internvl2-76b")


def tiny_models() -> List[Tuple[str, object]]:
    """One tiny configured model per registered task-model kind."""
    from repro_torch.core import dag_gen, sweep
    from repro_torch.core.topology import one_cluster

    topo = one_cluster(4, 1)
    return [
        ("divisible", sweep.make_model("divisible", topology=topo,
                                       max_events=256)),
        ("dag", sweep.make_model("dag", topology=topo,
                                 dag=dag_gen.binary_tree(3), max_events=256)),
        ("adaptive", sweep.make_model("adaptive", topology=topo,
                                      max_events=256)),
    ]


def _tiny_scenario(n: int, device):
    from repro_torch.core import sweep
    rows = sweep.grid_rows([64], [1], n)
    return sweep.scenario_from_rows(rows, remote_prob=0.25, ev_budget=256,
                                    device=device)


# ---------------------------------------------------------------------------
# Recording the operations of a call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched aten operation."""
    name: str            # e.g. "aten::add.Tensor"
    out_dtypes: tuple    # dtypes of its tensor outputs
    to_host: bool        # it read a CUDA tensor and wrote a CPU one


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class OpRecorder(TorchDispatchMode):
    """Records every aten operation dispatched inside its ``with`` block."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        self.ops.append(Op(
            name=func.name(), out_dtypes=tuple(t.dtype for t in outs),
            to_host=any(t.device.type == "cuda" for t in ins)
            and any(t.device.type == "cpu" for t in outs)))
        return out


def record_ops(fn: Callable, *args, **kwargs) -> Tuple[object, List[Op]]:
    """``fn(*args, **kwargs)`` with its aten operations recorded; returns
    (its value, the operations in order)."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.ops


def signature(ops: List[Op]) -> Tuple[str, ...]:
    """Operation-name sequence, shapes stripped: equal signatures mean the
    same program at both widths."""
    return tuple(op.name for op in ops)


def scan_ops(ops: List[Op], where: str, symbol: str,
             syncs_allowed: int = 0) -> List[Finding]:
    """Host-sync and float64 scan of one recorded call."""
    out: List[Finding] = []
    syncs = sum(op.name == SYNC_OP for op in ops)
    if syncs > syncs_allowed:
        out.append(Finding(
            pass_name=PASS, rule="host_sync.item", where=where,
            symbol=symbol,
            message=f"{syncs} reads of a device value on the host "
            f"({SYNC_OP}) where {syncs_allowed} are allowed: each one "
            f"waits for the card and serializes the dispatch"))
    copies = sorted({op.name for op in ops if op.to_host})
    if copies:
        out.append(Finding(
            pass_name=PASS, rule="host_sync.item", where=where,
            symbol=symbol,
            message=f"device->host copies through {copies}: each one "
            f"waits for the card and cannot be replayed from a graph"))
    seen = set()
    for op in ops:
        if torch.float64 in op.out_dtypes and op.name not in seen:
            seen.add(op.name)
            out.append(Finding(
                pass_name=PASS, rule="dtype.f64", where=where, symbol=symbol,
                message=f"float64 output of {op.name!r}: an unintended "
                f"promotion diverges bitwise from the float32 oracle"))
    return out


# ---------------------------------------------------------------------------
# Per-rule checks
# ---------------------------------------------------------------------------

def static_arg_findings(name: str, model) -> List[Finding]:
    where = "model-keyed caches and store keys"
    out: List[Finding] = []
    try:
        hash(model)
    except TypeError:
        out.append(Finding(
            pass_name=PASS, rule="retrace.static_args", where=where,
            symbol=name,
            message=f"model {name!r} is unhashable; the maps keyed on the "
            f"model (the broker's buckets) cannot hold it"))
        return out
    for field in dataclasses.fields(model.cfg):
        value = getattr(model.cfg, field.name)
        if isinstance(value, float):
            out.append(Finding(
                pass_name=PASS, rule="retrace.static_args", where=where,
                symbol=name,
                message=f"cfg field {field.name!r} is a float: inexact model "
                f"and store keys; encode it as a fixed-point int like "
                f"remote_prob_u32"))
        else:
            try:
                hash(value)
            except TypeError:
                out.append(Finding(
                    pass_name=PASS, rule="retrace.static_args", where=where,
                    symbol=name,
                    message=f"cfg field {field.name!r} "
                    f"({type(value).__name__}) is unhashable: it breaks "
                    f"the model's key"))
    return out


def step_ops(model, n: int, device) -> Tuple[object, List[Op]]:
    """One ``advance(..., max_steps=1)`` of a fresh loop at width ``n``,
    recorded; returns (the loop, the operations)."""
    from repro_torch.core import engine as eng
    loop = eng.start_loop(model, _tiny_scenario(n, device))
    _, ops = record_ops(eng.advance, model, loop, max_steps=1)
    return loop, ops


def signature_findings(record: Callable[[int], List[Op]], where: str,
                       symbol: str) -> List[Finding]:
    """``record(n)`` -> the operations at width n; a finding when the
    signatures at :data:`SIGNATURE_WIDTHS` differ."""
    a, b = (signature(record(n)) for n in SIGNATURE_WIDTHS)
    if a == b:
        return []
    return [Finding(
        pass_name=PASS, rule="retrace.shape_branch", where=where,
        symbol=symbol,
        message=f"dispatched program differs between batch widths "
        f"{SIGNATURE_WIDTHS[0]} and {SIGNATURE_WIDTHS[1]} ({len(a)} vs "
        f"{len(b)} operations): a Python branch on a batch shape")]


def launch_key(model, scn) -> tuple:
    """What a ``ws_sim_cuda`` launch of ``scn`` is specialised on: the
    body, the slots a lane and every integer parameter but G, as
    ``ws_sim._params`` makes them. Made on any device (no launch)."""
    from repro_torch.kernels import ws_sim as ws
    k = ws.variant(model.p)[1]
    prm, _, _ = ws._params(model, scn, k)
    ints = tuple((f, getattr(prm, f)) for f in ws._INT_FIELDS if f != "G")
    return (ws.kernel_name(model), k, prm.slab_stride, ints)


def shape_branch_findings(name: str, model, device) -> List[Finding]:
    out = signature_findings(lambda n: step_ops(model, n, device)[1],
                             where="core.engine.advance", symbol=name)
    a, b = (launch_key(model, _tiny_scenario(n, device))
            for n in SIGNATURE_WIDTHS)
    if a != b:
        out.append(Finding(
            pass_name=PASS, rule="retrace.shape_branch",
            where="kernels.ws_sim._params", symbol=name,
            message=f"the kernel's launch key differs between batch widths "
            f"{SIGNATURE_WIDTHS[0]} and {SIGNATURE_WIDTHS[1]}: one build or "
            f"kernel variant per batch width"))
    return out


def state_dtype_findings(before, after, where: str,
                         symbol: str) -> List[Finding]:
    """Each ``CoreState`` field of ``after`` keeps the dtype it had in
    ``before``; ``rng`` holds values in ``[0, 2**32)``."""
    out: List[Finding] = []
    for f in before._fields:
        was, now = getattr(before, f).dtype, getattr(after, f).dtype
        if was != now:
            out.append(Finding(
                pass_name=PASS, rule="dtype.f64", where=where, symbol=symbol,
                message=f"CoreState.{f} changed dtype across a step "
                f"({was} -> {now}): a silent promotion"))
    rng = after.rng
    if rng.numel() and (bool((rng < 0).any()) or bool((rng >> 32).any())):
        out.append(Finding(
            pass_name=PASS, rule="dtype.f64", where=where, symbol=symbol,
            message="CoreState.rng left [0, 2**32): the xorshift32 lanes "
            "must hold uint32 values in their int64"))
    return out


def core_state_findings(name: str, model, device) -> List[Finding]:
    from repro_torch.core import engine as eng
    loop = eng.start_loop(model, _tiny_scenario(SIGNATURE_WIDTHS[0], device))
    before = eng.CoreState(*(x.clone() for x in loop.core))
    eng.advance(model, loop, max_steps=1)
    return state_dtype_findings(before, loop.core, "core.engine.CoreState",
                                name)


def lint_host_sync_source(src: str, filename: str,
                          functions) -> List[Finding]:
    """AST scan: ``.item()``, ``.tolist()``, ``.numpy()`` or ``.cpu()``
    called inside a function of ``functions`` (testable on synthetic
    sources)."""
    tree = ast.parse(src, filename=filename)
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn.name not in functions:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_SYNC_CALLS:
                out.append(Finding(
                    pass_name=PASS, rule="host_sync.item",
                    where=f"{filename}:{node.lineno}", symbol=fn.name,
                    message=f".{node.func.attr}() in {fn.name}: a copy to "
                    f"the host inside a step that must not sync"))
    return out


def host_sync_source_findings(root: Optional[Path] = None) -> List[Finding]:
    root = root or repo_root()
    pkg = root / "src" / "repro_torch"
    out: List[Finding] = []
    for rel in sorted({f for f, _ in SYNC_FREE}):
        path = pkg / rel
        out.extend(lint_host_sync_source(
            path.read_text(), str(path.relative_to(root)),
            {fn for f, fn in SYNC_FREE if f == rel}))
    return out


def decode_step_ops(device, arch: str = DECODE_ARCHS[0]) -> List[Op]:
    """``Model.decode_step`` of the reduced ``arch`` (random weights from a
    seed) with the position as a device int32 tensor, as the captured graph
    runs it; returns the recorded operations."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config(arch).reduced(), device=device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    cache = model.init_cache(2, 16)
    tokens = torch.ones((2, 1), dtype=torch.int64, device=model.device)
    pos = torch.full((1,), 3, dtype=torch.int32, device=model.device)
    model.decode_step(params, cache, tokens, pos)        # builds, warms
    _, ops = record_ops(model.decode_step, params, cache, tokens, pos)
    return ops


def launch_findings(name: str, model, device) -> List[Finding]:
    """The ``ws_sim_cuda`` launch on the card: no sync, no copy back, no
    float64, the same operations at both widths."""
    from repro_torch.kernels import ws_sim as ws

    def record(n):
        scn = _tiny_scenario(n, device)
        ws.ws_sim_cuda(model, scn)                         # builds, warms
        return record_ops(ws.ws_sim_cuda, model, scn)[1]

    where = "kernels.ws_sim.ws_sim_cuda"
    return (scan_ops(record(SIGNATURE_WIDTHS[0]), where, name)
            + signature_findings(record, where, name))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def run(root: Optional[Path] = None, device=None) -> List[Finding]:
    """Every rule; the recorded programs run on ``device`` (None: the card,
    which the device rule requires)."""
    from repro_torch.core import engine as eng

    dev = eng.resolve_device(device)
    findings: List[Finding] = []
    for name, model in tiny_models():
        findings.extend(static_arg_findings(name, model))
        findings.extend(shape_branch_findings(name, model, dev))
        _, ops = step_ops(model, SIGNATURE_WIDTHS[0], dev)
        findings.extend(scan_ops(ops, "core.engine.advance", name,
                                 syncs_allowed=STEP_SYNCS))
        findings.extend(core_state_findings(name, model, dev))
        if dev.type == "cuda":
            findings.extend(launch_findings(name, model, dev))
    for arch in DECODE_ARCHS:
        findings.extend(scan_ops(decode_step_ops(dev, arch),
                                 "models.model.decode_step", arch))
    findings.extend(host_sync_source_findings(root))
    return findings


__all__ = ["PASS", "SYNC_OP", "SIGNATURE_WIDTHS", "STEP_SYNCS",
           "HOST_SYNC_CALLS", "SYNC_FREE", "DECODE_ARCHS", "tiny_models",
           "Op", "OpRecorder",
           "record_ops", "signature", "scan_ops", "static_arg_findings",
           "step_ops", "signature_findings", "launch_key",
           "shape_branch_findings", "state_dtype_findings",
           "core_state_findings", "lint_host_sync_source",
           "host_sync_source_findings", "decode_step_ops", "launch_findings",
           "run"]
