"""The port's sharded MoE prefill and train steps on four ranks against the
JAX package's on four host devices and against the port's steps without a
mesh with the same dispatch groups.

One module fixture makes the batches and one MoE layer's input from a seed
with numpy and the weights with the JAX package (carried across with
``params_from_jax``), then runs at once: the JAX package in subprocesses on
four host CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``:
its ``build_prefill_step`` and ``build_train_step(act_spec=)`` jitted with
``shard_params``' and ``shard_opt_state``'s shardings, the batch on the dp
axes, as ``plan_cell`` plans them), and four port ranks in subprocesses
(``gloo`` on the CPU: each rank its shards of the weights and moments,
``local_params``; its rows of the batch, ``shard_batch``). Each side writes
what it computed; the tests compare.

The config: a reduced mixtral in float32 at 2 layers (d_model 64, 4 heads
of 16 over 2 KV heads, 4 experts of d_ff 64, top-2, the work-stealing
rebalance), ``moe_groups`` as ``plan_cell`` sets it. The cases:

* ``2x2_sp``: (2, 2), SP, B = 4, S = 16, 4 groups: the experts split on
  "data" (EP: the all-to-all), d_ff on "model"; each data rank holds 2
  rows, so a rank's group (a chunk of its flattened rows) is not its SP
  slice: the sequence is gathered first;
* ``4x1_sp``: (4, 1): one expert a rank, and each rank's SP slice is its
  group;
* ``1x4_sp``: (1, 4): the experts whole (a "data" axis of one), d_ff and the
  groups on "model";
* ``2x2_sp_e3``: (2, 2) with 3 experts: the rules' guard keeps them whole on
  "data", as mixtral's 8 on the production mesh's 16: no all-to-all;
* ``2x2_shared``: (2, 2), B = 2, S = 15: 30 tokens do not split four ways,
  so 2 groups (|dp|) and the two ranks of a "model" column route the same
  group (counted once); 15 positions do not split over "model": no SP;
* ``2x2_direct``: (2, 2), SP, B = 2, S = 16, 4 groups: one row a data rank,
  so each rank's SP slice is its group (``direct``: no sequence gather
  before the router, no output gather after it) with a "model" axis of 2.

Tolerances, each with its reason: each rank's logits within
1e-4·max|logit| of the JAX package's sharded step's slice and of the
unsharded step's (float32 sums over "model" and the experts' partial sums
in other orders); after two train steps each weight, ``m`` and ``v`` shard
within 1e-4·max|leaf|, and ``loss``, ``xent``, ``moe_aux`` and
``grad_norm`` within rtol 1e-5, ``lr`` equal (as
``tests/test_torch_sharded_train.py``); no element of ``m`` after the
first step zero where the JAX package's is not. One MoE layer on the four
ranks (``partition.moe``) against the JAX package's ``moe_apply`` with the
same groups: ``y`` within 1e-4·max|y|, ``aux`` and ``load_std`` within rtol
1e-5, ``dropped`` and ``stolen`` equal as counts of (token, k)
assignments (within rtol 1e-6 as fractions: where Tg·k is not a power of
two the JAX package's float32 mean rounds its last bit otherwise, as
against the port's ``moe_apply`` without a mesh), after a check that no
token's router probabilities are within 1e-6 of a tie. A world of one
rank is bit-equal to the unsharded steps.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import partition as pt
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from test_torch_common import cpu_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-4
METRIC_RTOL = 1e-5
LAYERS = 2
STEPS = 2
#: the reduced configs, as (arch, reduced()'s overrides)
CONFIGS = {"mixtral": ("mixtral-8x7b", {}),
           "mixtral_e3": ("mixtral-8x7b", {"n_experts": 3})}
#: name -> (mesh shape, sequence parallelism, config, batch rows, sequence,
#: moe_groups: plan_cell's |dp|·|model| where the tokens divide it, else
#: |dp|)
CASES = {"2x2_sp": ((2, 2), True, "mixtral", 4, 16, 4),
         "4x1_sp": ((4, 1), True, "mixtral", 4, 16, 4),
         "1x4_sp": ((1, 4), True, "mixtral", 4, 16, 4),
         "2x2_sp_e3": ((2, 2), True, "mixtral_e3", 4, 16, 4),
         "2x2_shared": ((2, 2), True, "mixtral", 2, 15, 2),
         "2x2_direct": ((2, 2), True, "mixtral", 2, 16, 4)}
#: the MoE layer's capacity factor in the layer check: below 1, so that the
#: skewed tokens overflow into stolen slots and past them (dropped)
LAYER_CF = 0.75
#: the JAX package's side runs its jobs in this many processes at once
JAX_PROCS = 3

COMMON = """
import dataclasses, pickle, sys, time
from pathlib import Path
import numpy as np


def reduced(get_config, config, groups):
    arch, over = config
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32", moe_groups=groups)


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)
"""

JAX_SIDE = COMMON + """
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import sharding as shd
from repro.launch.mesh import dp_axes, use_mesh
from repro.launch.steps import (build_prefill_step, build_train_step,
                                make_act_constrainer)
from repro.models import build_model
from repro.optim import adamw

d, part, parts = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
out = {}
for job in [(n, k) for n in cases for k in ("prefill", "train")][part::parts]:
    name, kind = job
    shape, sp, key, B, S, groups = cases[name]
    batches = np.load(d / f"batches_{name}.npy")
    model = build_model(reduced(get_config, configs[key], groups))
    params = jax.tree.map(jnp.asarray, pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    dp = dp_axes(mesh)
    act = make_act_constrainer(mesh, dp, sequence_parallel=sp)
    pshard = shd.shard_params(model.abstract_params(), mesh)
    bsh = NamedSharding(mesh, P(dp, None))
    if kind == "prefill":
        fn = jax.jit(build_prefill_step(model, act_spec=act),
                     in_shardings=(pshard, {"tokens": bsh}),
                     out_shardings=NamedSharding(mesh, P(dp, None, "model")))
        with use_mesh(mesh):
            out[job] = np.asarray(fn(params, {
                "tokens": jnp.asarray(batches[0, 0])}))
        continue
    oshard = shd.shard_opt_state(adamw.abstract_state(
        model.abstract_params()), pshard, mesh)
    metric = NamedSharding(mesh, P())
    fn = jax.jit(build_train_step(model, adamw.AdamWConfig(), act_spec=act),
                 in_shardings=(pshard, oshard, {"tokens": bsh,
                                                "labels": bsh}),
                 out_shardings=(pshard, oshard, {k: metric for k in (
                     "loss", "xent", "moe_aux", "grad_norm", "lr")}))
    opt = adamw.init(params)
    got = dict(metrics=[])
    with use_mesh(mesh):
        for k in range(2):
            batch = {"tokens": jnp.asarray(batches[k, 0]),
                     "labels": jnp.asarray(batches[k, 1])}
            params, opt, met = fn(params, opt, batch)
            got["metrics"].append({m: float(v) for m, v in met.items()})
            if k == 0:
                got["m1"] = tree_np(opt.m)
    got.update(params=tree_np(params), m=tree_np(opt.m), v=tree_np(opt.v))
    out[job] = got
(d / f"jax{part}.pkl").write_bytes(pickle.dumps(out))
"""

PORT_RANK = COMMON + """
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as ml, partition as pt, sharding as shd
from repro_torch.launch.steps import (build_prefill_step, build_train_step,
                                      make_act_constrainer, plan_cell)
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime.fault import TrainLoopConfig, run_training

rank, init, d = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
ml.init_world("gloo", rank=rank, world_size=4, init_method=init,
              device="cpu")
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
layer_h = torch.from_numpy(np.load(d / "layer_h.npy"))
layer_cf = float(np.load(d / "layer_cf.npy"))
OPT = adamw.AdamWConfig()
out = {}


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree))


def arrays(tree):
    return [t.numpy() for t in tr.leaves(tree)]


for name, (shape, sp, key, B, S, groups) in cases.items():
    batches = torch.from_numpy(np.load(d / f"batches_{name}.npy"))

    def batch(mesh, k):
        return shard_batch({"tokens": batches[k, 0],
                            "labels": batches[k, 1]}, mesh)
    mesh = ml.make_test_mesh(shape, ("data", "model"), device="cpu")
    cfg = reduced(get_config, configs[key], groups)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()), model)
    shardings = shd.shard_params(model.param_shapes(), mesh)
    lp = shd.local_params(params, shardings, mesh)
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=sp)
    got = dict(coordinate=ml.coordinate(mesh), metrics=[], counts=[],
               index=[sh.local_index(tuple(p.shape)) for p, sh in
                      zip(tr.leaves(params), tr.leaves(shardings))],
               whole_leaves=[p for (p, a), b in zip(
                   tr.flatten_with_path(lp), tr.leaves(params)) if a is b])
    # the prefill step
    pt.reset_counts()
    got["logits"] = build_prefill_step(model, act_spec=act, device="cpu")(
        lp, shard_batch({"tokens": batches[0, 0]}, mesh)).numpy()
    got["prefill_counts"] = pt.counts()
    # one MoE layer (layer 0's FFN) on this rank's groups, with its stats
    lcfg = dataclasses.replace(cfg, capacity_factor=layer_cf)
    lact = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=sp)
    tok = shard_batch({"tokens": batches[0, 0]}, mesh)["tokens"]
    part = pt.for_model(lact, lcfg, pt.local(tok))
    rows = pt.local(tok).shape[0]
    r0 = ml.coordinate(mesh)["data"] * rows
    h = part.into_layout(layer_h[r0:r0 + rows, :S].contiguous())
    ffn = {k: v[0] for k, v in lp["layers"]["slot0"]["ffn"].items()}
    pt.reset_counts()
    y, aux, st = pt.moe(part, h, ffn, stats=True)
    got["layer"] = dict(y=y.numpy(), aux=float(aux),
                        dropped=float(st.dropped), stolen=float(st.stolen),
                        load_std=float(st.load_std), counts=pt.counts(),
                        layout=part.moe._asdict(), rows=rows)
    # the train step, two steps
    opt = adamw.init(lp)
    step = build_train_step(model, OPT, act_spec=act, device="cpu")
    for k in range(2):
        pt.reset_counts()
        lp, opt, met = step(lp, opt, batch(mesh, k))
        got["metrics"].append({m: float(v) for m, v in met.items()})
        got["counts"].append(dict(pt.counts(),
                                  backward=pt.backward_counts()))
        if k == 0:
            got["m1"] = arrays(opt.m)
    moments = adamw.state_shapes(model.param_shapes()).m
    got.update(params=arrays(lp), m=arrays(opt.m), v=arrays(opt.v),
               local_bytes=nbytes(lp) + nbytes(opt.m) + nbytes(opt.v),
               shard_bytes=shd.shard_bytes(model.param_shapes(), shardings)
               + 2 * shd.shard_bytes(moments, shardings))
    out[name] = got
    if name != "2x2_sp":
        continue
    # the cell plans' prefill and train fns, run: the same steps
    full = get_config("mixtral-8x7b")
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)
            and f.name != "moe_groups"}
    p0 = shd.local_params(params, shardings, mesh)
    plan = plan_cell("mixtral-8x7b", "prefill_32k", mesh, cfg_overrides=over,
                     device="cpu")
    out["plan_prefill"] = dict(groups=plan.cfg.moe_groups, logits=plan.fn(
        p0, shard_batch({"tokens": batches[0, 0]}, mesh)).numpy())
    plan = plan_cell("mixtral-8x7b", "train_4k", mesh, opt_cfg=OPT,
                     cfg_overrides=over, device="cpu")
    _p, _o, met = plan.fn(p0, adamw.init(p0), batch(mesh, 0))
    out["plan_train"] = dict(groups=plan.cfg.moe_groups, metrics={
        m: float(v) for m, v in met.items()})
    # groups that do not split over the batch's data shards
    one = build_model(dataclasses.replace(cfg, moe_groups=1), device="cpu")
    try:
        build_prefill_step(one, mesh=mesh, device="cpu")(
            p0, shard_batch({"tokens": batches[0, 0]}, mesh))
        out["one_group"] = None
    except ValueError as e:
        out["one_group"] = str(e)
    # the loop: two steps with a checkpoint a step, written by rank 0
    state_sh = {"params": shardings, "opt": shd.shard_opt_state(
        adamw.state_shapes(model.param_shapes()), shardings, mesh)}
    kept = {}
    loop_step = build_train_step(model, OPT, mesh=mesh, device="cpu")

    def step_fn(st, b):
        p, o, met = loop_step(st["params"], st["opt"], b)
        kept["state"] = {"params": p, "opt": o}
        return kept["state"], met
    res = run_training(TrainLoopConfig(total_steps=2, ckpt_every=1,
                                       ckpt_dir=str(d / "loop")),
                       step_fn, {"params": p0, "opt": adamw.init(p0)},
                       lambda s: batch(mesh, s), state_shardings=state_sh)
    st = kept["state"]
    out["loop"] = dict(losses=res["losses"], final_step=res["final_step"],
                       params=arrays(st["params"]), m=arrays(st["opt"].m),
                       v=arrays(st["opt"].v), step=int(st["opt"].step))
(d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist.destroy_process_group()
"""


def _run(procs, timeout=500):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _cfg(key, groups):
    arch, over = CONFIGS[key]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32", moe_groups=groups)


def _jcfg(key, groups):
    arch, over = CONFIGS[key]
    return dataclasses.replace(jget(arch).reduced(**over),
                               param_dtype="float32", moe_groups=groups)


def _batch(batches, k):
    return {"tokens": torch.from_numpy(batches[k, 0]),
            "labels": torch.from_numpy(batches[k, 1])}


def _unsharded(case, params, batches) -> dict:
    """The port's steps without a mesh, with the case's groups: the prefill
    logits, each train step's metrics, and the weights, ``m`` and ``v``
    after the last (numpy, pytree order)."""
    _shape, _sp, key, _B, _S, groups = CASES[case]
    model = build_model(_cfg(key, groups), device="cpu")
    p = params_from_jax(params, model)
    logits = psteps.build_prefill_step(model, device="cpu")(
        p, {"tokens": torch.from_numpy(batches[0, 0])}).numpy()
    o = adamw.init(p)
    step = psteps.build_train_step(model, adamw.AdamWConfig(), device="cpu")
    metrics = []
    for k in range(STEPS):
        p, o, met = step(p, o, _batch(batches, k))
        metrics.append({m: float(v) for m, v in met.items()})
    return dict(logits=logits, metrics=metrics,
                params=[t.numpy() for t in tr.leaves(p)],
                m=[t.numpy() for t in tr.leaves(o.m)],
                v=[t.numpy() for t in tr.leaves(o.v)])


def _layer_h(rng) -> np.ndarray:
    """One MoE layer's input (B, S, D) for every case (each takes its first
    B rows and S positions): normal tokens plus one shared direction, which
    pushes them towards the same experts (overflow)."""
    B = max(c[3] for c in CASES.values())
    S = max(c[4] for c in CASES.values())
    D = _cfg("mixtral", 1).d_model
    return (rng.standard_normal((B, S, D))
            + 0.5 * rng.standard_normal(D)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_moe")
    rng = np.random.default_rng(0)
    batches = {}
    for name, (_shape, _sp, key, B, S, groups) in CASES.items():
        batches[name] = rng.integers(0, _cfg(key, groups).vocab_size,
                                     (STEPS, 2, B, S), dtype=np.int32)
        np.save(d / f"batches_{name}.npy", batches[name])
    layer_h = _layer_h(rng)
    np.save(d / "layer_h.npy", layer_h)
    np.save(d / "layer_cf.npy", np.float64(LAYER_CF))
    params = {}
    for seed, key in enumerate(CONFIGS):
        jcfg = _jcfg(key, 1)
        assert jcfg.repeats == LAYERS
        params[key] = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
            jax.random.PRNGKey(seed)))
        (d / f"params_{key}.pkl").write_bytes(pickle.dumps(params[key]))
    (d / "cases.pkl").write_bytes(pickle.dumps((CASES, CONFIGS)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    init = f"tcp://localhost:{pmesh.free_port()}"
    kw = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
              env=env, cwd=d)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d),
                               str(i), str(JAX_PROCS)], **kw)
             for i in range(JAX_PROCS)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT_RANK, str(r),
                                init, str(d)], **kw) for r in range(WORLD)]
    # the port's steps without a mesh and the JAX package's MoE layer, in
    # this process meanwhile
    whole = {name: _unsharded(name, params[case[2]], batches[name])
             for name, case in CASES.items()}
    layer = {}
    for name, (_shape, _sp, key, B, S, groups) in CASES.items():
        cfg = _jcfg(key, groups)
        ffn = jax.tree.map(lambda a: jnp.asarray(a[0]),
                           params[key]["layers"]["slot0"]["ffn"])
        h = jnp.asarray(layer_h[:B, :S])
        y, aux, st = jmoe.moe_apply(
            ffn, h, n_experts=cfg.n_experts, top_k=cfg.experts_per_tok,
            capacity_factor=LAYER_CF, ws_rebalance=cfg.ws_rebalance,
            n_groups=groups)
        layer[name] = dict(y=np.asarray(y), aux=float(aux),
                           dropped=float(st.dropped),
                           stolen=float(st.stolen),
                           load_std=float(st.load_std), h=layer_h[:B, :S],
                           router=np.asarray(ffn["router"]))
    _run(procs)
    return dict(d=d, batches=batches, params=params, whole=whole,
                layer=layer,
                jax={k: v for i in range(JAX_PROCS) for k, v in
                     pickle.loads((d / f"jax{i}.pkl").read_bytes()).items()},
                ranks=[pickle.loads((d / f"rank{r}.pkl").read_bytes())
                       for r in range(WORLD)])


def _leaves_np(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, what):
    """``got`` (a rank's shard) within TOL · max|want| of ``want``."""
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0, err_msg=what)


def _logit_shard(full, coord, shape):
    """A rank's (B/|data|, 1, Vpad/|model|) slice of ``full``."""
    dsz, msz = shape
    rb, rv = full.shape[0] // dsz, full.shape[2] // msz
    d, m = coord["data"], coord["model"]
    return full[d * rb:(d + 1) * rb, :, m * rv:(m + 1) * rv]


def _hold_shards(got: dict, index, want: dict, what: str):
    for tree in ("params", "m", "v"):
        for i, (a, idx) in enumerate(zip(got[tree], index)):
            _close(a, want[tree][i][idx], f"{what} {tree} leaf {i}")


def _hold_metrics(got, want, what):
    for key in ("loss", "xent", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL,
                                   err_msg=f"{what} {key}")
    assert got["lr"] == want["lr"], what
    assert got["moe_aux"] > 0, what


# ---------------------------------------------------------------------------
# the prefill step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_logits_are_the_jax_sharded_step_s_slice(ranks, case):
    shape = CASES[case][0]
    jax_full = ranks["jax"][case, "prefill"]
    _close(jax_full, ranks["whole"][case]["logits"],
           f"{case}: JAX against the port")
    for r in ranks["ranks"]:
        got = r[case]
        _close(got["logits"], _logit_shard(jax_full, got["coordinate"],
                                           shape),
               f"{case} {got['coordinate']}")


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_logits_are_the_unsharded_step_s_slice(ranks, case):
    shape = CASES[case][0]
    whole = ranks["whole"][case]["logits"]
    for r in ranks["ranks"]:
        got = r[case]
        _close(got["logits"], _logit_shard(whole, got["coordinate"], shape),
               f"{case} {got['coordinate']}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_train_step_is_the_jax_sharded_step(ranks, case):
    jx = ranks["jax"][case, "train"]
    want = {t: _leaves_np(jx[t]) for t in ("params", "m", "v")}
    for r in ranks["ranks"]:
        got = r[case]
        what = f"{case} {got['coordinate']}"
        for k in range(STEPS):
            _hold_metrics(got["metrics"][k], jx["metrics"][k],
                          f"{what} step {k + 1}")
        _hold_shards(got, got["index"], want, what)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_train_step_is_the_unsharded_step(ranks, case):
    whole = ranks["whole"][case]
    for r in ranks["ranks"]:
        got = r[case]
        what = f"{case} {got['coordinate']}"
        for k in range(STEPS):
            _hold_metrics(got["metrics"][k], whole["metrics"][k],
                          f"{what} step {k + 1}")
        _hold_shards(got, got["index"], whole, what)


@pytest.mark.parametrize("case", list(CASES))
def test_no_gradient_is_zero_where_the_jax_package_s_is_not(ranks, case):
    want = _leaves_np(ranks["jax"][case, "train"]["m1"])
    for r in ranks["ranks"]:
        got = r[case]
        for i, (a, idx) in enumerate(zip(got["m1"], got["index"])):
            w = want[i][idx]
            assert not np.any((a == 0) & (w != 0)), (case, i)
            assert np.any(a != 0) or not np.any(w != 0), (case, i)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_shards_and_only_the_norms_whole(ranks, case):
    for r in ranks["ranks"]:
        got = r[case]
        assert got["local_bytes"] == got["shard_bytes"], case
        assert {p[-1] for p in got["whole_leaves"]} == {
            "final_norm", "norm1", "norm2"}, case


# ---------------------------------------------------------------------------
# one MoE layer: routing and its statistics over the mesh
# ---------------------------------------------------------------------------

def _assert_no_near_tie(h, router, k, groups):
    logits = h.reshape(-1, h.shape[-1]).astype(np.float64) \
        @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    gap = float(np.diff(-top, axis=-1).min())
    assert gap > 1e-6, f"near-tie in the router (gap {gap}): report it"


@pytest.mark.parametrize("case", list(CASES))
def test_one_moe_layer_routes_as_the_jax_package_s(ranks, case):
    """``partition.moe`` on each rank's groups against the JAX package's
    ``moe_apply`` over the whole batch with the same groups: each rank's
    ``y`` is its slice in the step's layout, ``aux`` and the statistics the
    same on every rank; some assignments are stolen and some dropped."""
    shape, _sp, key, B, S, groups = CASES[case]
    want = ranks["layer"][case]
    cfg = _cfg(key, groups)
    _assert_no_near_tie(want["h"], want["router"], cfg.experts_per_tok,
                        groups)
    assert want["stolen"] > 0 and want["dropped"] > 0
    for r in ranks["ranks"]:
        got = r[case]["layer"]
        lay, rows = got["layout"], got["rows"]
        d, m = r[case]["coordinate"]["data"], r[case]["coordinate"]["model"]
        y = want["y"][d * rows:(d + 1) * rows]
        if got["y"].shape[1] != S:              # the SP slice
            n = S // shape[1]
            y = y[:, m * n:(m + 1) * n]
        _close(got["y"], y, f"{case} {r[case]['coordinate']} y")
        assert lay["groups"] == groups
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["load_std"], want["load_std"],
                                   rtol=1e-5)
        # the fractions as counts of (token, k) assignments over the groups
        n = groups * (B * S // groups) * cfg.experts_per_tok
        for key_ in ("dropped", "stolen"):
            assert round(got[key_] * n) == round(want[key_] * n), (case,
                                                                   key_)
            np.testing.assert_allclose(got[key_], want[key_], rtol=1e-6)


def _layout(case) -> dict:
    """What the case's layout must be (``partition.MoELayout``)."""
    shape, sp, key, B, S, groups = CASES[case]
    dsz, msz = shape
    cfg = _cfg(key, groups)
    shared = (groups // dsz) % msz != 0
    return dict(groups=groups, shared=shared,
                local=groups // dsz if shared else groups // dsz // msz,
                ep=cfg.n_experts % dsz == 0,
                split_ff=cfg.expert_d_ff % msz == 0,
                direct=sp and S % msz == 0 and B // dsz == 1 and not shared)


@pytest.mark.parametrize("case", list(CASES))
def test_the_layout_is_the_case_s(ranks, case):
    for r in ranks["ranks"]:
        lay = r[case]["layer"]["layout"]
        assert {k: lay[k] for k in _layout(case)} == _layout(case)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def moe_formula(case, train: bool) -> dict:
    """PERF.md §6's count of a sharded step of L layers of attn +
    moe. A layer's attention: 4 FSDP gathers (wq, wk, wv, wo), 3 column
    and 1 row product (wo's sum over "model": a reduce-scatter with SP,
    else an all-reduce), with SP a sequence gather before the mixer; head
    gathers where a head is cut. Its MoE FFN (``partition.moe``): the
    router's FSDP gather; with SP the sequence gathered unless the rank's
    SP slice is its groups (``direct``); with EP two all-to-alls; with
    d_ff split on "model" the groups' gather over "model" and the partial
    sums' reduce-scatter back (one all-reduce instead where a "model"
    column shares its groups); the output's gather over "model" unless
    ``direct`` or shared; aux's all-reduce over the group axes. Per step
    the embedding's and the head's FSDP gathers and the embedding's sum
    over "model"; the prefill's last-position broadcast with SP; the train
    step's sequence gather before the head, the loss's 3 + 1 all-reduces,
    the transposes, a leaf sum for each norm leaf and the router (whole on
    "model") and for w_gate, w_up, w_down where they are whole on an axis
    (no EP, or d_ff whole), and AdamW's norm sum."""
    shape, sp, key, B, S, groups = CASES[case]
    cfg = _cfg(key, groups)
    lay = _layout(case)
    mp, L = shape[1], LAYERS
    sp = sp and S % mp == 0
    H, KV = cfg.n_heads, cfg.n_kv_heads
    ep, ff, shared, direct = (lay["ep"], lay["split_ff"], lay["shared"],
                              lay["direct"])
    moe_sp = sp and not direct
    router = cfg.d_model % shape[0] == 0
    calls = dict(fsdp_gather=(4 + router) * L + 2, column=3 * L, row=L,
                 sp_gather=((1 + moe_sp) * L + train) if sp else 0,
                 head_gather=L * (2 * (KV % mp != 0) + (H % mp != 0)),
                 embed=1, head=1, last_position=0 if train else 1, moe=L)
    gathers = calls["fsdp_gather"] + calls["sp_gather"] \
        + calls["head_gather"] + L * ((ff and not shared)
                                      + (not direct and not shared))
    sums = L + 1                   # wo's and the embedding's over "model"
    moe_rs = L * (ff and not shared)
    moe_ar = L * (ff and shared) + L       # shared partial sums; aux
    loss = 4 if train else 0
    fwd = dict(all_gather=gathers,
               reduce_scatter=(sums if sp else 0) + moe_rs,
               all_reduce=(0 if sp else sums) + moe_ar + loss,
               broadcast=int(sp and not train), all_to_all=2 * ep * L)
    out = {"calls": calls, "collectives": fwd}
    if train:
        out["backward"] = dict(
            all_gather=fwd["reduce_scatter"], reduce_scatter=gathers,
            all_reduce=(0 if sp else sums) + moe_ar + 2,
            all_to_all=fwd["all_to_all"],
            leaf_sum=3 + 1 + 3 * (not (ep and ff)), norm_sum=1)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_the_collectives_follow_the_formula(ranks, case):
    for r in ranks["ranks"]:
        assert r[case]["prefill_counts"] == moe_formula(case, False), case
        for k in range(STEPS):
            assert r[case]["counts"][k] == moe_formula(case, True), (case, k)


# ---------------------------------------------------------------------------
# the cell plans, the loop, the groups' guard
# ---------------------------------------------------------------------------

def test_the_cell_plans_run_the_sharded_moe_steps(ranks):
    for r in ranks["ranks"]:
        assert r["plan_prefill"]["groups"] == 4
        np.testing.assert_array_equal(r["plan_prefill"]["logits"],
                                      r["2x2_sp"]["logits"])
        assert r["plan_train"]["groups"] == 4
        assert r["plan_train"]["metrics"] == r["2x2_sp"]["metrics"][0]


def test_groups_that_do_not_split_over_the_data_shards_raise(ranks):
    for r in ranks["ranks"]:
        assert r["one_group"] is not None
        assert "moe_groups" in r["one_group"]


def test_the_loop_trains_and_its_checkpoint_is_the_jax_package_s(ranks):
    """``run_training(state_shardings=)`` on (2, 2): two steps, the
    step-by-step run's; its last checkpoint, written by the mesh's first
    rank, read by the JAX package into whole arrays equal to the ranks'
    shards put together."""
    whole = ranks["whole"]["2x2_sp"]
    jp = ranks["params"]["mixtral"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp)
    from repro.optim.adamw import AdamWState
    template = {"params": jp, "opt": AdamWState(
        step=np.zeros((), np.int32), m=zeros, v=zeros)}
    step, back, _ = jckpt.load_checkpoint(ranks["d"] / "loop", template)
    assert step == 1 and int(back["opt"].step) == 2
    stored = {"params": _leaves_np(back["params"]),
              "m": _leaves_np(back["opt"].m), "v": _leaves_np(back["opt"].v)}
    for r in ranks["ranks"]:
        got = r["loop"]
        assert got["final_step"] == 2 and got["step"] == 2
        np.testing.assert_allclose(got["losses"], [
            m["loss"] for m in whole["metrics"]], rtol=METRIC_RTOL)
        _hold_shards(got, r["2x2_sp"]["index"], whole, "loop (2, 2)")
        for tree in ("params", "m", "v"):
            for a, idx, w in zip(got[tree], r["2x2_sp"]["index"],
                                 stored[tree]):
                np.testing.assert_array_equal(a, w[idx])


# ---------------------------------------------------------------------------
# in this process: the specs, the guard, a world of one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", ((2, 2), (4, 1), (1, 4), (16, 16)))
@pytest.mark.parametrize("key", ("mixtral", "mixtral_e3"))
def test_weight_specs_agree_with_shard_params(mesh_shape, key):
    """Every leaf a sharded layer reads: ``weight_specs``' spec (one
    layer's; a MoE leaf's resolved at its stacked shape) is
    ``shard_params``' without the repeats entry."""
    cfg = _cfg(key, 1)
    mesh = pmesh.AbstractMesh(mesh_shape, ("data", "model"))
    specs = pt.weight_specs(cfg, mesh)
    tree = shd.shard_params(build_model(cfg, device="meta").param_shapes(),
                            mesh)
    seen = set()
    for path, sh in tr.flatten_with_path(tree):
        if path[0] != "layers" or path[-1].endswith("norm") \
                or path[-1].startswith("norm"):
            continue
        key_ = ("moe/" if path[2] == "ffn" else f"{path[2]}/") + path[-1]
        assert specs[key_] == tuple(sh.spec[1:]), (path, specs[key_],
                                                   sh.spec)
        seen.add(key_)
    assert {"moe/router", "moe/w_gate", "moe/w_up", "moe/w_down"} <= seen


def test_mixtral_s_experts_stay_whole_on_the_production_mesh():
    """On (16, 16) mixtral's 8 experts do not divide "data": the guard
    keeps them whole there and splits d_ff on "model" (no all-to-all);
    phi3.5-moe's 16 split."""
    mesh = pmesh.production_mesh()
    assert pt.weight_specs(get_config("mixtral-8x7b"), mesh)[
        "moe/w_gate"] == (None, None, "model")
    assert pt.weight_specs(get_config("phi3.5-moe-42b-a6.6b"), mesh)[
        "moe/w_gate"] == ("data", None, "model")


def test_the_guard_runs_moe_and_still_names_queue_a_10d():
    assert pt.unsupported(get_config("mixtral-8x7b")) is None
    assert pt.unsupported(get_config("phi3.5-moe-42b-a6.6b")) is None
    for arch in ("jamba-v0.1-52b", "xlstm-350m", "whisper-large-v3",
                 "internvl2-76b"):
        assert pt.unsupported(get_config(arch)) is not None, arch


@pytest.mark.parametrize("groups", (1, 4))
@pytest.mark.parametrize("sp", (True, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_a_world_of_one_gives_the_unsharded_steps_bit_for_bit(dtype, sp,
                                                             groups):
    """On a (1, 1) mesh every collective (the all-to-alls too) runs over a
    group of one and every leaf is whole: the sharded MoE prefill's logits
    and two train steps' metrics, weights and moments are the unsharded
    steps' bit for bit, with one dispatch group (``plan_cell``'s on a
    world of one) and with four on the one rank."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              param_dtype=dtype, moe_groups=groups)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
                for k in ("tokens", "labels")} for _ in range(2)]
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    want_logits = psteps.build_prefill_step(model, device="cpu")(
        params, batches[0])
    plain = psteps.build_train_step(model, opt, device="cpu")
    with cpu_mesh() as mesh:
        sh = shd.shard_params(model.param_shapes(), mesh)
        act = psteps.make_act_constrainer(mesh, ("data",),
                                          sequence_parallel=sp)
        lp = shd.local_params(params, sh, mesh)
        got_logits = psteps.build_prefill_step(model, act_spec=act,
                                               device="cpu")(lp, batches[0])
        sharded = psteps.build_train_step(model, opt, act_spec=act,
                                          device="cpu")
        want = (params, adamw.init(params))
        got = (lp, adamw.init(lp))
        for b in batches:
            *want, want_m = plain(*want, b)
            pt.reset_counts()
            *got, got_m = sharded(*got, b)
            assert pt.counts()["collectives"]["all_to_all"] == 2 * LAYERS
            for k, v in want_m.items():
                assert torch.equal(got_m[k], v), k
            for (path, a), (_p, w) in zip(
                    tr.flatten_with_path({"p": got[0], "o": got[1]}),
                    tr.flatten_with_path({"p": want[0], "o": want[1]})):
                assert torch.equal(a, w), path
    assert torch.equal(got_logits, want_logits)


def test_a_parallel_block_moe_on_a_world_of_one_gives_the_unsharded_logits():
    """A parallel block (command-r's wiring) with a MoE FFN: the FFN takes
    the mixer's gathered input (``partition.moe(gathered=True)``), and on a
    (1, 1) mesh with SP the logits are the unsharded step's bit for bit."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              param_dtype="float32", parallel_block=True,
                              moe_groups=4)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(6))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 16)))}
    want = psteps.build_prefill_step(model, device="cpu")(params, batch)
    with cpu_mesh() as mesh:
        lp = shd.local_params(params, shd.shard_params(
            model.param_shapes(), mesh), mesh)
        pt.reset_counts()
        got = psteps.build_prefill_step(model, mesh=mesh, device="cpu")(
            lp, batch)
        # one sequence gather a layer: the mixer's, which the FFN reads
        assert pt.counts()["calls"]["sp_gather"] == LAYERS
    assert torch.equal(got, want)
