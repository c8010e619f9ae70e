"""The port's sharded prefill and train steps of the recurrent mixers
(Mamba, mLSTM, sLSTM) on four ranks against the JAX package's on four host
devices and against the port's steps without a mesh.

One module fixture makes the batches from a seed with numpy and the weights
with the JAX package (carried across with ``params_from_jax``), then runs
at once: the JAX package in subprocesses on four host CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
``build_prefill_step`` and ``build_train_step(act_spec=)`` jitted with
``shard_params``' and ``shard_opt_state``'s shardings, the batch on the dp
axes, as ``plan_cell`` plans them), and four port ranks in subprocesses
(``gloo`` on the CPU: each rank its shards of the weights and moments,
``local_params``; its rows of the batch, ``shard_batch``). Each side writes
what it computed; the tests compare.

The configs, float32: a reduced jamba cut to the first five slots of its
pattern (Mamba with a dense and with a MoE FFN, attention at slot 4: every
slot kind; d_model 64, Mamba heads of 16 channels, 4 experts) and a reduced
xlstm at one repeat (one mLSTM, one sLSTM; d_model 64, 4 heads). The cases,
B = 4, S = 16, ``moe_groups`` as ``plan_cell`` sets it:

* ``jamba_2x2``, ``xlstm_2x2``: (2, 2) with ``plan_cell``'s layout for a
  stack that is not attention-only (SP off);
* ``jamba_1x4``, ``xlstm_1x4``: (1, 4), SP off;
* ``jamba_2x2_sp``, ``xlstm_2x2_sp``: SP on (``REPRO_FORCE_SP=1``'s
  layout): Mamba's B, C and dt all-reduced whole over the sequence, the
  row products reduce-scattered, sLSTM's gathered output sliced;
* ``jamba_cut``: d_model 40 on (2, 2): E 80, 5 Mamba heads of 16, 40
  channels a rank, so the split cuts a head (the conv's output gathered);
* ``xlstm_cut``: d_model 48, 3 heads on (1, 4): mLSTM's 6 heads of 16 over
  24 columns a rank and sLSTM's 3 blocks of 64 over 48: both cut a head.

Tolerances, as ``tests/test_torch_sharded_moe.py``'s, each with its reason:
each rank's logits within 1e-4·max|logit| of the JAX package's sharded
step's slice and of the unsharded step's (float32 sums over "model" in
other orders); after two train steps each weight, ``m`` and ``v`` shard
within 1e-4·max|leaf|, ``loss``, ``xent``, ``moe_aux`` and ``grad_norm``
within rtol 1e-5, ``lr`` equal; no element of ``m`` after the first step
zero where the JAX package's is not. A world of one rank is bit-equal to
the unsharded steps.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
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
STEPS = 2
B, S = 4, 16
JAMBA_SLOTS = 5
#: the reduced configs, as (arch, reduced()'s overrides)
CONFIGS = {
    "jamba": ("jamba-v0.1-52b",
              {"repeats": 1, "pattern": jget("jamba-v0.1-52b").pattern[
                  :JAMBA_SLOTS]}),
    "jamba_40": ("jamba-v0.1-52b",
                 {"repeats": 1, "d_model": 40,
                  "pattern": jget("jamba-v0.1-52b").pattern[:JAMBA_SLOTS]}),
    "xlstm": ("xlstm-350m", {"repeats": 1}),
    "xlstm_48": ("xlstm-350m", {"repeats": 1, "d_model": 48, "n_heads": 3}),
}
#: name -> (mesh shape, sequence parallelism, config, moe_groups:
#: plan_cell's |dp|·|model|)
CASES = {"jamba_2x2": ((2, 2), False, "jamba", 4),
         "jamba_1x4": ((1, 4), False, "jamba", 4),
         "jamba_2x2_sp": ((2, 2), True, "jamba", 4),
         "jamba_cut": ((2, 2), False, "jamba_40", 4),
         "xlstm_2x2": ((2, 2), False, "xlstm", 1),
         "xlstm_1x4": ((1, 4), False, "xlstm", 1),
         "xlstm_2x2_sp": ((2, 2), True, "xlstm", 1),
         "xlstm_cut": ((1, 4), False, "xlstm_48", 1)}
#: the leaves a rank keeps whole: the norms and the mixers' whole leaves
WHOLE = {"jamba": {"final_norm", "norm1", "norm2", "dt_bias", "A_log", "D"},
         "xlstm": {"final_norm", "norm1", "out_norm", "r_rec", "bias"}}
#: the JAX package's side runs its jobs in this many processes at once
JAX_PROCS = 4

COMMON = """
import dataclasses, pickle, sys
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
# the train steps' compiles first, spread over the processes
for job in [(n, k) for k in ("train", "prefill") for n in cases][part::parts]:
    name, kind = job
    shape, sp, key, groups = cases[name]
    batches = np.load(d / f"batches_{key}.npy")
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
OPT = adamw.AdamWConfig()
out = {}


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree))


def arrays(tree):
    return [t.numpy() for t in tr.leaves(tree)]


for name, (shape, sp, key, groups) in cases.items():
    batches = torch.from_numpy(np.load(d / f"batches_{key}.npy"))

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
    pt.reset_counts()
    got["logits"] = build_prefill_step(model, act_spec=act, device="cpu")(
        lp, shard_batch({"tokens": batches[0, 0]}, mesh)).numpy()
    got["prefill_counts"] = pt.counts()
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
    if name not in ("jamba_2x2", "xlstm_2x2"):
        continue
    # the cell plans' prefill and train fns, run: the same steps
    arch = configs[key][0]
    full = get_config(arch)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)
            and f.name != "moe_groups"}
    p0 = shd.local_params(params, shardings, mesh)
    plan = plan_cell(arch, "prefill_32k", mesh, cfg_overrides=over,
                     device="cpu")
    out[f"plan_prefill_{key}"] = dict(
        groups=plan.cfg.moe_groups, sp=plan.act_spec.sequence_parallel,
        logits=plan.fn(p0, shard_batch({"tokens": batches[0, 0]},
                                       mesh)).numpy())
    plan = plan_cell(arch, "train_4k", mesh, opt_cfg=OPT,
                     cfg_overrides=over, device="cpu")
    _p, _o, met = plan.fn(p0, adamw.init(p0), batch(mesh, 0))
    out[f"plan_train_{key}"] = dict(groups=plan.cfg.moe_groups, metrics={
        m: float(v) for m, v in met.items()})
    if key != "xlstm":
        continue
    # the loop: two steps with a checkpoint a step, written by rank 0
    state_sh = {"params": shardings, "opt": shd.shard_opt_state(
        moments, shardings, mesh)}
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


def _cfg(key, groups, get=get_config):
    arch, over = CONFIGS[key]
    return dataclasses.replace(get(arch).reduced(**over),
                               param_dtype="float32", moe_groups=groups)


def _batch(batches, k):
    return {"tokens": torch.from_numpy(batches[k, 0]),
            "labels": torch.from_numpy(batches[k, 1])}


def _unsharded(case, params, batches) -> dict:
    """The port's steps without a mesh, with the case's groups: the prefill
    logits, each train step's metrics, and the weights, ``m`` and ``v``
    after the last (numpy, pytree order)."""
    _shape, _sp, key, groups = CASES[case]
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_recurrent")
    rng = np.random.default_rng(0)
    batches, params = {}, {}
    for seed, key in enumerate(CONFIGS):
        cfg = _cfg(key, 1, jget)
        batches[key] = rng.integers(0, cfg.vocab_size, (STEPS, 2, B, S),
                                    dtype=np.int32)
        np.save(d / f"batches_{key}.npy", batches[key])
        params[key] = jax.tree.map(np.asarray, jbuild(cfg).init_params(
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
    # the port's steps without a mesh, in this process meanwhile
    whole = {name: _unsharded(name, params[case[2]], batches[case[2]])
             for name, case in CASES.items()}
    _run(procs)
    return dict(d=d, batches=batches, params=params, whole=whole,
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
def test_each_rank_holds_its_shards_and_only_the_whole_leaves(ranks, case):
    """A rank's bytes are its shards'; it keeps whole only the norms and
    the mixers' whole leaves (Mamba's dt_bias, A_log and D; mLSTM's
    out_norm; sLSTM's r_rec and bias)."""
    want = WHOLE[CASES[case][2].split("_")[0]]
    for r in ranks["ranks"]:
        got = r[case]
        assert got["local_bytes"] == got["shard_bytes"], case
        assert {p[-1] for p in got["whole_leaves"]} == want, case


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def recurrent_formula(cfg, shape: tuple, B: int, S: int,
                          train: bool, sp: bool = False) -> dict:
    """PERF.md §6's count of a sharded prefill (``train`` False) or train
    step of a stack of ``attn``, ``mamba``, ``mlstm`` and ``slstm`` mixers
    with ``dense``, ``moe`` or no FFNs on a (|data|, |model|) mesh, B x S
    tokens, SP on or off, every split dim dividing its axis (the cases'
    configs); ``chip_smoke.py::recurrent_collectives`` is the same count.
    A layer:

    * with SP, a sequence gather before the mixer and before a dense or
      MoE FFN (unless the MoE is ``direct``);
    * Mamba: 2 FSDP gathers (in_proj, out_proj), 1 column product and the
      x/z exchange (a head gather), 3 row products (bc_proj and dt_proj
      all-reduced whole, out_proj reduced over "model"), a head gather of
      the conv's output where the channels cut a head; 6 leaf sums a slot
      (conv_w, bc_proj, dt_proj, dt_bias, A_log, D);
    * mLSTM: 6 FSDP gathers, 5 column products (up_proj, wq, wk, wv, w_if)
      and the x/z exchange, 3 head gathers (q, k, v) where its columns cut
      a head, 1 row product (down_proj); 2 leaf sums (w_if, out_norm);
    * sLSTM: 2 FSDP gathers, 2 column products (w_in, out_proj), a head
      gather of the pre-activations where the split cuts a head or else of
      the heads' h where |model| > 1, 1 of out_proj's output; 2 leaf sums
      (r_rec, bias);
    * attention, dense and MoE FFNs as
      ``tests/test_torch_sharded_moe.py::moe_formula``;
    * a leaf sum for each norm of a slot.

    A step: the embedding's and head's FSDP gathers and the embedding's sum
    over "model"; the prefill's last-position broadcast (SP); the train
    step's sequence gather before the head, the loss's 3 + 1 all-reduces,
    the transposes (the loss's backward 2 all-reduces), AdamW's norm
    sum."""
    dsz, msz = shape
    D, R = cfg.d_model, cfg.repeats
    E = 2 * D
    sp = sp and S % msz == 0
    calls = dict.fromkeys(("fsdp_gather", "column", "row", "sp_gather",
                           "head_gather", "embed", "head", "last_position",
                           "moe"), 0)
    n = dict(ag=0, rs=0, ar=0, a2a=0)
    leaf = 1                                      # final_norm

    def add(key, k=1):                            # k a layer, R layers
        if key in calls:
            calls[key] += R * k
        else:
            n[key] += R * k
    reduce_model = "rs" if sp else "ar"           # a row product's sum
    G = cfg.moe_groups if (B * S) % cfg.moe_groups == 0 else 1
    shared = (G // dsz) % msz != 0
    direct = sp and B // dsz == 1 and not shared
    for mixer, ffn in cfg.pattern:
        add("sp_gather", sp)
        leaf += 1                                 # norm1
        if mixer == "mamba":
            add("fsdp_gather", 2)
            add("column")
            add("row", 3)
            add("head_gather", 1 + ((E // msz) % cfg.ssm_head_p != 0))
            add("ar", 2)
            add(reduce_model)
            leaf += 6
        elif mixer == "mlstm":
            add("fsdp_gather", 6)
            add("column", 5)
            add("row")
            add("head_gather", 1 + 3 * ((E // (D // cfg.n_heads)) % msz
                                        != 0))
            add(reduce_model)
            leaf += 2
        elif mixer == "slstm":
            add("fsdp_gather", 2)
            add("column", 2)
            add("head_gather", int(msz > 1) + 1)
            leaf += 2
        else:
            add("fsdp_gather", 4)
            add("column", 3)
            add("row")
            add("head_gather", 2 * (cfg.n_kv_heads % msz != 0)
                + (cfg.n_heads % msz != 0))
            add(reduce_model)
            leaf += 2 * cfg.qk_norm
        if ffn == "dense":
            add("sp_gather", sp)
            add("fsdp_gather", 3 if cfg.act == "swiglu" else 2)
            add("column", 2 if cfg.act == "swiglu" else 1)
            add("row")
            add(reduce_model)
            leaf += 1                             # norm2
        elif ffn == "moe":
            ep = cfg.n_experts % dsz == 0
            ff = cfg.expert_d_ff % msz == 0
            add("moe")
            add("fsdp_gather")                    # the router
            add("sp_gather", sp and not direct)
            add("ag", (ff and not shared) + (not direct and not shared))
            add("rs", ff and not shared)
            add("ar", (ff and shared) + 1)        # + aux
            add("a2a", 2 * ep)
            leaf += 2 + 3 * (not (ep and ff))     # norm2, the router
    calls["fsdp_gather"] += 2
    calls["embed"] = calls["head"] = 1
    n[reduce_model] += 1                          # the embedding's sum
    calls["last_position"] = int(not train)
    calls["sp_gather"] += sp and train
    gathers = calls["fsdp_gather"] + calls["sp_gather"] \
        + calls["head_gather"] + n["ag"]
    fwd = dict(all_gather=gathers, reduce_scatter=n["rs"],
               all_reduce=n["ar"] + 4 * train,
               broadcast=int(sp and not train), all_to_all=n["a2a"])
    out = {"calls": calls, "collectives": fwd}
    if train:
        out["backward"] = dict(all_gather=n["rs"], reduce_scatter=gathers,
                               all_reduce=n["ar"] + 2, all_to_all=n["a2a"],
                               leaf_sum=leaf, norm_sum=1)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_the_collectives_follow_the_formula(ranks, case):
    shape, sp, key, groups = CASES[case]
    cfg = _cfg(key, groups)
    for r in ranks["ranks"]:
        assert r[case]["prefill_counts"] == recurrent_formula(
            cfg, shape, B, S, False, sp), case
        for k in range(STEPS):
            assert r[case]["counts"][k] == recurrent_formula(
                cfg, shape, B, S, True, sp), (case, k)


def test_the_cut_cases_cut_a_head():
    """``jamba_cut``'s ranks hold 40 of 80 Mamba channels (2.5 heads of
    16); ``xlstm_cut``'s 24 of mLSTM's 96 columns (1.5 heads of 16) and 48
    of sLSTM's 192 pre-activations (3/4 of a head's 64): the formula's
    extra head gathers."""
    jamba = _cfg("jamba_40", 4)
    assert (2 * jamba.d_model // 2) % jamba.ssm_head_p != 0
    xl = _cfg("xlstm_48", 1)
    hd = xl.d_model // xl.n_heads
    assert (2 * xl.d_model // 4) % hd != 0 and xl.n_heads % 4 != 0


# ---------------------------------------------------------------------------
# the cell plans, the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ("jamba", "xlstm"))
def test_the_cell_plans_run_the_sharded_steps(ranks, key):
    """``plan_cell``'s prefill and train fns on (2, 2): SP off (the stack
    is not attention-only), the groups |dp|·|model|, the case's steps."""
    for r in ranks["ranks"]:
        pre = r[f"plan_prefill_{key}"]
        assert pre["sp"] is False
        assert pre["groups"] == CASES[f"{key}_2x2"][3]
        np.testing.assert_array_equal(pre["logits"],
                                      r[f"{key}_2x2"]["logits"])
        assert r[f"plan_train_{key}"]["metrics"] == \
            r[f"{key}_2x2"]["metrics"][0]


def test_the_loop_trains_and_its_checkpoint_is_the_jax_package_s(ranks):
    """``run_training(state_shardings=)`` of the reduced xlstm on (2, 2):
    two steps, the step-by-step run's; its last checkpoint, written by the
    mesh's first rank, read by the JAX package into whole arrays equal to
    the ranks' shards put together."""
    whole = ranks["whole"]["xlstm_2x2"]
    jp = ranks["params"]["xlstm"]
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
        _hold_shards(got, r["xlstm_2x2"]["index"], whole, "loop (2, 2)")
        for tree in ("params", "m", "v"):
            for a, idx, w in zip(got[tree], r["xlstm_2x2"]["index"],
                                 stored[tree]):
                np.testing.assert_array_equal(a, w[idx])


# ---------------------------------------------------------------------------
# in this process: the specs, the guard, a world of one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", ((2, 2), (4, 1), (1, 4), (16, 16)))
@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "xlstm-350m"))
def test_weight_specs_agree_with_shard_params(mesh_shape, arch):
    """Every leaf a sharded layer reads, at full width: ``weight_specs``'
    spec (one layer's) is ``shard_params``' without the repeats entry, the
    mixers' leaves included (the norms and sLSTM's bias too)."""
    cfg = get_config(arch)
    mesh = pmesh.AbstractMesh(mesh_shape, ("data", "model"))
    specs = pt.weight_specs(cfg, mesh)
    tree = shd.shard_params(build_model(cfg, device="meta").param_shapes(),
                            mesh)
    mixers = {"mamba", "mlstm", "slstm"}
    seen = set()
    for path, sh in tr.flatten_with_path(tree):
        if path[0] != "layers" or path[2] not in mixers:
            continue
        key = f"{path[2]}/{path[-1]}"
        assert specs[key] == tuple(sh.spec[1:]), (path, specs[key],
                                                  sh.spec)
        seen.add(key)
    mixers_of = {m for m, _f in cfg.pattern}
    want = {k for k in specs if k.split("/")[0] in mixers_of & mixers}
    assert seen == want and len(want) >= 4


def test_the_guard_runs_the_recurrent_mixers_and_still_names_queue_a_10d():
    for arch in ("jamba-v0.1-52b", "xlstm-350m", "mixtral-8x7b"):
        assert pt.unsupported(get_config(arch)) is None, arch
    assert "xattn" in pt.unsupported(get_config("whisper-large-v3"))
    assert "vision" in pt.unsupported(get_config("internvl2-76b"))


@pytest.mark.parametrize("sp", (True, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("key", ("jamba", "xlstm"))
def test_a_world_of_one_gives_the_unsharded_steps_bit_for_bit(key, dtype,
                                                             sp):
    """On a (1, 1) mesh every collective runs over a group of one and every
    leaf is whole: the sharded prefill's logits and two train steps'
    metrics, weights and moments are the unsharded steps' bit for bit, and
    the collectives the formula's (two repeats of the pattern: the layers'
    collectives twice, the stacked leaves' sums once)."""
    cfg = dataclasses.replace(_cfg(key, 1), param_dtype=dtype, repeats=2)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
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
        pt.reset_counts()
        got_logits = psteps.build_prefill_step(model, act_spec=act,
                                               device="cpu")(lp, batches[0])
        assert pt.counts() == recurrent_formula(cfg, (1, 1), B, S, False, sp)
        sharded = psteps.build_train_step(model, opt, act_spec=act,
                                          device="cpu")
        want = (params, adamw.init(params))
        got = (lp, adamw.init(lp))
        for b in batches:
            *want, want_m = plain(*want, b)
            pt.reset_counts()
            *got, got_m = sharded(*got, b)
            assert dict(pt.counts(), backward=pt.backward_counts()) == \
                recurrent_formula(cfg, (1, 1), B, S, True, sp)
            for k, v in want_m.items():
                assert torch.equal(got_m[k], v), k
            for (path, a), (_p, w) in zip(
                    tr.flatten_with_path({"p": got[0], "o": got[1]}),
                    tr.flatten_with_path({"p": want[0], "o": want[1]})):
                assert torch.equal(a, w), path
    assert torch.equal(got_logits, want_logits)
