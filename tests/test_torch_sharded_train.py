"""The port's sharded train step on four ranks against the JAX package's
on four host devices and against the port's step without a mesh; the
loop (``run_training(state_shardings=)``) resuming across meshes.

One module fixture makes the batches from a seed with numpy and the
weights with the JAX package (carried across with ``params_from_jax``),
then runs at once: the JAX package in three subprocesses, each on four
host CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``:
its ``build_train_step(act_spec=)`` jitted with ``shard_params``' and
``shard_opt_state``'s shardings, the batch on the dp axes, the outputs
pinned to the same shardings, as ``plan_cell``'s train plan does), and four
port ranks in subprocesses (``gloo`` on the CPU: each rank its shards of
the weights and of the AdamW moments, ``local_params``; its rows of the
batch, ``shard_batch``). Two steps a case; each side writes what it
computed, the tests compare. The ranks then run the loop: two steps on
(2, 2) with a checkpoint a step, a resume of it on (1, 4), a resume of the
JAX package's checkpoint of its first step on (2, 2); this process resumes
the (2, 2) checkpoint on a world of one.

The cases, at 2 layers (float32): a reduced qwen3 (d_model 64, 4 heads of
16, 2 KV heads) on (2, 2), (1, 4) and (4, 1) with sequence parallelism
(SP) on and off; one KV head on (2, 2) with SP (a cut KV head); 2 query
heads and one KV head on (1, 4) (q gathered too); a d_ff of 126 on (1, 4)
(the guard leaves the FFN whole on 'model': every rank runs it alike, and
its weights' gradients are summed over 'model'); a reduced command-r on
(2, 2) (a parallel block, whose norm2 the forward never reads, and a tied
head, so that tok_embed takes its gradient from both ends); and
``microbatches=2`` on (2, 2).

Tolerances, each with its reason:

* ``loss``, ``xent`` and ``grad_norm``: rtol 1e-5, and ``lr`` equal — as
  ``tests/test_torch_train.py`` holds the unsharded step to the JAX
  package's: float32 sums in other orders (the vocab-parallel log-sum-exp,
  the row products' sums over 'model', the gradients' sums over 'data');
* each rank's weight, ``m`` and ``v`` shards after two steps: within
  1e-4 · max|leaf| of the matching slice of the JAX package's sharded step
  and of the port's unsharded step. The AdamW config is ``plan_cell``'s
  default (lr 3e-4, 100 warm-up steps: 3e-6 and 6e-6 at steps 1 and 2), so
  that an element whose gradient is near 0 and of the other sign (the
  sign hazard of ``tests/test_torch_train.py``) moves the weight by less
  than the tolerance; a fault in a gradient shows in ``m``, ``v`` and
  ``grad_norm``;
* no element of ``m`` after the first step (0.1 · the clipped gradient)
  is zero where the JAX package's is not;
* a world of one rank gives the unsharded step's metrics, weights and
  moments bit for bit, in both dtypes, with SP on and off, with and
  without microbatches.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
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
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.launch import partition as pt
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime.fault import TrainLoopConfig, run_training
from test_torch_common import cpu_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
B, S = 4, 16
#: batches made: the cases' two steps, then a third for the resumed loops
N_BATCHES = 3
TOL = 1e-4
METRIC_RTOL = 1e-5
#: the reduced configs, as (arch, reduced()'s overrides)
CONFIGS = {"qwen": ("qwen3-1.7b", {}),
           "qwen_kv1": ("qwen3-1.7b", {"n_kv_heads": 1}),
           "qwen_h2": ("qwen3-1.7b", {"n_heads": 2, "n_kv_heads": 1}),
           "qwen_ff126": ("qwen3-1.7b", {"d_ff": 126}),
           "command_r": ("command-r-35b", {})}
#: name -> (mesh shape, sequence parallelism, config, microbatches)
CASES = {"2x2_sp": ((2, 2), True, "qwen", 1),
         "2x2": ((2, 2), False, "qwen", 1),
         "1x4_sp": ((1, 4), True, "qwen", 1),
         "1x4": ((1, 4), False, "qwen", 1),
         "4x1_sp": ((4, 1), True, "qwen", 1),
         "4x1": ((4, 1), False, "qwen", 1),
         "2x2_sp_kv1": ((2, 2), True, "qwen_kv1", 1),
         "1x4_sp_h2": ((1, 4), True, "qwen_h2", 1),
         "1x4_sp_ff126": ((1, 4), True, "qwen_ff126", 1),
         "2x2_sp_command_r": ((2, 2), True, "command_r", 1),
         "2x2_sp_mb2": ((2, 2), True, "qwen", 2)}
LAYERS = 2
STEPS = 2
#: the JAX package's side runs its cases in this many processes at once
#: (most of the module's time is their compiles)
JAX_PROCS = 3

COMMON = """
import dataclasses, pickle, sys, time
from pathlib import Path
import numpy as np


def reduced(get_config, config):
    arch, over = config
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)
"""

JAX_SIDE = COMMON + """
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
from repro.configs import get_config
from repro.launch import sharding as shd
from repro.launch.mesh import dp_axes, use_mesh
from repro.launch.steps import build_train_step, make_act_constrainer
from repro.models import build_model
from repro.optim import adamw

d, part, parts = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
batches = np.load(d / "batches.npy")
out = {}
for name in list(cases)[part::parts]:
    shape, sp, key, mb = cases[name]
    model = build_model(reduced(get_config, configs[key]))
    params = jax.tree.map(jnp.asarray, pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    dp = dp_axes(mesh)
    act = make_act_constrainer(mesh, dp, sequence_parallel=sp)
    pshard = shd.shard_params(model.abstract_params(), mesh)
    oshard = shd.shard_opt_state(adamw.abstract_state(
        model.abstract_params()), pshard, mesh)
    bsh = {k: NamedSharding(mesh, P(dp, None)) for k in ("tokens", "labels")}
    metric = NamedSharding(mesh, P())
    fn = jax.jit(build_train_step(model, adamw.AdamWConfig(), act_spec=act,
                                  microbatches=mb),
                 in_shardings=(pshard, oshard, bsh),
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
                if name == "2x2_sp":
                    # the JAX package's checkpoint of its first step
                    ckpt.save_checkpoint(d / "jax_ckpt", 0, {
                        "params": params, "opt": opt})
    got.update(params=tree_np(params), m=tree_np(opt.m), v=tree_np(opt.v))
    out[name] = got
(d / f"jax{part}.pkl").write_bytes(pickle.dumps(out))
"""

PORT_RANK = COMMON + """
import shutil
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as ml, partition as pt, sharding as shd
from repro_torch.launch.steps import (build_train_step,
                                      make_act_constrainer, plan_cell)
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime.fault import TrainLoopConfig, run_training

rank, init, d = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
ml.init_world("gloo", rank=rank, world_size=4, init_method=init,
              device="cpu")
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
batches = torch.from_numpy(np.load(d / "batches.npy"))
OPT = adamw.AdamWConfig()
out = {}


def batch(mesh, k):
    return shard_batch({"tokens": batches[k, 0], "labels": batches[k, 1]},
                       mesh)


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree))


def arrays(tree):
    return [t.numpy() for t in tr.leaves(tree)]


def setup(key, shape):
    mesh = ml.make_test_mesh(shape, ("data", "model"), device="cpu")
    model = build_model(reduced(get_config, configs[key]), device="cpu")
    params = params_from_jax(pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()), model)
    shardings = shd.shard_params(model.param_shapes(), mesh)
    return mesh, model, params, shardings


for name, (shape, sp, key, mb) in cases.items():
    mesh, model, params, shardings = setup(key, shape)
    lp = shd.local_params(params, shardings, mesh)
    whole = [p for (p, a), b in zip(tr.flatten_with_path(lp),
                                    tr.leaves(params)) if a is b]
    opt = adamw.init(lp)
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=sp)
    step = build_train_step(model, OPT, act_spec=act, microbatches=mb,
                            device="cpu")
    got = dict(coordinate=ml.coordinate(mesh), metrics=[], counts=[],
               index=[sh.local_index(tuple(p.shape)) for p, sh in
                      zip(tr.leaves(params), tr.leaves(shardings))])
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
               + 2 * shd.shard_bytes(moments, shardings),
               whole_leaves=whole)
    out[name] = got
    if name == "2x2_sp":
        # the cell plan's train fn, run: the same step
        full = get_config("qwen3-1.7b")
        small = reduced(get_config, configs[key])
        over = {f.name: getattr(small, f.name)
                for f in dataclasses.fields(small)
                if getattr(small, f.name) != getattr(full, f.name)}
        plan = plan_cell("qwen3-1.7b", "train_4k", mesh, opt_cfg=OPT,
                         cfg_overrides=over, device="cpu")
        p0 = shd.local_params(params, shardings, mesh)
        _p, _o, met = plan.fn(p0, adamw.init(p0), batch(mesh, 0))
        out["plan"] = dict(metrics={m: float(v) for m, v in met.items()},
                           params=arrays(_p))
        # a config the sharded step does not run, on four ranks:
        # whisper's encoder and cross-attention (jamba's Mamba slots run
        # since the recurrent mixers' slice)
        rec = build_model(get_config("whisper-large-v3").reduced(),
                          device="cpu")
        rp = rec.init_params(torch.Generator().manual_seed(0))
        rlp = shd.local_params(rp, shd.shard_params(rec.param_shapes(),
                                                    mesh), mesh)
        try:
            build_train_step(rec, OPT, mesh=mesh, device="cpu")(
                rlp, adamw.init(rlp), batch(mesh, 0))
            out["recurrent"] = None
        except NotImplementedError as e:
            out["recurrent"] = str(e)


# ---- the loop: (2, 2) with a checkpoint a step, then resumes -------------
def loop(key, shape, ckpt_dir, total, first=None):
    mesh, model, params, shardings = setup(key, shape)
    lp = shd.local_params(params, shardings, mesh)
    state = {"params": lp, "opt": adamw.init(lp)}
    state_sh = {"params": shardings, "opt": shd.shard_opt_state(
        adamw.state_shapes(model.param_shapes()), shardings, mesh)}
    step = build_train_step(model, OPT, mesh=mesh, device="cpu")
    kept = {}

    def step_fn(st, b):
        p, o, met = step(st["params"], st["opt"], b)
        kept["state"] = {"params": p, "opt": o}
        return kept["state"], met
    if first is not None and ml.is_writer(mesh):
        shutil.copytree(first, ckpt_dir)
    ml.barrier(mesh)
    res = run_training(TrainLoopConfig(total_steps=total, ckpt_every=1,
                                       ckpt_dir=str(ckpt_dir)),
                       step_fn, state, lambda s: batch(mesh, s),
                       state_shardings=state_sh)
    st = kept["state"]
    return dict(losses=res["losses"], final_step=res["final_step"],
                coordinate=ml.coordinate(mesh),
                index=[sh.local_index(tuple(p.shape)) for p, sh in
                       zip(tr.leaves(params), tr.leaves(shardings))],
                params=arrays(st["params"]), m=arrays(st["opt"].m),
                v=arrays(st["opt"].v), step=int(st["opt"].step))


out["loop_2x2"] = loop("qwen", (2, 2), d / "loop_2x2", 2)
out["resume_1x4"] = loop("qwen", (1, 4), d / "loop_1x4", 3,
                         first=d / "loop_2x2")
for _ in range(600):
    if ckpt.list_steps(d / "jax_ckpt"):
        break
    time.sleep(0.5)
out["resume_jax"] = loop("qwen", (2, 2), d / "loop_jax", 2,
                         first=d / "jax_ckpt")
(d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist.destroy_process_group()
"""


def _run(procs, timeout=400):
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


def _cfg(key):
    arch, over = CONFIGS[key]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")


def _batch(batches, k):
    return {"tokens": torch.from_numpy(batches[k, 0]),
            "labels": torch.from_numpy(batches[k, 1])}


def _unsharded(key, params, batches, mb, steps):
    """The port's step without a mesh: each step's metrics, and the
    weights, ``m`` and ``v`` after the last (numpy, pytree order)."""
    model = build_model(_cfg(key), device="cpu")
    p = params_from_jax(params, model)
    o = adamw.init(p)
    step = psteps.build_train_step(model, adamw.AdamWConfig(),
                                   microbatches=mb, device="cpu")
    metrics = []
    for k in range(steps):
        p, o, met = step(p, o, _batch(batches, k))
        metrics.append({m: float(v) for m, v in met.items()})
    return dict(metrics=metrics, params=[t.numpy() for t in tr.leaves(p)],
                m=[t.numpy() for t in tr.leaves(o.m)],
                v=[t.numpy() for t in tr.leaves(o.v)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    rng = np.random.default_rng(0)
    vocab = min(_cfg(k).vocab_size for k in CONFIGS)
    batches = rng.integers(0, vocab, (N_BATCHES, 2, B, S), dtype=np.int32)
    np.save(d / "batches.npy", batches)
    params = {}
    for seed, (key, (arch, over)) in enumerate(CONFIGS.items()):
        jcfg = dataclasses.replace(jget(arch).reduced(**over),
                                   param_dtype="float32")
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
    from repro_torch.launch.mesh import free_port
    init = f"tcp://localhost:{free_port()}"
    kw = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
              env=env, cwd=d)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d),
                               str(i), str(JAX_PROCS)], **kw)
             for i in range(JAX_PROCS)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT_RANK, str(r),
                                init, str(d)], **kw) for r in range(WORLD)]
    # the port's step without a mesh, in this process meanwhile
    whole = {}
    for name, (_shape, _sp, key, mb) in CASES.items():
        if (key, mb) not in whole:
            whole[key, mb] = _unsharded(key, params[key], batches, mb, STEPS)
    whole["qwen", 1, N_BATCHES] = _unsharded("qwen", params["qwen"], batches,
                                             1, N_BATCHES)
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


def _hold_shards(got: dict, index, want: dict, what: str):
    """Each of a rank's weight, ``m`` and ``v`` shards against the slice
    ``index`` of the whole leaves in ``want``."""
    for tree in ("params", "m", "v"):
        for i, (a, idx) in enumerate(zip(got[tree], index)):
            _close(a, want[tree][i][idx], f"{what} {tree} leaf {i}")


def _jax_whole(jx: dict) -> dict:
    return {t: _leaves_np(jx[t]) for t in ("params", "m", "v")}


def _hold_metrics(got, want, what):
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL,
                                   err_msg=f"{what} {key}")
    assert got["lr"] == want["lr"], what
    assert got["moe_aux"] == 0.0, what


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_step_is_the_jax_sharded_step(ranks, case):
    """Metrics of both steps, and each rank's weight and moment shards after
    the second, against the JAX package's sharded step."""
    jx = ranks["jax"][case]
    want = _jax_whole(jx)
    for r in ranks["ranks"]:
        got = r[case]
        what = f"{case} {got['coordinate']}"
        for k in range(STEPS):
            _hold_metrics(got["metrics"][k], jx["metrics"][k],
                          f"{what} step {k + 1}")
        _hold_shards(got, got["index"], want, what)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_step_is_the_unsharded_step(ranks, case):
    _shape, _sp, key, mb = CASES[case]
    whole = ranks["whole"][key, mb]
    for r in ranks["ranks"]:
        got = r[case]
        what = f"{case} {got['coordinate']}"
        for k in range(STEPS):
            _hold_metrics(got["metrics"][k], whole["metrics"][k],
                          f"{what} step {k + 1}")
        _hold_shards(got, got["index"], whole, what)


@pytest.mark.parametrize("case", list(CASES))
def test_no_gradient_is_zero_where_the_jax_package_s_is_not(ranks, case):
    """``m`` after the first step is 0.1 · the clipped gradient: no element
    of a rank's shard is zero where the JAX package's is not (the fault of
    a collective that cuts the graph: zeros behind every gather)."""
    want = _leaves_np(ranks["jax"][case]["m1"])
    for r in ranks["ranks"]:
        got = r[case]
        for i, (a, idx) in enumerate(zip(got["m1"], got["index"])):
            w = want[i][idx]
            assert not np.any((a == 0) & (w != 0)), (case, i)
            assert np.any(a != 0) or not np.any(w != 0), (case, i)


def _train_formula(case) -> dict:
    """PERF.md §6's count of a sharded train step of L layers of
    attn + dense (swiglu) and k microbatches. Forward, a microbatch: the
    prefill's collectives (without the last position's broadcast) plus,
    with SP, the sequence gather before the head; the loss's 3 all-reduces
    over 'model' (max, sum of exponentials, gold logit) and 1 over the dp
    axes. Backward, a microbatch: each of those that carries a gradient
    transposed (an all-gather's a reduce-scatter, a reduce-scatter's an
    all-gather, an all-reduce's an all-reduce; the max carries none, the
    sum and the gold logit share one). Per step: one all-reduce a leaf
    whole on some mesh axis (``leaf_sum``), one of AdamW's sums of squares
    (``norm_sum``)."""
    shape, sp, key, mb = CASES[case]
    cfg = _cfg(key)
    H, KV, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    mp, L = shape[1], LAYERS
    # the row products' and the embedding's sums over 'model'; a d_ff that
    # does not divide 'model' leaves w_down's input whole
    R = L * (1 + (F % mp == 0)) + 1
    sp_g = ((1 if cfg.parallel_block else 2) * L + 1) if sp else 0
    calls = dict(fsdp_gather=7 * L + 2, column=5 * L, row=2 * L,
                 sp_gather=sp_g,
                 head_gather=L * (2 * (KV % mp != 0) + (H % mp != 0)),
                 embed=1, head=1, last_position=0, moe=0)
    gathers = calls["fsdp_gather"] + sp_g + calls["head_gather"]
    fwd = dict(all_gather=gathers, reduce_scatter=R if sp else 0,
               all_reduce=(0 if sp else R) + 3 + 1, broadcast=0,
               all_to_all=0)
    bwd = dict(all_gather=R if sp else 0, reduce_scatter=gathers,
               all_reduce=(0 if sp else R) + 1 + 1, all_to_all=0)
    norms = 3 + 2 * cfg.qk_norm
    whole_ffn = 3 * (F % mp != 0)
    scale = {k: v * mb for k, v in calls.items()}
    return {"calls": scale,
            "collectives": {k: v * mb for k, v in fwd.items()},
            "backward": dict({k: v * mb for k, v in bwd.items()},
                             leaf_sum=norms + whole_ffn, norm_sum=1)}


@pytest.mark.parametrize("case", list(CASES))
def test_the_collectives_follow_the_formula(ranks, case):
    want = _train_formula(case)
    for r in ranks["ranks"]:
        for k in range(STEPS):
            assert r[case]["counts"][k] == want, (case, k)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_shards_of_weights_and_moments(ranks, case):
    _shape, _sp, key, _mb = CASES[case]
    cfg = _cfg(key)
    norms = {"final_norm", "norm1", "norm2"} | (
        {"q_norm", "k_norm"} if cfg.qk_norm else set())
    for r in ranks["ranks"]:
        got = r[case]
        assert got["local_bytes"] == got["shard_bytes"], case
        assert {p[-1] for p in got["whole_leaves"]} == norms, case


def test_the_cell_plan_s_train_fn_runs_the_sharded_step(ranks):
    for r in ranks["ranks"]:
        assert r["plan"]["metrics"] == r["2x2_sp"]["metrics"][0]


def test_a_recurrent_config_on_four_ranks_names_queue_a_10d(ranks):
    """A config the sharded train step does not run yet — whisper's
    cross-attention and encoder; the recurrent mixers run since their
    slice (``tests/test_torch_sharded_recurrent.py``) — raises on four
    ranks, naming Queue A 10d."""
    for r in ranks["ranks"]:
        got = r["recurrent"]
        assert got is not None and "Queue A 10d" in got
        assert "'xattn'" in got


# ---------------------------------------------------------------------------
# the loop across meshes
# ---------------------------------------------------------------------------

def test_the_loop_on_2x2_trains_as_the_unsharded_step(ranks):
    whole = ranks["whole"]["qwen", 1]
    for r in ranks["ranks"]:
        got = r["loop_2x2"]
        assert got["final_step"] == 2 and got["step"] == 2
        np.testing.assert_allclose(got["losses"], [
            m["loss"] for m in whole["metrics"]], rtol=METRIC_RTOL)
        _hold_shards(got, got["index"], whole, "loop (2, 2)")


def test_its_checkpoint_holds_the_jax_package_s_whole_arrays(ranks):
    """The (2, 2) loop's last checkpoint, written by the mesh's first rank:
    the JAX package's ``load_checkpoint`` reads it into whole arrays equal
    to the ranks' shards put together."""
    d = ranks["d"] / "loop_2x2"
    assert ckpt.list_steps(d) == [0, 1]
    jp = ranks["params"]["qwen"]
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp)
    from repro.optim.adamw import AdamWState
    template = {"params": jp, "opt": AdamWState(
        step=np.zeros((), np.int32), m=zeros, v=zeros)}
    step, back, _ = jckpt.load_checkpoint(d, template)
    assert step == 1
    whole = {"params": _leaves_np(back["params"]),
             "m": _leaves_np(back["opt"].m), "v": _leaves_np(back["opt"].v)}
    assert int(back["opt"].step) == 2
    for r in ranks["ranks"]:
        got = r["loop_2x2"]
        for tree in ("params", "m", "v"):
            for a, idx, w in zip(got[tree], got["index"], whole[tree]):
                np.testing.assert_array_equal(a, w[idx])


def test_the_2x2_checkpoint_resumes_on_1x4(ranks):
    """The (2, 2) loop's step-2 checkpoint resumed on (1, 4): its third
    step is the unsharded run's third."""
    whole = ranks["whole"]["qwen", 1, N_BATCHES]
    for r in ranks["ranks"]:
        got = r["resume_1x4"]
        assert got["final_step"] == 3 and got["step"] == 3
        assert len(got["losses"]) == 1
        np.testing.assert_allclose(got["losses"][0],
                                   whole["metrics"][2]["loss"],
                                   rtol=METRIC_RTOL)
        _hold_shards(got, got["index"], whole, "resumed on (1, 4)")


def test_the_2x2_checkpoint_resumes_on_a_world_of_one(ranks, tmp_path):
    whole = ranks["whole"]["qwen", 1, N_BATCHES]
    d = tmp_path / "one"
    shutil.copytree(ranks["d"] / "loop_2x2", d)
    model = build_model(_cfg("qwen"), device="cpu")
    params = params_from_jax(ranks["params"]["qwen"], model)
    batches = ranks["batches"]
    with cpu_mesh() as mesh:
        sh = shd.shard_params(model.param_shapes(), mesh)
        lp = shd.local_params(params, sh, mesh)
        step = psteps.build_train_step(model, adamw.AdamWConfig(),
                                       mesh=mesh, device="cpu")
        kept = {}

        def step_fn(st, b):
            p, o, met = step(st["params"], st["opt"], b)
            kept["state"] = {"params": p, "opt": o}
            return kept["state"], met
        res = run_training(
            TrainLoopConfig(total_steps=3, ckpt_every=5, ckpt_dir=str(d)),
            step_fn, {"params": lp, "opt": adamw.init(lp)},
            lambda s: _batch(batches, s),
            state_shardings={"params": sh, "opt": shd.shard_opt_state(
                adamw.state_shapes(model.param_shapes()), sh, mesh)})
    assert res["final_step"] == 3 and len(res["losses"]) == 1
    np.testing.assert_allclose(res["losses"][0], whole["metrics"][2]["loss"],
                               rtol=METRIC_RTOL)
    st = kept["state"]
    got = {"params": [t.numpy() for t in tr.leaves(st["params"])],
           "m": [t.numpy() for t in tr.leaves(st["opt"].m)],
           "v": [t.numpy() for t in tr.leaves(st["opt"].v)]}
    _hold_shards(got, [slice(None)] * len(got["params"]), whole,
                 "resumed on (1, 1)")


def test_a_jax_checkpoint_resumes_on_the_mesh(ranks):
    """The JAX package's checkpoint of its first sharded step (case 2x2_sp)
    resumed by the port's loop on (2, 2): its second step is the JAX
    package's second."""
    jx = ranks["jax"]["2x2_sp"]
    want = _jax_whole(jx)
    for r in ranks["ranks"]:
        got = r["resume_jax"]
        assert got["final_step"] == 2 and got["step"] == 2
        np.testing.assert_allclose(got["losses"][0], jx["metrics"][1]["loss"],
                                   rtol=METRIC_RTOL)
        _hold_shards(got, got["index"], want, "JAX checkpoint on (2, 2)")


# ---------------------------------------------------------------------------
# a world of one rank, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", (1, 2))
@pytest.mark.parametrize("sp", (True, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_a_world_of_one_gives_the_unsharded_step_bit_for_bit(dtype, sp,
                                                            microbatches):
    """On a (1, 1) mesh every collective runs over a group of one and every
    leaf is whole; the loss is ``torch.logsumexp``'s arithmetic and its
    gradient ``logsumexp``'s and ``gather``'s: the sharded step's metrics,
    weights and moments are the unsharded step's bit for bit."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    want = psteps.build_train_step(model, opt, microbatches=microbatches,
                                   device="cpu")(params, adamw.init(params),
                                                 batch)
    with cpu_mesh() as mesh:
        sh = shd.shard_params(model.param_shapes(), mesh)
        act = psteps.make_act_constrainer(mesh, ("data",),
                                          sequence_parallel=sp)
        lp = shd.local_params(params, sh, mesh)
        pt.reset_counts()
        got = psteps.build_train_step(model, opt, act_spec=act,
                                      microbatches=microbatches,
                                      device="cpu")(lp, adamw.init(lp),
                                                    batch)
        counts = pt.backward_counts()
    for k, v in want[2].items():
        assert torch.equal(got[2][k], v), k
    for (path, a), (_p, b) in zip(
            tr.flatten_with_path({"p": got[0], "o": got[1]}),
            tr.flatten_with_path({"p": want[0], "o": want[1]})):
        assert torch.equal(a, b), path
    assert counts["leaf_sum"] == 5 and counts["norm_sum"] == 1


def test_a_leaf_the_graph_does_not_reach_raises(monkeypatch):
    """A gather that autograd cannot see through (here wk's, on a detached
    weight) cuts the graph: on a live mesh ``loss_and_grads`` names the
    leaf instead of giving it zeros."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    batch = {k: torch.ones((2, 8), dtype=torch.int64)
             for k in ("tokens", "labels")}
    gather = pt.fsdp_gather
    monkeypatch.setattr(pt, "fsdp_gather", lambda part, w, key: gather(
        part, w.detach() if key == "attn/wk" else w, key))
    with cpu_mesh() as mesh:
        lp = shd.local_params(params, shd.shard_params(
            model.param_shapes(), mesh), mesh)
        act = psteps.make_act_constrainer(mesh, ("data",))
        with pytest.raises(RuntimeError, match="layers/slot0/attn/wk"):
            psteps.loss_and_grads(model, lp, batch, act_spec=act)
        # without a mesh, a leaf the loss does not reach gets zeros
        _l, _m, g = psteps.loss_and_grads(model, params, batch)
        assert all(torch.isfinite(t).all() for t in tr.leaves(g))


def test_the_broadcast_has_no_transpose():
    x = torch.ones((2, 4, 8), requires_grad=True)
    with cpu_mesh() as mesh:
        group = pt.axis_group(mesh, "model")
        with pytest.raises(RuntimeError, match="no transpose"):
            pt._broadcast(x, 0, group)
        with torch.no_grad():
            assert torch.equal(pt._broadcast(x, 0, group), x)


def test_the_collectives_transposes_on_a_group_of_one():
    """Each collective's backward on a group of one: the cotangent itself,
    counted in ``BACKWARD``."""
    x = torch.randn((2, 4, 8), requires_grad=True)
    with cpu_mesh() as mesh:
        group = pt.axis_group(mesh, "model")
        pt.reset_counts()
        for fn in (lambda t: pt._all_gather(t, 1, group),
                   lambda t: pt._reduce_scatter(t, 1, group),
                   lambda t: pt._all_reduce(t, group),
                   lambda t: pt._all_to_all(t, 2, 0, group)):
            g, = torch.autograd.grad(fn(x), x, grad_outputs=x.detach() * 3)
            assert torch.equal(g, x.detach() * 3)
        assert pt.backward_counts() == dict(
            all_gather=1, reduce_scatter=1, all_reduce=1, all_to_all=1,
            leaf_sum=0, norm_sum=0)
        assert pt.counts()["collectives"] == dict(
            all_gather=1, reduce_scatter=1, all_reduce=1, broadcast=0,
            all_to_all=1)
