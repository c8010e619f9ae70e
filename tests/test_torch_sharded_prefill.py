"""The port's sharded prefill step on four ranks against the JAX package's
on four host devices and against the port's step without a mesh.

One module fixture makes the inputs from a seed with numpy and the weights
with the JAX package (carried across with ``params_from_jax``), then runs
at once: the JAX package in a subprocess on four host CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
``build_prefill_step`` jitted with ``shard_params``' shardings, the batch
on the dp axes and ``out_shardings=P(dp, None, "model")``), and four port
ranks in subprocesses (``gloo`` on the CPU: each rank its shards of the
weights, ``local_params``; its rows of the batch, ``shard_batch``; its
logit shard). Each writes what it computed; the tests compare.

The cases: a reduced qwen3 (2 layers, d_model 64, 4 heads of 16, 2 KV
heads, float32) on the meshes (2, 2), (1, 4) and (4, 1), with sequence
parallelism (SP) on and off; on (1, 4) the 2 KV heads do not divide
'model', so the column split of wk and wv cuts a head; the same qwen3
with one KV head on (2, 2), a cut head with SP; and with 2 query heads
and one KV head on (1, 4), where the query heads do not divide 'model'
either; and a d_ff of 126 on (1, 4), which the rules' guard leaves whole
(every rank computes the whole FFN, and w_down's product needs no
reduction); and a reduced command-r on (2, 2), whose parallel block
gathers the sequence once a layer and whose head is the transposed
embedding.

Tolerance: each rank's logit shard within 1e-4·max|logit| of the matching
slice of the JAX package's sharded step and of the port's unsharded step
(float32; the sum over 'model' of the row-parallel products rounds
differently from one product). The weights round-trip bit for bit, and a
world of one rank gives the unsharded step's logits bit for bit.
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

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.launch import partition as pt
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax
from test_torch_common import cpu_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
B, S = 4, 16
TOL = 1e-4
#: the reduced configs, as (arch, reduced()'s overrides)
CONFIGS = {"qwen": ("qwen3-1.7b", {}),
           "qwen_kv1": ("qwen3-1.7b", {"n_kv_heads": 1}),
           "qwen_h2": ("qwen3-1.7b", {"n_heads": 2, "n_kv_heads": 1}),
           "qwen_ff126": ("qwen3-1.7b", {"d_ff": 126}),
           "command_r": ("command-r-35b", {})}
#: name -> (mesh shape, sequence parallelism, config)
CASES = {"2x2_sp": ((2, 2), True, "qwen"), "2x2": ((2, 2), False, "qwen"),
         "1x4_sp": ((1, 4), True, "qwen"), "1x4": ((1, 4), False, "qwen"),
         "4x1_sp": ((4, 1), True, "qwen"), "4x1": ((4, 1), False, "qwen"),
         "2x2_sp_kv1": ((2, 2), True, "qwen_kv1"),
         "1x4_sp_h2": ((1, 4), True, "qwen_h2"),
         "1x4_sp_ff126": ((1, 4), True, "qwen_ff126"),
         "2x2_sp_command_r": ((2, 2), True, "command_r")}
LAYERS = 2

COMMON = """
import dataclasses, pickle, sys
from pathlib import Path
import numpy as np


def reduced(get_config, config):
    arch, over = config
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")
"""

JAX_SIDE = COMMON + """
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import sharding as shd
from repro.launch.mesh import dp_axes, use_mesh
from repro.launch.steps import build_prefill_step, make_act_constrainer
from repro.models import build_model

d = Path(sys.argv[1])
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
tokens = jnp.asarray(np.load(d / "tokens.npy"))
out = {}
for name, (shape, sp, key) in cases.items():
    model = build_model(reduced(get_config, configs[key]))
    params = jax.tree.map(jnp.asarray, pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    dp = dp_axes(mesh)
    act = make_act_constrainer(mesh, dp, sequence_parallel=sp)
    fn = jax.jit(build_prefill_step(model, act_spec=act),
                 in_shardings=(shd.shard_params(model.abstract_params(),
                                                mesh),
                               {"tokens": NamedSharding(mesh, P(dp, None))}),
                 out_shardings=NamedSharding(mesh, P(dp, None, "model")))
    with use_mesh(mesh):
        out[name] = np.asarray(fn(params, {"tokens": tokens}))
(d / "jax.pkl").write_bytes(pickle.dumps(out))
"""

PORT_RANK = COMMON + """
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as ml, partition as pt, sharding as shd
from repro_torch.launch.steps import (build_prefill_step,
                                      make_act_constrainer, plan_cell)
from repro_torch.models import build_model
from repro_torch.models.interop import params_from_jax

rank, init, d = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
ml.init_world("gloo", rank=rank, world_size=4, init_method=init,
              device="cpu")
cases, configs = pickle.loads((d / "cases.pkl").read_bytes())
tokens = torch.from_numpy(np.load(d / "tokens.npy"))
out = {}


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tr.leaves(tree))


for name, (shape, sp, key) in cases.items():
    mesh = ml.make_test_mesh(shape, ("data", "model"), device="cpu")
    model = build_model(reduced(get_config, configs[key]), device="cpu")
    params = params_from_jax(pickle.loads(
        (d / f"params_{key}.pkl").read_bytes()), model)
    shardings = shd.shard_params(model.param_shapes(), mesh)
    lp = shd.local_params(params, shardings, mesh)
    back = shd.gather_params(lp, shardings, mesh)
    act = make_act_constrainer(mesh, ml.dp_axes(mesh), sequence_parallel=sp)
    pt.reset_counts()
    logits = build_prefill_step(model, act_spec=act, device="cpu")(
        lp, shard_batch({"tokens": tokens}, mesh))
    out[name] = dict(
        coordinate=ml.coordinate(mesh), logits=logits.numpy(),
        counts=pt.counts(), local_bytes=nbytes(lp),
        shard_bytes=shd.shard_bytes(model.param_shapes(), shardings),
        whole_bytes=nbytes(params),
        whole_leaves=[p for (p, a), b in zip(tr.flatten_with_path(lp),
                                              tr.leaves(params)) if a is b],
        round_trip=all(torch.equal(a, b) for a, b in
                       zip(tr.leaves(back), tr.leaves(params))))
    if name == "2x2_sp":
        # the cell plan's prefill fn, run: the same step
        full = get_config("qwen3-1.7b")
        small = reduced(get_config, configs[key])
        over = {f.name: getattr(small, f.name)
                for f in dataclasses.fields(small)
                if getattr(small, f.name) != getattr(full, f.name)}
        plan = plan_cell("qwen3-1.7b", "prefill_32k", mesh,
                         cfg_overrides=over, device="cpu")
        out["plan"] = plan.fn(lp, shard_batch({"tokens": tokens}, mesh)
                              ).numpy()
        # a config the sharded step does not run, on four ranks:
        # internvl2's vision prefix (jamba's Mamba slots run since the
        # recurrent mixers' slice)
        rec = build_model(get_config("internvl2-76b").reduced(),
                          device="cpu")
        rp = rec.init_params(torch.Generator().manual_seed(0))
        try:
            build_prefill_step(rec, mesh=mesh, device="cpu")(
                shd.local_params(rp, shd.shard_params(rec.param_shapes(),
                                                      mesh), mesh),
                {"tokens": tokens[:2]})
            out["recurrent"] = None
        except NotImplementedError as e:
            out["recurrent"] = str(e)
(d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist.destroy_process_group()
"""


def _run(procs, timeout=300):
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_prefill")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, min(_cfg(k).vocab_size for k in CONFIGS),
                          (B, S), dtype=np.int32)
    np.save(d / "tokens.npy", tokens)
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
    init = f"tcp://localhost:{_free_port()}"
    kw = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
              env=env, cwd=d)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d)], **kw)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT_RANK, str(r),
                                init, str(d)], **kw) for r in range(WORLD)]
    # the port's step without a mesh, in this process meanwhile
    whole = {}
    for key, p in params.items():
        model = build_model(_cfg(key), device="cpu")
        whole[key] = psteps.build_prefill_step(model, device="cpu")(
            params_from_jax(p, model),
            {"tokens": torch.from_numpy(tokens)}).numpy()
    _run(procs)
    return dict(whole=whole,
                jax=pickle.loads((d / "jax.pkl").read_bytes()),
                ranks=[pickle.loads((d / f"rank{r}.pkl").read_bytes())
                       for r in range(WORLD)])


def _free_port() -> int:
    from repro_torch.launch.mesh import free_port
    return free_port()


def _shard(full, coord, shape):
    """A rank's (B/|data|, 1, Vpad/|model|) slice of ``full``."""
    dsz, msz = shape
    rb, rv = full.shape[0] // dsz, full.shape[2] // msz
    d, m = coord["data"], coord["model"]
    return full[d * rb:(d + 1) * rb, :, m * rv:(m + 1) * rv]


def _close(got, want, what):
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    tol = TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_logits_are_the_unsharded_step_s_slice(ranks, case):
    shape, _sp, key = CASES[case]
    whole = ranks["whole"][key]
    assert whole.shape == (B, 1, _cfg(key).padded_vocab)
    for r in ranks["ranks"]:
        got = r[case]
        want = _shard(whole, got["coordinate"], shape)
        _close(got["logits"], want, f"{case} {got['coordinate']}")


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_logits_are_the_jax_sharded_step_s_slice(ranks, case):
    shape, _sp, key = CASES[case]
    jax_full = ranks["jax"][case]
    _close(jax_full, ranks["whole"][key], f"{case}: JAX against the port")
    for r in ranks["ranks"]:
        got = r[case]
        _close(got["logits"], _shard(jax_full, got["coordinate"], shape),
               f"{case} {got['coordinate']}")


@pytest.mark.parametrize("case", list(CASES))
def test_the_collectives_follow_the_formula(ranks, case):
    """Per layer 7 FSDP gathers (wq, wk, wv, wo, w_gate, w_up, w_down), 5
    column and 2 row products, with SP 2 sequence gathers and 2
    reduce-scatters (a parallel block: 1 sequence gather, the FFN reads
    the mixer's), without 2 all-reduces, and a head gather of k and of
    v where the column split cuts a KV head (KV % |model| != 0), of q
    where H % |model| != 0; per step the embedding's and the head's FSDP
    gathers, the embedding's reduction, and with SP the last position's
    broadcast."""
    shape, sp, key = CASES[case]
    cfg = _cfg(key)
    H, KV, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    mp = shape[1]
    L = LAYERS
    # wo's and w_down's sums over 'model', and the embedding's; a d_ff
    # that does not divide 'model' leaves w_down's input whole (the
    # rules' guard), and its product needs no reduction
    reduced = L * (1 + (F % mp == 0)) + 1
    calls = dict(fsdp_gather=7 * L + 2, column=5 * L, row=2 * L,
                 sp_gather=(1 if cfg.parallel_block else 2) * L if sp
                 else 0,
                 head_gather=L * (2 * (KV % mp != 0) + (H % mp != 0)),
                 embed=1, head=1, last_position=1, moe=0)
    coll = dict(all_gather=calls["fsdp_gather"] + calls["sp_gather"]
                + calls["head_gather"],
                reduce_scatter=reduced if sp else 0,
                all_reduce=0 if sp else reduced,
                broadcast=1 if sp else 0, all_to_all=0)
    for r in ranks["ranks"]:
        assert r[case]["counts"] == {"calls": calls, "collectives": coll}


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_shards_and_only_the_norms_whole(ranks, case):
    shape, _sp, key = CASES[case]
    cfg = _cfg(key)
    norms = {"final_norm", "norm1", "norm2"} | (
        {"q_norm", "k_norm"} if cfg.qk_norm else set())
    for r in ranks["ranks"]:
        got = r[case]
        assert got["round_trip"]
        assert got["local_bytes"] == got["shard_bytes"]
        assert {p[-1] for p in got["whole_leaves"]} == norms
        if shape == (2, 2):
            # every matrix split four ways: a quarter, and the norms
            assert got["local_bytes"] < 0.26 * got["whole_bytes"]


def test_the_cell_plan_s_prefill_fn_runs_the_sharded_step(ranks):
    for r in ranks["ranks"]:
        np.testing.assert_array_equal(r["plan"], r["2x2_sp"]["logits"])


def test_a_recurrent_config_on_four_ranks_names_queue_a_10d(ranks):
    """A config the sharded prefill does not run yet — internvl2's vision
    prefix; the recurrent mixers run since their slice
    (``tests/test_torch_sharded_recurrent.py``) — raises on four ranks,
    naming Queue A 10d."""
    for r in ranks["ranks"]:
        got = r["recurrent"]
        assert got is not None and "Queue A 10d" in got
        assert "a vision prefix" in got


# ---------------------------------------------------------------------------
# a world of one rank, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("sp", (True, False))
def test_a_world_of_one_gives_the_unsharded_logits_bit_for_bit(dtype, sp):
    """On a (1, 1) mesh every collective runs over a group of one and every
    weight is whole: the sharded step's logits are the unsharded step's,
    bit for bit, in both dtypes."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)))
    want = psteps.build_prefill_step(model, device="cpu")(
        params, {"tokens": tokens})
    with cpu_mesh() as mesh:
        shardings = shd.shard_params(model.param_shapes(), mesh)
        act = psteps.make_act_constrainer(mesh, ("data",),
                                          sequence_parallel=sp)
        pt.reset_counts()
        got = psteps.build_prefill_step(model, act_spec=act, device="cpu")(
            shd.local_params(params, shardings, mesh), {"tokens": tokens})
        counts = pt.counts()
    assert torch.equal(got, want)
    assert counts["calls"]["sp_gather"] == (2 * cfg.repeats if sp else 0)
    assert counts["collectives"]["broadcast"] == int(sp)


def test_the_constrainer_moves_a_tensor_between_the_layouts():
    """Over a 'model' axis of one rank the SP and gathered layouts share a
    shape: ``split`` says which ``h`` holds, and a gather is issued all the
    same; without ``seq_len`` a rank-local tensor is left as it is."""
    h = torch.randn(2, 8, 4)
    with cpu_mesh() as mesh:
        c = psteps.make_act_constrainer(mesh, ("data",))
        assert c(h) is h
        pt.reset_counts()
        assert c(h, True, seq_len=8, split=True).equal(h)
        assert pt.CALLS["sp_gather"] == 1
        assert c(h, False, seq_len=8, split=False).equal(h)
        assert c(h, True, seq_len=8) is h
        assert pt.CALLS["sp_gather"] == 1


def test_without_a_mesh_the_step_is_the_head_of_the_last_position():
    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(5))
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int64)}
    x, _ = model.hidden_states(params, batch)
    assert torch.equal(psteps.build_prefill_step(model, device="cpu")(
        params, batch), model.head(params, x[:, -1:]))
    assert model._partition(None, batch) is None
