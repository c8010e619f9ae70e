"""The port's mesh paths run by four ranks against the JAX package's on four
host devices: context-parallel decode attention and a reduced qwen3's
context-parallel decode step, the mesh-sharded sweep (``run_rows(mesh=)``,
``SimulationService(mesh=)``, with the store's keys and npz bytes), the
elastic checkpoint load and ``shard_batch``.

One module fixture makes the inputs from a seed with numpy, writes the JAX
package's checkpoint, then runs at once: the JAX package in a subprocess on
four host CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=
4``: ``make_cp_decode_attention`` under ``shard_map``, ``simulate_sharded``,
the unsharded references and its service's store), and four port ranks in
subprocesses (``gloo``, a 2 x 2 ``("data", "model")`` mesh on the CPU).
Each writes what it computed; the tests compare.

Tolerances: the attention in float32 within 2e-5 (``tests/test_kernels.py``'s
attention tolerance); the decode step's logits within 1e-3·max|logit| +
1e-3 with equal greedy tokens; the simulator's every field exactly, the
store's bytes exactly (zip clock pinned in every process).
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
from repro_torch.core import sweep as psw
from repro_torch.core import topology as PT
from repro_torch.core import backend as pbk
from repro_torch.launch import mesh as pmesh
from repro_torch.service import SimulationService as PService
from test_torch_common import cpu_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESH = ((2, 2), ("data", "model"))
CP_CASES = {"seq_model": (("model",), ("data",)),
            "seq_data_model": (("data", "model"), ())}
ATTN = dict(B=4, S=16, H=4, KV=2, hd=16)
#: (pos, window) of each attention case; pos 2 leaves the later shards
#: with no position kept
ATTN_STEPS = ((9, 0), (2, 0), (13, 6))
LM_B, LM_STEPS, LM_SMAX = 4, 6, 8
ATTN_TOL = 2e-5

#: the three task models, as both packages build them; 10 rows a sweep
MODELS = """
def models(sw, T, gen):
    topo = T.one_cluster(4, 2)
    out = {}
    for name, kw in (
            ("divisible", dict(W_list=[3000], lam_list=[2, 5])),
            ("dag", dict(task_model="dag", dag=gen.merge_sort(200, 32),
                         lam_list=[2, 5])),
            ("adaptive", dict(task_model="adaptive", W_list=[3000],
                              lam_list=[2, 5]))):
        rkw = {k: v for k, v in kw.items() if k != "W_list"}
        model = sw.resolve_model(topo, W_list=kw.get("W_list", (0,)), **rkw)
        rows = sw.grid_rows(kw.get("W_list", (0,)), kw["lam_list"], 5)
        out[name] = (topo, kw, model, rows)
    return out


def pin_zip_clock():
    import time, types, zipfile
    fixed = time.mktime((2020, 1, 1, 0, 0, 0, 0, 0, -1))
    zipfile.time = types.SimpleNamespace(time=lambda: fixed,
                                         localtime=time.localtime)


def grid_fields(g):
    import dataclasses
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name not in ("p", "extras")}
    out.update({"extras/" + k: np.asarray(v) for k, v in g.extras.items()})
    return out
"""

JAX_SIDE = MODELS + """
import dataclasses, pickle, sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import dag_gen as gen, sweep as sw, topology as T
from repro.configs import get_config
from repro.launch.mesh import use_mesh
from repro.models import attention as A, build_model
from repro.service import SimulationService

d = Path(sys.argv[1])
pin_zip_clock()
inp = dict(np.load(d / "inputs.npz"))
steps = pickle.loads((d / "steps.pkl").read_bytes())
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for case, (cp, bx) in steps["cp_cases"].items():
    f = A.make_cp_decode_attention(cp, bx)
    for k, (pos, window) in enumerate(steps["attn_steps"]):
        args = [jnp.asarray(inp[n]) for n in ("q", "kc", "vc", "kn", "vn")]
        with use_mesh(mesh):
            o, kc, vc = jax.jit(lambda q, kc, vc, kn, vn, p: f(
                q, kc, vc, kn, vn, p, p + 1, window=window))(
                *args, jnp.int32(pos))
        out[f"attn/{case}/{k}"] = [np.asarray(x) for x in (o, kc, vc)]
for k, (pos, window) in enumerate(steps["attn_steps"]):
    q, kc, vc, kn, vn = (jnp.asarray(inp[n]) for n in
                         ("q", "kc", "vc", "kn", "vn"))
    kc, vc = kc.at[:, pos].set(kn[:, 0]), vc.at[:, pos].set(vn[:, 0])
    out[f"attn/whole/{k}"] = np.asarray(
        A.decode_attention(q, kc, vc, pos + 1, window=window))

cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                          param_dtype="float32")
model = build_model(cfg)
params = jax.tree.map(jnp.asarray, pickle.loads((d / "params.pkl")
                                                .read_bytes()))
tokens = jnp.asarray(inp["lm_tokens"])
cache = model.init_cache(tokens.shape[0], steps["lm_smax"], jnp.float32)
step = jax.jit(model.decode_step)
logits = []
for i in range(tokens.shape[1]):
    lg, cache = step(params, cache, tokens[:, i:i + 1], jnp.int32(i))
    logits.append(np.asarray(lg))
out["lm/logits"] = np.stack(logits)
out["lm/cache"] = jax.tree.map(np.asarray, cache)

for name, (topo, kw, model, rows) in models(sw, T, gen).items():
    out[f"sweep/{name}/whole"] = grid_fields(sw.run_rows(model, rows,
                                                         backend="jax"))
    out[f"sweep/{name}/sharded"] = grid_fields(sw.run_rows(
        model, rows, mesh=mesh, shard_axes=("data", "model")))
    svc = SimulationService(root=d / "jstore")
    out[f"service/{name}/sweep"] = grid_fields(
        svc.sweep(topo, chunk_size=4, reps=5, **kw))
    out[f"service/{name}/query"] = grid_fields(
        svc.query(topo, reps=3, **kw).grid)
(d / "jax.pkl").write_bytes(pickle.dumps(out))
"""

PORT_RANK = MODELS + """
import dataclasses, pickle, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import dag_gen as gen, sweep as sw, topology as T
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh as ml
from repro_torch.launch.serve import Request, decode_batch
from repro_torch.launch.sharding import NamedSharding
from repro_torch.models import attention as A, build_model
from repro_torch.models.interop import params_from_jax
from repro_torch.service import SimulationService

rank, init, d = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
pin_zip_clock()
ml.init_world("gloo", rank=rank, world_size=4, init_method=init,
              device="cpu")
mesh = ml.make_test_mesh((2, 2), ("data", "model"), device="cpu")
inp = dict(np.load(d / "inputs.npz"))
steps = pickle.loads((d / "steps.pkl").read_bytes())
out = {"coordinate": ml.coordinate(mesh)}


def local(x, cp, bx, seq_dim=1):
    nb, ns = ml.axis_size(mesh, *bx), ml.axis_size(mesh, *cp)
    b = ml.shard_index(mesh, bx) if bx else 0
    s = ml.shard_index(mesh, cp)
    rb = x.shape[0] // nb
    idx = [slice(b * rb, (b + 1) * rb)] + [slice(None)] * (x.ndim - 1)
    if seq_dim is not None:
        rs = x.shape[seq_dim] // ns
        idx[seq_dim] = slice(s * rs, (s + 1) * rs)
    return torch.from_numpy(np.ascontiguousarray(x[tuple(idx)]))


for case, (cp, bx) in steps["cp_cases"].items():
    f = A.make_cp_decode_attention(cp, bx, mesh)
    for k, (pos, window) in enumerate(steps["attn_steps"]):
        q = local(inp["q"], cp, bx, None)
        kc, vc = local(inp["kc"], cp, bx), local(inp["vc"], cp, bx)
        kn, vn = local(inp["kn"], cp, bx, None), local(inp["vn"], cp, bx,
                                                        None)
        p = torch.tensor([pos])
        o, kc, vc = f(q, kc, vc, kn, vn, p, (p + 1).int(), window=window)
        out[f"attn/{case}/{k}"] = [x.numpy() for x in (o, kc, vc)]
        # the same step in each dtype against one shard of the whole
        # sequence (this rank's batch rows), normalized here
        for dt in (torch.float32, torch.bfloat16):
            q, kn, vn = (local(inp[n], cp, bx, None).to(dt)
                         for n in ("q", "kn", "vn"))
            kc, vc = (local(inp[n], cp, bx).to(dt) for n in ("kc", "vc"))
            o, _, _ = f(q, kc, vc, kn, vn, p, (p + 1).int(), window=window)
            kw, vw = (local(inp[n], (), bx).to(dt).clone()
                      for n in ("kc", "vc"))
            kw[:, pos], vw[:, pos] = kn[:, 0], vn[:, 0]
            o1, _m, l1 = A.decode_attention_partial(q, kw, vw, 0, pos + 1,
                                                    window=window)
            one = (o1 / torch.clamp(l1, min=1e-30)[..., None])[:, None]
            out[f"attn_split/{case}/{k}/{dt}"] = (
                o.float().numpy(), one.to(dt).float().numpy())

cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                          param_dtype="float32")
model = build_model(cfg, device="cpu")
params = params_from_jax(pickle.loads((d / "params.pkl").read_bytes()),
                         model)
for case, (cp, bx) in steps["cp_cases"].items():
    tokens = local(inp["lm_tokens"], cp, bx, None).long()
    ns = ml.axis_size(mesh, *cp)
    cache = model.init_cache(tokens.shape[0], steps["lm_smax"] // ns,
                             torch.float32)
    logits = []
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i,
                                      cp_axes=(cp, bx), mesh=mesh)
        logits.append(lg.numpy().copy())
    out[f"lm/{case}/logits"] = np.stack(logits)
    out[f"lm/{case}/cache"] = tr.tree_map(lambda t: t.numpy(), cache)
    reqs = [Request(uid=i, prompt=inp["serve_prompts"][i], max_new=4)
            for i in range(len(inp["serve_prompts"]))]
    out[f"serve/{case}"] = (decode_batch(model, params, reqs, device="cpu",
                                         cp_axes=(cp, bx), mesh=mesh),
                            decode_batch(model, params, reqs, device="cpu"))

from repro_torch.core import backend as bk
for name, (topo, kw, model, rows) in models(sw, T, gen).items():
    before = bk.get_backend("torch").n_run_rows
    out[f"sweep/{name}/sharded"] = grid_fields(sw.run_rows(
        model, rows, device="cpu", mesh=mesh, shard_axes=("data", "model")))
    out[f"sweep/{name}/data_only"] = grid_fields(sw.run_rows(
        model, rows, device="cpu", mesh=mesh, shard_axes=("data",)))
    out[f"sweep/{name}/runs"] = bk.get_backend("torch").n_run_rows - before
    svc = SimulationService(root=d / "pstore", device="cpu", mesh=mesh,
                            shard_axes=("data", "model"))
    out[f"service/{name}/sweep"] = grid_fields(
        svc.sweep(topo, chunk_size=4, reps=5, **kw))
    out[f"service/{name}/query"] = grid_fields(
        svc.query(topo, reps=3, **kw).grid)
    out[f"service/{name}/log"] = list(svc.broker.dispatch_log)

template = {k: (shape, getattr(torch, dtype))
            for k, (shape, dtype) in steps["ckpt_shapes"].items()}
shardings = {k: NamedSharding(mesh, s) for k, s in steps["ckpt_specs"].items()}
step, tree, _ = ckpt.load_checkpoint(d / "ckpt", template,
                                     shardings=shardings)
out["ckpt"] = {k: (v.to_local().float().numpy(), v.full_tensor()
                   .float().numpy(), tuple(v.shape), str(v.dtype),
                   [(type(p).__name__, getattr(p, "dim", None))
                    for p in v.placements]) for k, v in tree.items()}
out["ckpt_step"] = step
batch = shard_batch({"tokens": torch.arange(24).reshape(4, 6)}, mesh)
out["shard_batch"] = (batch["tokens"].to_local().numpy(),
                      tuple(batch["tokens"].shape))
(d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist.destroy_process_group()
"""


def _run(procs, timeout=600):
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


CKPT_SPECS = {"emb": ("model", None), "w": (None, "data", "model"),
              "b": (None, ("data", "model")), "s": ()}
#: the DTensor placements of CKPT_SPECS on the ("data", "model") mesh
PLACEMENTS = {"emb": [("Replicate", None), ("Shard", 0)],
              "w": [("Shard", 1), ("Shard", 2)],
              "b": [("Shard", 1), ("Shard", 1)],
              "s": [("Replicate", None), ("Replicate", None)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    rng = np.random.default_rng(0)
    a = ATTN
    inputs = dict(
        q=rng.standard_normal((a["B"], 1, a["H"], a["hd"]), np.float32),
        kc=rng.standard_normal((a["B"], a["S"], a["KV"], a["hd"]),
                               np.float32),
        vc=rng.standard_normal((a["B"], a["S"], a["KV"], a["hd"]),
                               np.float32),
        kn=rng.standard_normal((a["B"], 1, a["KV"], a["hd"]), np.float32),
        vn=rng.standard_normal((a["B"], 1, a["KV"], a["hd"]), np.float32))
    jcfg = dataclasses.replace(jget("qwen3-1.7b").reduced(),
                               param_dtype="float32")
    inputs["lm_tokens"] = rng.integers(1, jcfg.vocab_size, (LM_B, LM_STEPS),
                                       dtype=np.int32)
    inputs["serve_prompts"] = rng.integers(1, jcfg.vocab_size, (4, 4),
                                           dtype=np.int32)
    np.savez(d / "inputs.npz", **inputs)
    params = jax.tree.map(np.asarray,
                          jbuild(jcfg).init_params(jax.random.PRNGKey(0)))
    (d / "params.pkl").write_bytes(pickle.dumps(params))
    ckpt_tree = {"emb": rng.standard_normal((16, 8), np.float32),
                 "w": rng.standard_normal((2, 8, 6), np.float32),
                 "b": rng.standard_normal((2, 8), np.float32),
                 "s": np.float32(rng.standard_normal())}
    jtree = {k: jax.numpy.asarray(v, jax.numpy.bfloat16 if k == "b"
                                  else jax.numpy.float32)
             for k, v in ckpt_tree.items()}
    jckpt.save_checkpoint(d / "ckpt", 3, jtree)
    (d / "steps.pkl").write_bytes(pickle.dumps(dict(
        cp_cases=CP_CASES, attn_steps=ATTN_STEPS, lm_smax=LM_SMAX,
        ckpt_specs=CKPT_SPECS,
        ckpt_shapes={k: (tuple(v.shape), str(v.dtype))
                     for k, v in jtree.items()})))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    init = f"tcp://localhost:{pmesh.free_port()}"
    kw = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
              env=env, cwd=d)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d)], **kw)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT_RANK, str(r),
                                init, str(d)], **kw) for r in range(WORLD)]
    _run(procs)
    return dict(dir=d, inputs=inputs, jtree=jtree,
                jax=pickle.loads((d / "jax.pkl").read_bytes()),
                ranks=[pickle.loads((d / f"rank{r}.pkl").read_bytes())
                       for r in range(WORLD)])


def _slices(coord, cp, bx, shape, seq_dim=1):
    """The index of a rank's shard (its batch rows over ``bx``, its
    sequence rows over ``cp``) in a global array of ``shape``."""
    sizes = dict(zip(MESH[1], MESH[0]))

    def idx(axes):
        i = 0
        for a in axes:
            i = i * sizes[a] + coord[a]
        return i
    nb = int(np.prod([sizes[a] for a in bx]))
    ns = int(np.prod([sizes[a] for a in cp]))
    rb, rs = shape[0] // nb, shape[seq_dim] // ns if seq_dim else 0
    b = idx(bx)
    out = [slice(b * rb, (b + 1) * rb)] + [slice(None)] * (len(shape) - 1)
    if seq_dim:
        s = idx(cp)
        out[seq_dim] = slice(s * rs, (s + 1) * rs)
    return tuple(out)


@pytest.mark.parametrize("case", list(CP_CASES))
def test_cp_decode_attention_vs_jax_on_four_devices(ranks, case):
    cp, bx = CP_CASES[case]
    for k in range(len(ATTN_STEPS)):
        jo, jkc, jvc = ranks["jax"][f"attn/{case}/{k}"]
        whole = ranks["jax"][f"attn/whole/{k}"]
        np.testing.assert_allclose(jo, whole, atol=ATTN_TOL, rtol=ATTN_TOL)
        for r in ranks["ranks"]:
            o, kc, vc = r[f"attn/{case}/{k}"]
            c = r["coordinate"]
            rows = _slices(c, cp, bx, jo.shape, seq_dim=None)
            np.testing.assert_allclose(o, jo[rows], atol=ATTN_TOL,
                                       rtol=ATTN_TOL)
            np.testing.assert_allclose(o, whole[rows], atol=ATTN_TOL,
                                       rtol=ATTN_TOL)
            shard = _slices(c, cp, bx, jkc.shape)
            np.testing.assert_array_equal(kc, jkc[shard])
            np.testing.assert_array_equal(vc, jvc[shard])
            assert np.isfinite(o).all()


@pytest.mark.parametrize("case", list(CP_CASES))
def test_cp_decode_attention_does_not_depend_on_the_split(ranks, case):
    """The four ranks' merged output equals, bit for bit in float32 and in
    bf16, one shard's output over the whole sequence: the float64 partials
    (``attention.PARTIAL_DTYPE``) round alike however the cache is
    split."""
    for r in ranks["ranks"]:
        for k in range(len(ATTN_STEPS)):
            for dt in ("torch.float32", "torch.bfloat16"):
                merged, one = r[f"attn_split/{case}/{k}/{dt}"]
                assert np.isfinite(merged).all()
                np.testing.assert_array_equal(merged, one,
                                              err_msg=f"{k} {dt}")


@pytest.mark.parametrize("case", list(CP_CASES))
def test_cp_decode_step_of_reduced_qwen3_vs_jax(ranks, case):
    cp, bx = CP_CASES[case]
    want = ranks["jax"]["lm/logits"]                 # (steps, B, 1, V)
    jcache = ranks["jax"]["lm/cache"]["layers"]
    for r in ranks["ranks"]:
        got = r[f"lm/{case}/logits"]
        c = r["coordinate"]
        rows = _slices(c, cp, bx, want.shape[1:], seq_dim=None)
        for i in range(LM_STEPS):
            w = want[i][rows]
            tol = 1e-3 * np.abs(w).max() + 1e-3
            np.testing.assert_allclose(got[i], w, atol=tol, rtol=0)
            np.testing.assert_array_equal(got[i].argmax(-1), w.argmax(-1))
        for slot, leaves in r[f"lm/{case}/cache"]["layers"].items():
            for name in ("k", "v"):
                j = jcache[slot][name]                  # (R, B, S, KV, hd)
                idx = (slice(None),) + _slices(c, cp, bx, j.shape[1:])
                np.testing.assert_allclose(leaves[name], j[idx], atol=1e-5,
                                           rtol=1e-5)


@pytest.mark.parametrize("case", list(CP_CASES))
def test_decode_batch_with_cp_gives_every_rank_the_unsharded_tokens(ranks,
                                                                     case):
    for r in ranks["ranks"]:
        cp_tokens, whole = r[f"serve/{case}"]
        assert cp_tokens.shape == whole.shape == (4, 4)
        np.testing.assert_array_equal(cp_tokens, whole)


@pytest.mark.parametrize("name", ("divisible", "dag", "adaptive"))
def test_run_rows_on_a_mesh_vs_jax(ranks, name):
    whole = ranks["jax"][f"sweep/{name}/whole"]
    sharded = ranks["jax"][f"sweep/{name}/sharded"]
    assert len(whole["makespan"]) == 10          # not a multiple of 4
    assert set(whole) == set(sharded)
    for f in whole:
        np.testing.assert_array_equal(sharded[f], whole[f], err_msg=f)
    for r in ranks["ranks"]:
        assert r[f"sweep/{name}/runs"] == 2      # one shard a run, two runs
        for key in ("sharded", "data_only"):
            got = r[f"sweep/{name}/{key}"]
            assert set(got) == set(whole)
            for f in whole:
                np.testing.assert_array_equal(got[f], whole[f],
                                              err_msg=f"{key} {f}")


@pytest.mark.parametrize("name", ("divisible", "dag", "adaptive"))
def test_service_on_a_mesh_vs_jax(ranks, name):
    for what in ("sweep", "query"):
        want = ranks["jax"][f"service/{name}/{what}"]
        for r in ranks["ranks"]:
            got = r[f"service/{name}/{what}"]
            assert set(got) == set(want)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"{what} {f}")
    for r in ranks["ranks"]:
        log = r[f"service/{name}/log"]
        assert log and all(e["backend"] == "torch" for e in log)


def test_the_stores_hold_the_same_keys_and_bytes(ranks):
    jroot, proot = ranks["dir"] / "jstore", ranks["dir"] / "pstore"
    jfiles = sorted(p.name for p in jroot.iterdir()
                    if p.suffix in (".npz", ".json"))
    pfiles = sorted(p.name for p in proot.iterdir()
                    if p.suffix in (".npz", ".json"))
    # three sweeps of 3 chunks and three queries, an npz and a json each
    assert pfiles == jfiles and len(jfiles) == 2 * (3 * 3 + 3)
    for f in jfiles:
        assert (proot / f).read_bytes() == (jroot / f).read_bytes(), f


def test_load_checkpoint_with_shardings(ranks):
    full = {k: np.asarray(v, np.float32) for k, v in ranks["jtree"].items()}
    sizes = dict(zip(MESH[1], MESH[0]))
    for r in ranks["ranks"]:
        assert r["ckpt_step"] == 3
        c = r["coordinate"]
        for k, (loc, whole, shape, dtype, placements) in r["ckpt"].items():
            assert shape == full[k].shape
            assert dtype == ("torch.bfloat16" if k == "b"
                             else "torch.float32")
            np.testing.assert_array_equal(whole, full[k])
            idx = []
            for d, entry in enumerate(CKPT_SPECS[k]):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                i, n = 0, 1
                for a in axes:
                    i, n = i * sizes[a] + c[a], n * sizes[a]
                step = full[k].shape[d] // n
                idx.append(slice(i * step, (i + 1) * step))
            np.testing.assert_array_equal(loc, full[k][tuple(idx)])
            assert placements == PLACEMENTS[k], k


def test_shard_batch_places_each_rank_s_rows(ranks):
    whole = np.arange(24).reshape(4, 6)
    for r in ranks["ranks"]:
        loc, shape = r["shard_batch"]
        d = r["coordinate"]["data"]
        assert shape == (4, 6)
        np.testing.assert_array_equal(loc, whole[2 * d:2 * d + 2])


# ---------------------------------------------------------------------------
# one rank, in this process: twins of tests/test_backends.py's mesh cases
# ---------------------------------------------------------------------------

def test_mesh_requires_the_cuda_or_torch_backend():
    topo = PT.one_cluster(4, 1)
    rows = psw.grid_rows([200], [1], 1)
    model = psw.resolve_model(topo, "divisible", W_list=[200], lam_list=[1])
    with cpu_mesh((1,), ("data",)) as mesh:
        with pytest.raises(ValueError, match="'cuda' or the 'torch'"):
            psw.run_rows(model, rows, mesh=mesh, backend="oracle",
                         device="cpu")
        with pytest.raises(RuntimeError, match="no CPU form"):
            psw.run_rows(model, rows, mesh=mesh, backend="cuda",
                         device="cpu")
        g = psw.run_rows(model, rows, mesh=mesh, backend="torch",
                         device="cpu")
    want = psw.run_rows(model, rows, backend="oracle", device="cpu")
    np.testing.assert_array_equal(g.makespan, want.makespan)


def test_mesh_service_pins_default_backend(tmp_path, monkeypatch):
    """A mesh-sharded service keeps working when the environment names
    another default backend: the mesh pins its own (``torch`` on the
    CPU), and no fallback demotes it."""
    monkeypatch.setenv(pbk.BACKEND_ENV, "oracle")
    with cpu_mesh((1,), ("data",)) as mesh:
        svc = PService(root=tmp_path, device="cpu", mesh=mesh)
        r = svc.query(PT.one_cluster(4, 1), W_list=[600], lam_list=[2],
                      reps=2)
        assert svc.broker.default_backend == "torch"
    assert not r.grid.overflow.any()
    assert svc.broker.dispatch_log[0]["backend"] == "torch"
    plain = PService(root=tmp_path / "plain", device="cpu")
    assert plain.broker.default_backend == "oracle"


def test_a_sharded_sweep_is_one_traced_dispatch():
    """``run_rows(mesh=)`` runs the rank's shard through
    ``ExecutionBackend.run_scenario``: one dispatch counted, one
    ``backend.run_rows`` span and one tick of its counter, as an unsharded
    ``run_rows`` records."""
    from repro_torch import obs
    topo = PT.one_cluster(4, 1)
    rows = psw.grid_rows([200], [1, 2], 3)
    model = psw.resolve_model(topo, "divisible", W_list=[200], lam_list=[1, 2])
    be = pbk.get_backend("torch")
    counter = obs.REGISTRY.counter("backend.run_rows", {"backend": "torch"})
    tracer = obs.Tracer()
    obs.set_tracer(tracer)
    try:
        with cpu_mesh((1,), ("data",)) as mesh:
            runs, ticks = be.n_run_rows, counter.value
            psw.run_rows(model, rows, mesh=mesh, device="cpu")
            assert be.n_run_rows == runs + 1
            assert counter.value == ticks + 1
    finally:
        obs.set_tracer(None)
    spans = [e for e in tracer.events() if e["name"] == "backend.run_rows"]
    assert [e["ph"] for e in spans] == ["B", "E"]
    assert spans[0]["args"] == {"backend": "torch", "n_rows": len(rows)}


def test_a_mesh_on_another_device_than_the_service_is_refused(tmp_path):
    with cpu_mesh((1,), ("data",)) as mesh:
        with pytest.raises(ValueError, match="mesh of cpu"):
            PService(root=tmp_path, device="meta", mesh=mesh)


def test_a_cp_decode_step_reads_no_value_on_the_host():
    """The context-parallel step runs no host read (``.item()`` and the
    like) of any tensor: the rank's coordinate comes from the mesh, the
    position stays a tensor, so the step can be captured in a graph."""
    from repro_torch.check import dispatch_lint as dl
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("qwen3-1.7b").reduced(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 8)
    tok = torch.ones((2, 1), dtype=torch.int64)
    pos = torch.full((1,), 3, dtype=torch.int32)
    with cpu_mesh() as mesh:
        _, ops = dl.record_ops(model.decode_step, params, cache, tok, pos,
                               cp_axes=(("model",), ("data",)), mesh=mesh)
    assert ops and not [op.name for op in ops if op.name == dl.SYNC_OP]
    assert "c10d::allreduce_" in {op.name for op in ops}
