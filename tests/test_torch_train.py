"""The port's training path against the JAX package's, on the CPU:
checkpoints (``checkpoint/ckpt.py``) read across the two packages in both
directions, the fault-tolerant loop (``runtime/fault.py``), the train step
(``launch/steps.py::build_train_step``) and the command line
(``launch/train.py``), at reduced configs in float32 with the JAX package's
weights carried across by ``models.interop.params_from_jax``. Then the
port's twins of ``tests/test_substrates.py``'s checkpoint and loop tests.

Tolerances, each with its reason:

* checkpoint leaves, the names of their files and the files' bytes:
  equal (the same arrays written by ``np.save``);
* ``loss``, ``xent``, ``moe_aux`` and ``grad_norm`` of a train step: rtol
  1e-5 — float32 sums in other orders through two layers and back
  (``tests/test_torch_lm_model.py`` holds ``loss_fn``'s gradients to
  1e-4 of each leaf's largest);
* parameters after k AdamW steps: atol 2 · k · lr plus rtol 1e-5. At the
  first step m̂ / √v̂ is g / |g| = ±1 for every element whatever its size,
  so an element whose gradient is near 0 in both frameworks but of the
  other sign moves by lr the other way (the AdamW sign hazard); elsewhere
  the float32 rounding of the direction. Beyond 1e-4 · lr of each other
  may lie at most 1 % of a leaf's elements (those near-zero gradients);
* ``m`` and ``v``: atol 1e-4 of each leaf's largest (the gradients');
* the losses of a 12-step run with injected failures: rtol 2e-5 a step —
  the parameters drift apart by the sign hazard above, which moves a loss
  of 6.2 by less than 1e-5 over 12 steps at lr 3e-3; with EF-int8
  compression rtol 1e-4: a gradient element on a quantization boundary
  rounds to the neighbouring step in one framework.
"""
import dataclasses
import hashlib
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.runtime import fault as jfault
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline as ppipe
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model as pbuild
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.tree import leaves as tr_leaves
from repro_torch.runtime.fault import (FailureInjector, StragglerMonitor,
                                       TrainLoopConfig, run_training)

from test_torch_optim import tree_np, tree_torch

torch.set_num_threads(1)


def _f32(arch: str):
    return (dataclasses.replace(jget(arch).reduced(), param_dtype="float32"),
            dataclasses.replace(pget(arch).reduced(), param_dtype="float32"))


def _flat(tree, path=""):
    """(path, leaf) of a tree of dicts and NamedTuples, in pytree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flat(getattr(tree, f), f"{path}/.{f}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _state_np(rng):
    """A training state of both packages' shape: bf16 and float32
    parameters, AdamW's state, the error-feedback residuals."""
    params = {"w": rng.normal(size=(3, 4)).astype(ml_dtypes.bfloat16),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                    "a": rng.normal(size=(2,)).astype(ml_dtypes.bfloat16)}}

    def like(scale):
        return {"w": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
                "b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32),
                      "a": (rng.normal(size=(2,)) * scale).astype(
                          np.float32)}}
    return params, np.int32(3), like(0.1), like(0.01), like(1e-3)


def _jax_state(params, step, m, v, e):
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return {"params": j(params),
            "opt": jadamw.AdamWState(step=jnp.asarray(step), m=j(m), v=j(v)),
            "ef": jcomp.EFState(error=j(e))}


def _port_state(params, step, m, v, e):
    return {"params": tree_torch(params),
            "opt": adamw.AdamWState(step=torch.tensor(step), m=tree_torch(m),
                                    v=tree_torch(v)),
            "ef": comp.EFState(error=tree_torch(e))}


def _npy_digests(d):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.glob("*.npy"))}


def test_checkpoints_are_the_same_files_in_both_packages(tmp_path):
    parts = _state_np(np.random.default_rng(0))
    jckpt.save_checkpoint(tmp_path / "jax", 7, _jax_state(*parts),
                          extra={"losses_tail": [1.5]})
    ckpt.save_checkpoint(tmp_path / "port", 7, _port_state(*parts),
                         extra={"losses_tail": [1.5]})
    jd, pd = tmp_path / "jax" / "step_7", tmp_path / "port" / "step_7"
    jm = json.loads((jd / "manifest.json").read_text())
    pm = json.loads((pd / "manifest.json").read_text())
    for key in ("step", "leaves", "extra"):
        assert jm[key] == pm[key], key
    assert [l["name"] for l in pm["leaves"]][:4] == [
        "ef~.error~b~a", "ef~.error~b~c", "ef~.error~w", "opt~.step"]
    assert pm["leaves"][-1] == {"name": "params~w", "shape": [3, 4],
                                "dtype": "bfloat16"}
    assert _npy_digests(jd) == _npy_digests(pd)
    assert len(_npy_digests(pd)) == 13


def test_the_port_reads_a_jax_checkpoint(tmp_path):
    parts = _state_np(np.random.default_rng(1))
    jckpt.save_checkpoint(tmp_path, 4, _jax_state(*parts), extra={"x": 2})
    template = _port_state(*_state_np(np.random.default_rng(2)))
    step, back, extra = ckpt.load_checkpoint(tmp_path, template)
    assert step == 4 and extra == {"x": 2}
    want = dict(_flat(_port_state(*parts)))
    got = dict(_flat(back))
    assert list(got) == list(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path


def test_the_jax_package_reads_a_port_checkpoint(tmp_path):
    parts = _state_np(np.random.default_rng(3))
    ckpt.save_checkpoint(tmp_path, 9, _port_state(*parts))
    template = _jax_state(*_state_np(np.random.default_rng(4)))
    step, back, _ = jckpt.load_checkpoint(tmp_path, template)
    assert step == 9
    want = dict(_flat(_jax_state(*parts)))
    got = dict(_flat(back))
    assert list(got) == list(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(want[path]),
                                      err_msg=path)


def test_a_template_of_shapes_restores_onto_the_cpu(tmp_path):
    parts = _state_np(np.random.default_rng(5))
    ckpt.save_checkpoint(tmp_path, 0, {"params": tree_torch(parts[0])})
    shapes = {"params": {"w": ((3, 4), torch.bfloat16),
                         "b": {"c": ((5,), torch.float32),
                               "a": ((2,), torch.bfloat16)}}}
    _, back, _ = ckpt.load_checkpoint(tmp_path, shapes, device="cpu")
    assert back["params"]["w"].device.type == "cpu"
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], tree_torch(parts[0])["w"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(tmp_path, {"params": {
            "w": ((4, 3), torch.bfloat16), "b": shapes["params"]["b"]}},
            device="cpu")
    if not torch.cuda.is_available():
        # no device named: the card, as at every entry point of the port
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_checkpoint(tmp_path, shapes)


# ---------------------------------------------------------------------------
# twins of tests/test_substrates.py's checkpoint tests
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save_checkpoint(tmp_path, 3, tree)
    step, back, _ = ckpt.load_checkpoint(tmp_path, tree)
    assert step == 3
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.bfloat16
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 7


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, {"x": torch.full((2,), float(s))},
                             keep_last=2)
    assert ckpt.list_steps(tmp_path) == [4, 5]
    step, back, _ = ckpt.load_checkpoint(tmp_path, tree)
    assert step == 5 and float(back["x"][0]) == 5.0
    step, back, _ = ckpt.load_checkpoint(tmp_path, tree, step=4)
    assert step == 4 and float(back["x"][0]) == 4.0


def test_checkpoint_async(tmp_path):
    t = ckpt.save_checkpoint(tmp_path, 1, {"x": torch.ones(3)},
                             async_write=True)
    t.join()
    assert ckpt.list_steps(tmp_path) == [1]


def test_an_uncommitted_checkpoint_is_never_loaded(tmp_path):
    """A crash mid-write leaves a ``.tmp_step_N`` directory, or a
    ``step_N`` without its manifest: neither counts."""
    ckpt.save_checkpoint(tmp_path, 2, {"x": torch.full((3,), 2.0)})
    torn = tmp_path / ".tmp_step_5"
    torn.mkdir()
    np.save(torn / "x.npy", np.full(3, 5.0, np.float32))
    (tmp_path / "step_6").mkdir()
    np.save(tmp_path / "step_6" / "x.npy", np.full(3, 6.0, np.float32))
    assert ckpt.list_steps(tmp_path) == [2]
    step, back, _ = ckpt.load_checkpoint(tmp_path, {"x": torch.zeros(3)})
    assert step == 2 and float(back["x"][0]) == 2.0
    # a new save of the torn step replaces its leftovers
    ckpt.save_checkpoint(tmp_path, 5, {"x": torch.full((3,), 5.5)})
    assert ckpt.list_steps(tmp_path) == [2, 5]
    assert float(ckpt.load_checkpoint(tmp_path,
                                      {"x": torch.zeros(3)})[1]["x"][0]) == 5.5


def test_checkpoint_on_a_mesh_waits_for_queue_a10(tmp_path):
    """``load_checkpoint(shardings=)`` restores each leaf as a DTensor on
    the mesh (one rank here: its shard is the whole leaf)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import NamedSharding
    from test_torch_common import cpu_mesh
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    ckpt.save_checkpoint(tmp_path, 0, {"w": w})
    with cpu_mesh() as mesh:
        _, tree, _ = ckpt.load_checkpoint(
            tmp_path, {"w": ((4, 4), torch.bfloat16)},
            shardings={"w": NamedSharding(mesh, ("data", "model"))})
        assert isinstance(tree["w"], DTensor)
        assert tree["w"].dtype == torch.bfloat16
        assert torch.equal(tree["w"].full_tensor().float(), w)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "none", {"w": torch.zeros(4, 4)})


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def test_training_survives_failures(tmp_path):
    """Injected crashes at steps 3 and 7; the loop finishes all 10 steps
    with a final state equal to an uninterrupted run's."""
    def step(state, batch):
        w = state["w"] + batch["x"].sum()
        return {"w": w}, {"loss": w}

    def batch_fn(s):
        return {"x": torch.full((2,), float(s))}

    cfg_a = TrainLoopConfig(total_steps=10, ckpt_every=2,
                            ckpt_dir=str(tmp_path / "a"))
    out_a = run_training(cfg_a, step, {"w": torch.tensor(0.0)}, batch_fn,
                         injector=FailureInjector(fail_at=(3, 7)))
    cfg_b = TrainLoopConfig(total_steps=10, ckpt_every=2,
                            ckpt_dir=str(tmp_path / "b"))
    out_b = run_training(cfg_b, step, {"w": torch.tensor(0.0)}, batch_fn)
    assert out_a["restarts"] == 2 and out_b["restarts"] == 0
    _, sa, _ = ckpt.load_checkpoint(tmp_path / "a", {"w": torch.tensor(0.0)})
    _, sb, _ = ckpt.load_checkpoint(tmp_path / "b", {"w": torch.tensor(0.0)})
    assert float(sa["w"]) == float(sb["w"]) == 90.0


def test_the_loop_vs_jax_on_a_counting_step(tmp_path):
    """The same failures, checkpoints and resumes as the JAX loop: the same
    losses a step (re-run steps included), restarts and final step."""
    def pstep(state, batch):
        w = state["w"] * 2 + batch["x"]
        return {"w": w}, {"loss": w}

    def jstep(state, batch):
        w = state["w"] * 2 + batch["x"]
        return {"w": w}, {"loss": w}

    kw = dict(total_steps=11, ckpt_every=3, keep_last=2)
    po = run_training(TrainLoopConfig(ckpt_dir=str(tmp_path / "p"), **kw),
                      pstep, {"w": torch.tensor(1.0)},
                      lambda s: {"x": torch.tensor(float(s))},
                      injector=FailureInjector(fail_at=(1, 5, 9)))
    jo = jfault.run_training(
        jfault.TrainLoopConfig(ckpt_dir=str(tmp_path / "j"), **kw), jstep,
        {"w": jnp.float32(1.0)}, lambda s: {"x": jnp.float32(s)},
        injector=jfault.FailureInjector(fail_at=(1, 5, 9)))
    assert po == jo
    assert ckpt.list_steps(tmp_path / "p") == jckpt.list_steps(tmp_path / "j")


def test_a_failure_before_the_first_checkpoint_restarts_from_init(tmp_path):
    """The restart trap: with no checkpoint yet the loop restarts from
    ``init_state``, which the train step must not have written into. A real
    train step (reduced qwen3, AdamW) failing at step 2 ends bit-equal to an
    uninterrupted run, and leaves its initial state as it was."""
    cfg = dataclasses.replace(pget("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
    shape = ShapeSpec("t", 16, 2, "train")
    finals = []
    for name, fails in (("a", (2,)), ("b", ())):
        _model, state, step_fn = ptrain.build_state_and_step(
            cfg, opt, compress=True, device="cpu")
        before = [t.clone() for _, t in _flat(state)]
        out = run_training(
            TrainLoopConfig(total_steps=5, ckpt_every=10,
                            ckpt_dir=str(tmp_path / name)),
            step_fn, state,
            lambda s: ppipe.batch_at(cfg, shape, s, device="cpu"),
            injector=FailureInjector(fail_at=fails))
        assert out["restarts"] == len(fails)
        for a, (path, b) in zip(before, _flat(state)):
            assert torch.equal(a, b), path
        finals.append(ckpt.load_checkpoint(tmp_path / name, state)[1])
    for (path, a), (_, b) in zip(_flat(finals[0]), _flat(finals[1])):
        assert torch.equal(a, b), path


def test_straggler_monitor():
    mon = StragglerMonitor(n_ranks=4, alpha=1.0, ratio=1.5)
    assert mon.update(np.array([1.0, 1.0, 1.0, 3.0])) == [3]
    p, j = StragglerMonitor(n_ranks=3), jfault.StragglerMonitor(n_ranks=3)
    rng = np.random.default_rng(0)
    for _ in range(6):
        t = rng.uniform(1, 3, size=3)
        assert p.update(t) == j.update(t)
        np.testing.assert_array_equal(p.ema, j.ema)


def _mesh_state(model, params, mesh):
    """(this rank's shards of ``{"params", "opt"}``, their shardings)."""
    from repro_torch.launch import sharding as shd
    sh = shd.shard_params(model.param_shapes(), mesh)
    lp = shd.local_params(params, sh, mesh)
    return ({"params": lp, "opt": adamw.init(lp)},
            {"params": sh, "opt": shd.shard_opt_state(
                adamw.state_shapes(model.param_shapes()), sh, mesh)})


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_the_loop_on_a_mesh_of_one_is_the_loop_without(tmp_path,
                                                       async_ckpt):
    """``run_training(state_shardings=)`` with the sharded step on a (1, 1)
    mesh, failures at steps 2 (a restart from the initial state) and 5 (a
    resume from step 3's checkpoint, restored through
    ``load_checkpoint(shardings=)``): the same losses, restarts and final
    step as the loop without a mesh, bit for bit, and its checkpoints the
    same files, byte for byte (the sharded save gathers each leaf whole
    and writes it from the mesh's first rank)."""
    from test_torch_common import cpu_mesh
    cfg = dataclasses.replace(pget("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    model = pbuild(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    shape = ShapeSpec("cli", 16, 4, "train")
    loop = TrainLoopConfig(total_steps=8, ckpt_every=2,
                           async_ckpt=async_ckpt)

    def batch_fn(s):
        return ppipe.batch_at(cfg, shape, s, device="cpu")

    def step_of(step):
        def step_fn(st, b):
            p, o, met = step(st["params"], st["opt"], b)
            return {"params": p, "opt": o}, met
        return step_fn

    plain = run_training(
        dataclasses.replace(loop, ckpt_dir=str(tmp_path / "plain")),
        step_of(build_train_step(model, opt, device="cpu")),
        {"params": params, "opt": adamw.init(params)}, batch_fn,
        injector=FailureInjector(fail_at=(2, 5)))
    with cpu_mesh() as mesh:
        state, state_sh = _mesh_state(model, params, mesh)
        sharded = run_training(
            dataclasses.replace(loop, ckpt_dir=str(tmp_path / "mesh")),
            step_of(build_train_step(model, opt, mesh=mesh, device="cpu")),
            state, batch_fn, injector=FailureInjector(fail_at=(2, 5)),
            state_shardings=state_sh)
    assert sharded == plain and plain["restarts"] == 2
    assert ckpt.list_steps(tmp_path / "mesh") == ckpt.list_steps(
        tmp_path / "plain") == [3, 5, 7]
    for f in sorted((tmp_path / "plain" / "step_7").glob("*.npy")):
        assert f.read_bytes() == (tmp_path / "mesh" / "step_7" /
                                  f.name).read_bytes(), f.name


def test_the_loop_on_a_mesh_resumes_an_unsharded_checkpoint(tmp_path):
    """A checkpoint of the loop without a mesh (the JAX package's files)
    resumed by the loop on a (1, 1) mesh: each rank reads its slice, the
    state comes back as plain tensors (its DTensors' local tensors), and the
    run ends as the uninterrupted loop without a mesh."""
    from test_torch_common import cpu_mesh
    cfg = dataclasses.replace(pget("qwen3-1.7b").reduced(),
                              param_dtype="float32")
    model = pbuild(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    shape = ShapeSpec("cli", 16, 4, "train")
    step = build_train_step(model, opt, device="cpu")
    got = {}

    def step_fn(st, b):
        p, o, met = step(st["params"], st["opt"], b)
        got["state"] = {"params": p, "opt": o}
        return got["state"], met

    def batch_fn(s):
        return ppipe.batch_at(cfg, shape, s, device="cpu")

    init = {"params": params, "opt": adamw.init(params)}
    whole = run_training(TrainLoopConfig(total_steps=4, ckpt_every=10,
                                         ckpt_dir=str(tmp_path / "a")),
                         step_fn, init, batch_fn)
    want = got.pop("state")
    run_training(TrainLoopConfig(total_steps=2, ckpt_every=10,
                                 ckpt_dir=str(tmp_path / "b")),
                 step_fn, init, batch_fn)
    with cpu_mesh() as mesh:
        state, state_sh = _mesh_state(model, params, mesh)
        mesh_step = build_train_step(model, opt, mesh=mesh, device="cpu")

        def sharded_fn(st, b):
            p, o, met = mesh_step(st["params"], st["opt"], b)
            assert all(type(t) is torch.Tensor for t in tr_leaves(p))
            got["state"] = {"params": p, "opt": o}
            return got["state"], met
        rest = run_training(TrainLoopConfig(total_steps=4, ckpt_every=10,
                                            ckpt_dir=str(tmp_path / "b")),
                            sharded_fn, state, batch_fn,
                            state_shardings=state_sh)
    assert rest["losses"] == whole["losses"][2:]
    for (path, a), (_p, b) in zip(_flat(got["state"]), _flat(want)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the train step and the command line's state against the JAX package
# ---------------------------------------------------------------------------

def _carried(arch: str, seed: int = 0):
    """(JAX model and params, the port's model and the same params)."""
    jc, pc = _f32(arch)
    jm = jbuild(jc)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    pm = pbuild(pc, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pm)
    return jc, pc, jm, jp, pm, pp


def _hold_params(got, want, lr: float, k: int, what: str):
    for (path, a), (_p, b) in zip(_flat(got), _flat(want)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * k * lr,
                                   err_msg=f"{what}{path}")
        off = np.abs(a - b) > 1e-5 * np.abs(b) + 1e-4 * lr
        assert off.mean() <= 0.01, (f"{what}{path}", off.mean())


@pytest.mark.parametrize("arch,microbatches,steps",
                         [("qwen3-1.7b", 1, 2), ("qwen3-1.7b", 2, 2),
                          ("mixtral-8x7b", 1, 1)])
def test_build_train_step_vs_jax(arch, microbatches, steps):
    jc, pc, jm, jp, pm, pp = _carried(arch)
    cfg_kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_build_train_step(jm, jadamw.AdamWConfig(**cfg_kw),
                                       microbatches=microbatches))
    pstep = build_train_step(pm, adamw.AdamWConfig(**cfg_kw),
                             microbatches=microbatches, device="cpu")
    js = jadamw.init(jp)
    ps = adamw.AdamWState(step=torch.tensor(np.asarray(js.step)),
                          m=tree_torch(tree_np(js.m)),
                          v=tree_torch(tree_np(js.v)))
    jshape = JShapeSpec("t", 32, 4, "train")
    pshape = ShapeSpec("t", 32, 4, "train")
    for k in range(1, steps + 1):
        jb = jpipe.batch_at(jc, jshape, k)
        pb = ppipe.batch_at(pc, pshape, k, device="cpu")
        jp, js, jmet = jstep(jp, js, jb)
        pp, ps, pmet = pstep(pp, ps, pb)
        assert set(pmet) == set(jmet) == {"loss", "xent", "moe_aux",
                                          "grad_norm", "lr"}
        for key in ("loss", "xent", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[key]), float(jmet[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        if arch == "mixtral-8x7b":
            assert float(pmet["moe_aux"]) > 0
        assert int(ps.step) == k
        _hold_params(pp, jp, cfg_kw["lr"], k, f"step {k} params")
        for tree_p, tree_j in ((ps.m, js.m), (ps.v, js.v)):
            for (path, a), (_p, b) in zip(_flat(tree_p), _flat(tree_j)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-4 * np.abs(b).max(),
                                           err_msg=path)


def test_microbatches_equal_one_batch_of_the_mean_gradient():
    """Gradient accumulation over 2 microbatches against one step on the
    whole batch, on the port alone: the same mean loss and gradient norm."""
    _jc, pc, _jm, _jp, pm, pp = _carried("qwen3-1.7b", seed=1)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    batch = ppipe.batch_at(pc, ShapeSpec("t", 32, 4, "train"), 0,
                           device="cpu")
    st = adamw.init(pp)
    _, _, one = build_train_step(pm, opt, device="cpu")(pp, st, batch)
    _, _, two = build_train_step(pm, opt, microbatches=2,
                                 device="cpu")(pp, st, batch)
    np.testing.assert_allclose(float(two["loss"]), float(one["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(two["grad_norm"]),
                               float(one["grad_norm"]), rtol=1e-4)
    assert float(two["moe_aux"]) == 0.0
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(pm, opt, microbatches=3, device="cpu")(pp, st,
                                                                batch)


@pytest.mark.parametrize("compress", [False, True])
def test_run_training_vs_jax_with_failures(tmp_path, compress):
    """``build_state_and_step`` + ``run_training`` for 12 steps, failures at
    steps 2 (before the first checkpoint: a restart from the initial state)
    and 9 (a resume from step 7's), on the same carried weights and the
    same data: the losses of every step run, the restarts, the final step."""
    jc, pc = _f32("qwen3-1.7b")
    opt_kw = dict(lr=3e-3, warmup_steps=2, total_steps=12)
    jmodel, jstate, jstep = jtrain.build_state_and_step(
        jc, jadamw.AdamWConfig(**opt_kw), compress, seed=0)
    pmodel, pstate, pstep = ptrain.build_state_and_step(
        pc, adamw.AdamWConfig(**opt_kw), compress, device="cpu")
    pstate["params"] = params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), pmodel)
    jshape, pshape = JShapeSpec("cli", 32, 4, "train"), ShapeSpec(
        "cli", 32, 4, "train")
    dseed = 99
    kw = dict(total_steps=12, ckpt_every=4)
    jo = jfault.run_training(
        jfault.TrainLoopConfig(ckpt_dir=str(tmp_path / "j"), **kw), jstep,
        jstate, lambda s: jpipe.batch_at(jc, jshape, s,
                                         jpipe.DataConfig(seed=dseed)),
        injector=jfault.FailureInjector(fail_at=(2, 9)))
    po = run_training(
        TrainLoopConfig(ckpt_dir=str(tmp_path / "p"), **kw), pstep, pstate,
        lambda s: ppipe.batch_at(pc, pshape, s, ppipe.DataConfig(seed=dseed),
                                 device="cpu"),
        injector=FailureInjector(fail_at=(2, 9)))
    assert po["restarts"] == jo["restarts"] == 2
    assert po["final_step"] == jo["final_step"] == 12
    assert len(po["losses"]) == len(jo["losses"]) == 2 + 9 + 4
    np.testing.assert_allclose(po["losses"], jo["losses"],
                               rtol=1e-4 if compress else 2e-5)
    assert np.mean(po["losses"][-5:]) < np.mean(po["losses"][:5])


def test_train_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this guard describes a host without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrain.main(["--reduced", "--steps", "2"])
    cfg = pget("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrain.build_state_and_step(cfg, adamw.AdamWConfig(), False)
    m = pbuild(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(m, adamw.AdamWConfig())


def test_smoke_ab_reads_the_train_phase(tmp_path):
    """``benchmarks/smoke_ab.py`` knows phase ``lm_train`` and reads its
    step and checkpoint lines."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        from benchmarks import smoke_ab
    finally:
        sys.path.remove(str(root))
    assert 'ph == "lm_train"' in smoke_ab.CHILD
    lines = [json.dumps({"phase": "lm_train", "path": "fault.run_training",
                         "steady_step_ms": 500.0, "tokens_per_second": 8.0,
                         "peak_gib": 50.0, "losses": [1.0]}),
             json.dumps({"phase": "lm_train", "path": "checkpoint",
                         "save_seconds": 20.0, "load_seconds": 12.0})]
    assert smoke_ab.summarize(lines) == {
        "phase_seconds": {}, "train_steady_step_ms": 500.0,
        "train_tokens_per_second": 8.0, "train_peak_gib": 50.0,
        "train_save_seconds": 20.0, "train_load_seconds": 12.0}
