"""The port's placement rules and cell plans (``repro_torch.launch.mesh``,
``sharding``, ``steps.plan_cell``) against the JAX package's, without
devices, at the production meshes.

Both packages plan on an abstract mesh (``jax.sharding.AbstractMesh`` and
``repro_torch.launch.mesh.AbstractMesh``) of the same axes and sizes; every
spec is compared exactly (a JAX ``PartitionSpec`` as the tuple of its
entries). Abstract parameters are the JAX model's ``abstract_params`` and
the port's ``param_shapes``: the same tree, leaf for leaf.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.models import model as jmodel_mod
from repro.models import moe as jmoe
from repro_torch import tree as tr
from repro_torch.configs import SHAPES as PSHAPES
from repro_torch.configs import get_config as pget
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as pshd
from repro_torch.launch import steps as psteps
from repro_torch.models import build_model as pbuild
from repro_torch.models import moe as pmoe

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
PRODUCTION = ((16, 16), (2, 16, 16))
PLANNED = ("qwen3-1.7b", "mixtral-8x7b", "jamba-v0.1-52b", "whisper-large-v3",
           "internvl2-76b")


def meshes(shape):
    return (JAbstractMesh(shape, MESHES[shape]),
            pmesh.AbstractMesh(shape, MESHES[shape]))


def jspec(s) -> tuple:
    return tuple(s)


def dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else str(np.dtype(d))


@functools.lru_cache(maxsize=None)
def jax_abstract_params(arch: str):
    return jbuild(jget(arch)).abstract_params()


def jax_leaves(tree):
    return [(jshd._path_str(p), l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_leaves(tree):
    return [(pshd._path_str(p), l) for p, l in tr.flatten_with_path(tree)]


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(MESHES))
def test_dp_axes_and_axis_size_vs_jax(shape):
    jm, pm = meshes(shape)
    assert pmesh.dp_axes(pm) == jmesh.dp_axes(jm)
    for names in (("data",), ("model",), ("pod", "data"), ("data", "model"),
                  ("pod", "data", "model"), ("absent",), ()):
        assert pmesh.axis_size(pm, *names) == jmesh.axis_size(jm, *names)
    assert pmesh.mesh_shape(pm) == dict(jm.shape)


def test_production_mesh_shapes():
    for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = pmesh.production_mesh(multi_pod=multi_pod)
        assert (m.axis_sizes, m.axis_names) == (shape, MESHES[shape])
        assert m.size == int(np.prod(shape))
    with pytest.raises(RuntimeError, match="256"):
        pmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        pmesh.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("shape", list(MESHES))
def test_guard_vs_jax(shape):
    jm, pm = meshes(shape)
    specs = (("data", "model"), ("model", "data"), (None, "data"),
             (("pod", "data"), None), (("data", "model"), "model"))
    for spec in specs:
        for dims in ((5, 7), (16, 32), (256, 8), (2, 512), (32, 16)):
            want = jspec(jshd._guard(spec, dims, jm))
            assert pshd._guard(spec, dims, pm) == want, (spec, dims)


# ---------------------------------------------------------------------------
# parameter specs of every config, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_vs_jax(arch):
    jab = jax_abstract_params(arch)
    jraw = jax.tree_util.tree_flatten_with_path(jab)[0]
    pab = pbuild(pget(arch), device="meta").param_shapes()
    praw = tr.flatten_with_path(pab)
    assert [pshd._path_str(p) for p, _ in praw] == \
        [jshd._path_str(p) for p, _ in jraw]
    for (path, pleaf), (_, jleaf) in zip(praw, jraw):
        assert tuple(pleaf[0]) == tuple(jleaf.shape), path
        assert dtype_name(pleaf[1]) == dtype_name(jleaf.dtype), path
    for shape in MESHES:
        jm, pm = meshes(shape)
        jsh = jax.tree.leaves(jshd.shard_params(jab, jm),
                              is_leaf=lambda x: hasattr(x, "spec"))
        psh = tr.leaves(pshd.shard_params(pab, pm))
        for (ppath, pleaf), (jpath, jleaf), js, ps in zip(praw, jraw, jsh,
                                                           psh):
            want = jspec(jshd.param_spec(jpath, jleaf, jm))
            assert pshd.param_spec(ppath, pleaf, pm) == want
            assert ps.spec == want == jspec(js.spec), (shape, ppath)
            assert ps.shard_shape(pleaf[0]) == tuple(
                js.shard_shape(jleaf.shape)), (shape, ppath)


def test_opt_state_specs_mirror_the_params():
    _jm, pm = meshes((16, 16))
    ab = pbuild(pget("qwen3-1.7b"), device="meta").param_shapes()
    psh = pshd.shard_params(ab, pm)
    from repro_torch.optim import adamw
    osh = pshd.shard_opt_state(adamw.state_shapes(ab), psh, pm)
    assert osh.step.spec == ()
    assert [s.spec for s in tr.leaves(osh.m)] == \
        [s.spec for s in tr.leaves(psh)] == [s.spec for s in tr.leaves(osh.v)]


# ---------------------------------------------------------------------------
# batch and cache specs of the four shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_vs_jax(arch):
    jcfg, pcfg = jget(arch), pget(arch)
    jm_model = jbuild(jcfg)
    pm_model = pbuild(pcfg, device="meta")
    for shape_name in JSHAPES:
        for mshape in ((2, 2),) + PRODUCTION:
            jm, pm = meshes(mshape)
            jb = jshd.batch_specs(jcfg, JSHAPES[shape_name], jm)
            pb = pshd.batch_specs(pcfg, PSHAPES[shape_name], pm)
            assert list(pb) == list(jb)
            for k in jb:
                assert pb[k].shape == tuple(jb[k].shape), (shape_name, k)
                assert dtype_name(pb[k].dtype) == dtype_name(jb[k].dtype)
                assert pb[k].sharding.spec == jspec(jb[k].sharding.spec)
            if JSHAPES[shape_name].kind != "decode":
                continue
            jc, jaxes = jshd.cache_specs(jm_model, jcfg, JSHAPES[shape_name],
                                         jm)
            pc, paxes = pshd.cache_specs(pm_model, pcfg, PSHAPES[shape_name],
                                         pm)
            assert paxes == (tuple(jaxes[0]), tuple(jaxes[1]))
            jl, pl = jax_leaves(jc), port_leaves(pc)
            assert [p for p, _ in pl] == [p for p, _ in jl]
            for (path, pl_), (_, jl_) in zip(pl, jl):
                assert pl_.shape == tuple(jl_.shape), path
                assert dtype_name(pl_.dtype) == dtype_name(jl_.dtype), path
                assert pl_.sharding.spec == jspec(jl_.sharding.spec), \
                    (mshape, shape_name, path)


# ---------------------------------------------------------------------------
# cell plans
# ---------------------------------------------------------------------------

#: the JAX models' abstract parameters by config
_ABSTRACT = {}


@pytest.fixture
def jax_abstract_params_cached(monkeypatch):
    """The JAX model's ``abstract_params`` answered once a config (a pure
    function of it): the plans below then trace each model once."""
    orig = jmodel_mod.Model.abstract_params

    def cached(self):
        if self.cfg not in _ABSTRACT:
            _ABSTRACT[self.cfg] = orig(self)
        return _ABSTRACT[self.cfg]
    monkeypatch.setattr(jmodel_mod.Model, "abstract_params", cached)


def closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


def jax_act_specs(act_spec, shapes, monkeypatch) -> list:
    """The specs the JAX constrainer pins for activations of ``shapes``
    (with_sharding_constraint answers with the spec it is given)."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda h, spec: jspec(spec))
    out = []
    for shape in shapes:
        got = act_spec(jax.ShapeDtypeStruct(shape, jnp.bfloat16))
        out.append(got if isinstance(got, tuple) else None)
    return out


ACT_SHAPES = ((256, 4096, 2048), (32, 32768, 2048), (128, 1, 2048),
              (1, 1, 8192), (256, 4096), (7, 9, 3), (4096,))


@pytest.mark.parametrize("mshape", PRODUCTION)
@pytest.mark.parametrize("arch", PLANNED)
def test_plan_cell_vs_jax(arch, mshape, jax_abstract_params_cached,
                          monkeypatch):
    jm, pm = meshes(mshape)
    for shape_name in JSHAPES:
        jp = jsteps.plan_cell(arch, shape_name, jm)
        jhints = dict(jmoe._SHARD_HINTS)
        pp = psteps.plan_cell(arch, shape_name, pm)
        assert dict(pmoe._SHARD_HINTS) == jhints, shape_name
        assert pp.cfg.moe_groups == jp.cfg.moe_groups, shape_name
        assert pp.context_parallel == jp.context_parallel
        assert pp.donate == jp.donate
        assert len(pp.args) == len(jp.args)
        for pa, ja in zip(pp.args, jp.args):
            pl, jl = port_leaves(pa), jax_leaves(ja)
            assert [p for p, _ in pl] == [p for p, _ in jl], shape_name
            for (path, p_), (_, j_) in zip(pl, jl):
                assert p_.shape == tuple(j_.shape), (shape_name, path)
                assert dtype_name(p_.dtype) == dtype_name(j_.dtype), path
                assert p_.sharding.spec == jspec(j_.sharding.spec), \
                    (shape_name, path)
        jfree, pfree = closure(jp.fn), closure(pp.fn)
        if "cp_axes" in jfree:
            want = jfree["cp_axes"]
            assert pfree["cp_axes"] == (None if want is None else tuple(
                tuple(a) for a in want))
        want = jax_act_specs(jfree["act_spec"], ACT_SHAPES, monkeypatch)
        assert [pp.act_spec.spec(s) for s in ACT_SHAPES] == want, shape_name
        monkeypatch.undo()


def test_force_sp_is_read_as_jax_reads_it(monkeypatch):
    _jm, pm = meshes((16, 16))
    for value, sp in ((None, False), ("1", True), ("0", False)):
        if value is None:
            monkeypatch.delenv("REPRO_FORCE_SP", raising=False)
        else:
            monkeypatch.setenv("REPRO_FORCE_SP", value)
        plan = psteps.plan_cell("jamba-v0.1-52b", "train_4k", pm)
        assert plan.act_spec.sequence_parallel is sp
    pmoe.set_shard_hints(None, None)


def test_act_constrainer_leaves_a_rank_local_tensor_as_it_is():
    _jm, pm = meshes((2, 2))
    c = psteps.make_act_constrainer(pm, ("data",))
    h = torch.ones(4, 8, 16)
    assert c(h) is h and c.spec(h.shape) == ("data", "model", None)
    pmoe.set_shard_hints(tokens=(("data",),), experts=(("data",),))
    try:
        assert pmoe._hint(h, "tokens") is h
    finally:
        pmoe.set_shard_hints(None, None)
