"""The port's data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data.pipeline``), on the CPU.

The port reproduces JAX's threefry-2x32 stream (with
``jax_threefry_partitionable``, JAX's default) in numpy, so keys, random
bits, tokens and labels are equal, not close. The bf16 stub embeddings
(``vis_embeds``, ``frames``) come from ``normal``, whose float32 erfinv is
XLA's polynomial over XLA's own log1p: the port's log1p can differ from it
in the last bit, so an embedding may differ by one bf16 step (2^-8 of its
magnitude); the share of unequal elements is reported and must stay under
1 %.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro_torch.configs import SHAPES as PSHAPES
from repro_torch.configs import get_config as pget
from repro_torch.data import _threefry as tf
from repro_torch.data import pipeline as ppipe

torch.set_num_threads(1)

SEEDS = (0, 1234, 99, 2**31 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_vs_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for data in (0, 1, 17, 2**31 + 5):
        np.testing.assert_array_equal(
            tf.fold_in(key, data), np.asarray(jax.random.fold_in(jkey, data)))
    jk, k = jax.random.fold_in(jkey, 3), tf.fold_in(key, 3)
    for n in (2, 3, 7):
        np.testing.assert_array_equal(tf.split(k, n),
                                      np.asarray(jax.random.split(jk, n)))
    for shape in ((5,), (3, 5), (2, 3, 4)):
        np.testing.assert_array_equal(tf.random_bits(k, shape),
                                      np.asarray(jax.random.bits(jk, shape)))
    for lo, hi in ((1, 512), (1, 151936), (0, 7), (-3, 2**31 - 1)):
        np.testing.assert_array_equal(
            tf.randint(k, (4, 33), lo, hi),
            np.asarray(jax.random.randint(jk, (4, 33), lo, hi,
                                          dtype=jnp.int32)))
    np.testing.assert_array_equal(
        tf.uniform(k, (9, 11), -0.5, 2.0),
        np.asarray(jax.random.uniform(jk, (9, 11), jnp.float32, -0.5, 2.0)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_vs_jax_within_a_few_float32_ulps(seed):
    """Equal but where the two log1p part in their last bit: w = -log1p(-u²)
    one ulp off moves erfinv by up to a few ulps where |u| nears 1."""
    k, jk = tf.prng_key(seed), jax.random.PRNGKey(seed)
    got, want = tf.normal(k, (128, 512)), np.asarray(
        jax.random.normal(jk, (128, 512), jnp.float32))
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    share = float((got != want).mean())
    print(f"normal: {share:.4%} of float32 draws off by an ulp or more")
    assert share < 0.02


def _shape(seq, batch):
    return (dataclasses.replace(JSHAPES["train_4k"], seq_len=seq,
                                global_batch=batch),
            dataclasses.replace(PSHAPES["train_4k"], seq_len=seq,
                                global_batch=batch))


def _embeds_close(got: torch.Tensor, want, what: str) -> float:
    """bf16 within one bf16 step; returns the share of unequal elements."""
    assert got.dtype == torch.bfloat16, what
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=2 ** -8, atol=0, err_msg=what)
    share = float((g != w).mean())
    print(f"{what}: {share:.6%} of bf16 elements one step off")
    assert share < 0.01, what
    return share


CASES = [("qwen3-1.7b", 64, 4, 0, 1234), ("qwen3-1.7b", 300, 2, 17, 99),
         ("qwen3-1.7b", 128, 8, 57, 1),
         ("internvl2-76b", 40, 2, 3, 1234), ("internvl2-76b", 64, 3, 0, 7),
         ("whisper-large-v3", 32, 2, 5, 1234),
         ("whisper-large-v3", 48, 1, 200, 99)]


@pytest.mark.parametrize("arch,seq,batch,step,seed", CASES)
def test_batch_at_vs_jax(arch, seq, batch, step, seed):
    """Reduced configs: InternVL's vision prefix shortens the text and adds
    ``vis_embeds``; Whisper adds ``frames``."""
    jcfg, pcfg = jget(arch).reduced(), pget(arch).reduced()
    jshape, pshape = _shape(seq, batch)
    want = jpipe.batch_at(jcfg, jshape, step, jpipe.DataConfig(seed=seed))
    got = ppipe.batch_at(pcfg, pshape, step, ppipe.DataConfig(seed=seed),
                         device="cpu")
    assert set(got) == set(want)
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    S_text = seq - (pcfg.vision_prefix_len or 0)
    assert got["tokens"].shape == (batch, S_text)
    for name in ("vis_embeds", "frames"):
        if name in want:
            _embeds_close(got[name], want[name], f"{arch} {name}")


def test_batch_at_full_width_embeddings_vs_jax():
    """Whisper's frames at full width (1500 x 1280): many more draws."""
    jcfg, pcfg = jget("whisper-large-v3"), pget("whisper-large-v3")
    jshape, pshape = _shape(16, 1)
    want = jpipe.batch_at(jcfg, jshape, 4)
    got = ppipe.batch_at(pcfg, pshape, 4, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    _embeds_close(got["frames"], want["frames"], "whisper frames")


def test_pipeline_deterministic_skip_ahead():
    """The twin of tests/test_substrates.py's."""
    cfg = pget("qwen3-1.7b").reduced()
    shape = dataclasses.replace(PSHAPES["train_4k"], seq_len=64,
                                global_batch=4)
    a = ppipe.batch_at(cfg, shape, 17, device="cpu")
    b = ppipe.batch_at(cfg, shape, 17, device="cpu")
    c = ppipe.batch_at(cfg, shape, 18, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    # labels are next-token shifted
    p = ppipe.Pipeline(cfg, shape, start_step=17, device="cpu")
    d = next(p)
    assert torch.equal(d["tokens"], a["tokens"]) and p.step == 18
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    p.skip_to(3)
    assert torch.equal(next(p)["tokens"],
                       ppipe.batch_at(cfg, shape, 3, device="cpu")["tokens"])


def test_documents_end_in_eos():
    cfg = pget("qwen3-1.7b").reduced()
    shape = dataclasses.replace(PSHAPES["train_4k"], seq_len=600,
                                global_batch=2)
    dcfg = ppipe.DataConfig(eos_id=0, doc_len=257)
    b = ppipe.batch_at(cfg, shape, 0, dcfg, device="cpu")
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    ends = [i for i in range(seq.shape[1]) if i % 257 == 256]
    assert (seq[:, ends] == 0).all()
    others = [i for i in range(seq.shape[1]) if i % 257 != 256]
    assert (seq[:, others] >= 1).all() and (seq < cfg.vocab_size).all()


def test_shard_batch_waits_for_the_mesh():
    """``shard_batch`` places a batch onto a mesh: on a one-rank mesh every
    leaf is a DTensor holding the whole batch, split over the dp axes."""
    from torch.distributed.tensor import DTensor, Shard
    from test_torch_common import cpu_mesh
    cfg = pget("qwen3-1.7b").reduced()
    shape = dataclasses.replace(PSHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    b = ppipe.batch_at(cfg, shape, 0, device="cpu")
    with cpu_mesh() as mesh:
        placed = ppipe.shard_batch(b, mesh)
        assert set(placed) == set(b)
        for k, v in placed.items():
            assert isinstance(v, DTensor) and v.shape == b[k].shape
            assert v.placements[0] == Shard(0)
            assert torch.equal(v.to_local(), b[k])


def test_no_silent_cpu_batch_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this guard describes a host without a CUDA device")
    cfg = pget("qwen3-1.7b").reduced()
    shape = dataclasses.replace(PSHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppipe.batch_at(cfg, shape, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppipe.Pipeline(cfg, shape)
