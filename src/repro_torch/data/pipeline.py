"""Deterministic synthetic data pipeline (the JAX package's
``data/pipeline.py``).

Stateless by step: ``batch_at(step)`` derives every batch from
``fold_in(PRNGKey(seed), step)`` by threefry, so restarts and skip-ahead are
exact (a job resumed at step N reproduces the same stream with no iterator
state to checkpoint). The stream is the JAX package's, bit for bit
(``data/_threefry.py``: the tokens and labels are equal; the bf16 stub
embeddings can differ by one bf16 step where XLA's float32 erfinv and
numpy's log1p part): the bits are made on the host in uint32, then placed
on the device. Emits next-token labels, vision/audio stub embeddings per
arch, and document-boundary structure (a few EOS-separated "documents" per
row) so the loss is not purely uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data import _threefry as tf
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    eos_id: int = 0
    doc_len: int = 257          # pseudo-document period (prime-ish)


def _tokens(key, B: int, S: int, vocab: int, dcfg: DataConfig) -> np.ndarray:
    toks = tf.randint(key, (B, S + 1), 1, vocab)
    pos = np.arange(S + 1)
    doc_end = (pos % dcfg.doc_len) == (dcfg.doc_len - 1)
    return np.where(doc_end[None, :], np.int32(dcfg.eos_id), toks)


def _embeds(key, shape, device) -> torch.Tensor:
    """``(normal(key, shape) * 0.02).astype(bfloat16)`` on ``device``."""
    x = tf.normal(key, shape) * np.float32(0.02)
    return torch.from_numpy(x).to(torch.bfloat16).to(device)


def batch_at(cfg: ArchConfig, shape: ShapeSpec, step: int,
             dcfg: DataConfig = DataConfig(),
             device=None) -> Dict[str, torch.Tensor]:
    """Global batch for ``step`` on ``device`` (``None``: the card, which
    raises without one): ``tokens`` and ``labels`` (B, S) int32, and
    ``vis_embeds`` (B, P, D) or ``frames`` (B, Senc, D) in bf16 where the
    config takes them."""
    device = resolve_device(device)
    key = tf.fold_in(tf.prng_key(dcfg.seed), step)
    B = shape.global_batch
    S_text = shape.seq_len - (cfg.vision_prefix_len or 0)
    kt, kv, kf = tf.split(key, 3)
    seq = torch.from_numpy(_tokens(kt, B, S_text, cfg.vocab_size,
                                   dcfg)).to(device)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.vision_prefix_len:
        batch["vis_embeds"] = _embeds(
            kv, (B, cfg.vision_prefix_len, cfg.d_model), device)
    if cfg.is_encoder_decoder:
        batch["frames"] = _embeds(
            kf, (B, cfg.encoder_seq_len, cfg.d_model), device)
    return batch


def shard_batch(batch: Dict, mesh, specs=None) -> Dict:
    """Place a batch onto ``mesh`` (a DeviceMesh) with the cell's input
    shardings: each leaf becomes a DTensor whose local tensor is this rank's
    shard, on the mesh's device. ``specs`` maps a leaf's name to a
    ``launch.sharding.ShapeDtypeStruct`` (``batch_specs``) whose sharding is
    used; any other leaf is split on dim 0 over the dp axes. Every rank
    passes the whole batch (the stateless pipeline gives every rank the same
    one)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.sharding import NamedSharding
    dp = dp_axes(mesh)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def put(name, x):
        if specs and name in specs:
            sh = specs[name].sharding
        else:
            sh = NamedSharding(mesh, (dp,) + (None,) * (x.ndim - 1))
        local = x[sh.local_index(tuple(x.shape))].contiguous().to(dev)
        return DTensor.from_local(local, mesh, sh.placements(),
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(
                                      x.shape, device="meta").stride())

    return {k: put(k, v) for k, v in batch.items()}


class Pipeline:
    """Iterator facade with exact skip-ahead (`state` is just the step)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 dcfg: DataConfig = DataConfig(), start_step: int = 0,
                 device=None):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self.device = resolve_device(device)
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = batch_at(self.cfg, self.shape, self.step, self.dcfg, self.device)
        self.step += 1
        return b

    def skip_to(self, step: int):
        self.step = step
