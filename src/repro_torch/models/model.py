"""Unified model: parameters, forward, cache init, single-token decode,
sequential prefill, for every configuration of the JAX package.

As in the JAX package, one class covers the ``pattern × repeats`` layer
stack of any mixers ``models/blocks.py`` runs (attention, cross-attention,
Mamba, mLSTM, sLSTM; dense and MoE FFNs), the encoder-decoder wiring
(Whisper: an encoder of non-causal attention layers over precomputed frame
embeddings, learned positions, a cross-attention in every decoder layer)
and the vision prefix (InternVL: precomputed patch embeddings before the
text); the frontends are stubs in the JAX package too. The parameters are a
nested dict of tensors whose leaves are stacked over ``repeats`` (the same
tree as the JAX package's, so weights carry across leaf for leaf, see
``models/interop.py``). The layers run in a Python loop over the stack;
every RMSNorm, attention and decode-attention goes through the port's
kernels. The decode cache holds each layer's KV cache (and cross cache) or
recurrent state, stacked the same way, and a decode step writes it in
place.

Batch dict keys: ``tokens`` (B, S) integer token ids; ``labels`` (B, S)
next-token targets for :meth:`Model.loss_fn`; ``vis_embeds`` (B, P, D) the
patch-embedding prefix (vision configs); ``frames`` (B, Senc, D) the audio
frame embeddings (encoder-decoder configs).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch import partition as pt
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (device_of, embed, init_dense,
                                       init_embed, init_scale, logits_f32,
                                       rms_norm, softmax_xent)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.param_dtype]


def _layer(tree: Dict, r: int) -> Dict:
    """Layer ``r`` of a tree stacked over repeats, or of its unbound views
    (views, no copy)."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _layers(tree: Dict, n: int) -> list:
    """The ``n`` layers of a tree stacked over repeats (views, no copy),
    each leaf unbound once: under autograd the layers' gradients are then
    stacked in one copy a leaf. Indexing the stack once a layer instead
    gives each layer's gradient as a zero-filled tensor of the whole stack,
    summed over the layers: n times the stack's bytes, written n times."""
    def unbind(t):
        return {k: unbind(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in t.items()}
    views = unbind(tree)
    return [_layer(views, r) for r in range(n)]


class Model:
    """``device``: where parameters, caches and activations live; ``None``
    means the card, and raises without one (pass ``device="cpu"`` to run on
    the CPU)."""

    def __init__(self, cfg: ArchConfig, device=None):
        for mixer, ffn in cfg.pattern:
            blk.check_slot(mixer, ffn)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Dict:
        """Random weights drawn from ``generator``, which must be a
        generator of this model's device. They differ from the JAX
        package's for the same seed; carry its weights across with
        ``models.interop.params_from_jax`` to compare the two."""
        if device_of(generator).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        return self._init(generator)

    def _init(self, gen) -> Dict:
        cfg = self.cfg
        dt = _dtype(cfg)
        params: Dict = {
            "tok_embed": init_embed(gen, cfg.padded_vocab, cfg.d_model, dt),
            "final_norm": init_scale(cfg.d_model, dt, device_of(gen)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_dense(gen, cfg.d_model,
                                           cfg.padded_vocab, dt)
        if cfg.learned_pos:
            params["pos_embed"] = init_embed(gen, max(cfg.max_position, 1),
                                             cfg.d_model, dt)

        def stack_slots(pattern, repeats):
            return {f"slot{j}": _stack([blk.slot_init(gen, cfg, mixer, ffn,
                                                      dt)
                                        for _ in range(repeats)])
                    for j, (mixer, ffn) in enumerate(pattern)}
        params["layers"] = stack_slots(cfg.pattern, cfg.repeats)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "layers": stack_slots(_ENCODER_PATTERN, cfg.n_encoder_layers),
                "norm": init_scale(cfg.d_model, dt, device_of(gen)),
                "pos": init_embed(gen, max(cfg.encoder_seq_len, 1),
                                  cfg.d_model, dt),
            }
        return params

    def param_shapes(self) -> Dict:
        """The parameter tree as (shape, dtype) leaves, allocating nothing."""
        return tr.tree_map(lambda t: (tuple(t.shape), t.dtype),
                           self._init(None))

    def param_count(self) -> int:
        return int(sum(math.prod(s) for s, _ in
                       tr.leaves(self.param_shapes())))

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _encode(self, params: Dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (B, Senc, D) of the param
        dtype: learned positions added, ``n_encoder_layers`` non-causal
        attention layers, the final norm."""
        cfg, enc = self.cfg, params["encoder"]
        B, Senc, _ = frames.shape
        x = frames + enc["pos"][None, :Senc]
        positions = torch.arange(Senc, dtype=torch.int32,
                                 device=x.device).expand(B, Senc)
        (mixer, ffn), = _ENCODER_PATTERN
        for layer in _layers(enc["layers"], cfg.n_encoder_layers):
            x, _ = blk.slot_apply(layer["slot0"], cfg,
                                  mixer, ffn, x, positions, causal=False)
        return rms_norm(x, enc["norm"], cfg.norm_eps)

    def _prefix(self, batch: Dict) -> int:
        """Rows of the vision prefix in ``batch`` (0 without one)."""
        if self.cfg.vision_prefix_len and "vis_embeds" in batch:
            return batch["vis_embeds"].shape[1]
        return 0

    def _partition(self, act_spec, batch: Dict):
        """The sharded step's context (``launch/partition.py``) of
        ``batch`` under ``act_spec`` (``steps.make_act_constrainer``), or
        None: no constrainer, or one of an abstract mesh."""
        return pt.for_model(act_spec, self.cfg, pt.local(batch["tokens"]))

    def hidden_states(self, params: Dict, batch: Dict, act_spec=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the final-normed hidden states (B, S, D) of ``forward`` at the
        text positions, the MoE auxiliary loss summed over the layers: a
        float32 tensor of one element, 0 for a model without experts). A
        vision prefix runs before the text, positions counted over the
        whole sequence, and its rows are dropped after the final norm; an
        encoder-decoder encodes ``frames`` first and every cross-attention
        reads the encoder's output.

        ``act_spec``: the constrainer of ``steps.make_act_constrainer``, as
        the JAX package's ``forward`` takes it. On a live mesh ``params``
        are this rank's shards (``sharding.local_params``), ``batch`` this
        rank's rows (plain tensors or ``shard_batch``'s DTensors), and the
        hidden states this rank's (B/|dp|, S/|model|, D) with sequence
        parallelism, else (B/|dp|, S, D); the step issues the collectives
        of ``launch/partition.py``."""
        return self._hidden(params, batch, self._partition(act_spec, batch))

    def _hidden(self, params: Dict, batch: Dict, part):
        cfg = self.cfg
        tokens = pt.local(batch["tokens"])
        B = tokens.shape[0]
        x = (embed(tokens, params["tok_embed"]) if part is None
             else pt.embed(part, tokens, params["tok_embed"]))
        prefix = self._prefix(batch)
        if prefix:
            x = torch.cat([batch["vis_embeds"].to(x.dtype), x], dim=1)
        S = tokens.shape[1] + prefix
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        if cfg.learned_pos:
            x = x + params["pos_embed"][None, :S]
        enc_out = (self._encode(params, batch["frames"].to(x.dtype))
                   if cfg.is_encoder_decoder else None)
        aux = 0.0
        for slot_params in _layers(params["layers"], cfg.repeats):
            for j, (mixer, ffn) in enumerate(cfg.pattern):
                x, a = blk.slot_apply(slot_params[f"slot{j}"], cfg, mixer,
                                      ffn, x, positions, causal=cfg.causal,
                                      enc_out=enc_out, part=part)
                aux = aux + a
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x[:, prefix:], aux

    def head(self, params: Dict, x: torch.Tensor, part=None) -> torch.Tensor:
        """Logits (..., Vpad) in float32 from hidden states; with a
        sharded step's ``part``, this rank's vocabulary columns
        (``partition.head``)."""
        if part is not None:
            return pt.head(part, x, params)
        w = (params["tok_embed"].T if self.cfg.tie_embeddings
             else params["lm_head"])
        return logits_f32(x, w)

    def forward(self, params: Dict, batch: Dict, act_spec=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B, S_text, Vpad) float32, moe_aux), as the JAX
        package's ``forward``: ``moe_aux`` is the sum over the layers of
        each MoE layer's auxiliary loss times ``router_aux_coef``, a float32
        tensor of one element (0 without experts). On a live mesh
        (``act_spec``, as :meth:`hidden_states` takes it) the logits are
        this rank's (B/|dp|, S_text, Vpad/|model|): the sequence gathered,
        the head vocab-parallel."""
        part = self._partition(act_spec, batch)
        x, aux = self._hidden(params, batch, part)
        if part is not None:
            x = part.gather_seq(x)
        return self.head(params, x, part), aux

    def last_logits(self, params: Dict, batch: Dict,
                    act_spec=None) -> torch.Tensor:
        """The next-token logits of the prompt, float32: the head of the
        last position's hidden state only, (B, 1, Vpad); on a live mesh
        this rank's (B/|dp|, 1, Vpad/|model|), the last position sent by
        the rank that holds it (``partition.last_position``)."""
        part = self._partition(act_spec, batch)
        x, _aux = self._hidden(params, batch, part)
        if part is None:
            return self.head(params, x[:, -1:])
        return self.head(params, pt.last_position(part, x), part)

    def loss_fn(self, params: Dict, batch: Dict, act_spec=None):
        """(loss, metrics): the mean next-token cross-entropy of
        ``batch["labels"]`` plus ``moe_aux``, and a dict of ``loss``,
        ``xent`` and ``moe_aux``, as the JAX package's ``loss_fn``. On the
        card its gradient runs through each kernel's
        ``_lm.KernelWithPlainBackward``.

        ``act_spec`` (as :meth:`hidden_states` takes it): on a live mesh
        ``params`` are this rank's shards and ``batch`` its rows; the loss
        is the vocab-parallel cross-entropy of this rank's logit columns,
        averaged over the global batch (``partition.xent``), and ``loss``,
        ``xent`` and ``moe_aux`` are the same on every rank."""
        part = self._partition(act_spec, batch)
        x, aux = self._hidden(params, batch, part)
        if part is None:
            xent = softmax_xent(self.head(params, x), batch["labels"])
        else:
            logits = self.head(params, part.gather_seq(x), part)
            xent = pt.xent(part, logits, pt.local(batch["labels"]))
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "moe_aux": aux}

    def unread_params(self) -> set:
        """The paths (``tree.flatten_with_path``'s) of the leaves the forward
        never reads: a parallel block's ``norm2`` (its FFN reads the mixer's
        normed input). Their gradient is zero, as ``jax.grad`` gives it."""
        if not self.cfg.parallel_block:
            return set()
        return {("layers", f"slot{j}", "norm2")
                for j, (_m, ffn) in enumerate(self.cfg.pattern)
                if ffn != "none"}

    # ------------------------------------------------------------------
    # serving: cache init + single-token decode
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype=torch.bfloat16) -> Dict:
        cfg = self.cfg
        cache: Dict = {"layers": {}}
        for j, (mixer, _ffn) in enumerate(cfg.pattern):
            one = blk.slot_cache_init(cfg, mixer, batch_size, max_seq, dtype,
                                      self.device)
            cache["layers"][f"slot{j}"] = {
                k: torch.zeros((cfg.repeats,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device) for k, v in one.items()}
        return cache

    def cache_shapes(self, batch_size: int, max_seq: int,
                     dtype=torch.bfloat16) -> Dict:
        """The decode cache's tree as (shape, dtype) leaves, allocating
        nothing (the JAX package's ``abstract_cache``)."""
        cfg = self.cfg
        shapes: Dict = {"layers": {}}
        for j, (mixer, _ffn) in enumerate(cfg.pattern):
            one = blk.slot_cache_init(cfg, mixer, batch_size, max_seq, dtype,
                                      torch.device("meta"))
            shapes["layers"][f"slot{j}"] = {
                k: ((cfg.repeats,) + tuple(v.shape), v.dtype)
                for k, v in one.items()}
        return shapes

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos, embeds: Optional[torch.Tensor] = None,
                    cp_axes=None, mesh=None) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1); pos: the position of this token, a Python int or,
        as the JAX package's traced ``jnp.int32``, an int32 tensor of one
        element on this model's device. A tensor is read on the device only
        (the cache write, RoPE, the learned position's row, every
        ``flash_decode``'s ``kv_len``), so the step can be captured in a
        CUDA graph and replayed at any position. ``embeds`` (B, 1, D), cast
        to the param dtype, takes the place of the tokens' embedding (the
        vision prefix's positions during prefill).
        Writes this token's keys and values, or each recurrent layer's new
        state, into ``cache`` in place (the JAX package returns a new cache;
        updating in place saves a copy of the cache per step). Returns
        (logits (B, 1, Vpad) float32, cache); the MoE layers' auxiliary
        loss is neither kept nor computed
        (``blocks.slot_decode_output``), as the JAX package's compiled
        ``decode_step`` drops it.

        ``cp_axes`` = (seq_axes, batch_axes) and a live ``mesh`` make the
        step context-parallel: ``tokens`` are this rank's batch rows (its
        shard over ``batch_axes``) and every attention layer's k and v in
        ``cache`` this rank's shard of the sequence over ``seq_axes``
        (``blocks.cp_attention``, made once a step); ``pos`` stays the
        global position.
        """
        cfg = self.cfg
        pos, kv_len = blk.decode_position(pos, self.device)
        x = (embed(tokens, params["tok_embed"]) if embeds is None
             else embeds.to(_dtype(cfg)).contiguous())  # may be a slice
        if cfg.learned_pos:
            x = x + params["pos_embed"].index_select(0, pos)[None]
        cp_attn = blk.cp_attention(cp_axes, mesh)
        for r in range(cfg.repeats):
            slot_params = _layer(params["layers"], r)
            slot_cache = _layer(cache["layers"], r)
            for j, (mixer, ffn) in enumerate(cfg.pattern):
                x, _ = blk.slot_decode_output(
                    slot_params[f"slot{j}"], cfg, mixer, ffn, x,
                    slot_cache[f"slot{j}"], pos, kv_len=kv_len,
                    cp_attn=cp_attn)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.head(params, x), cache

    def prefill(self, params: Dict, batch: Dict, max_seq: int,
                dtype=torch.bfloat16, step=None,
                cache: Optional[Dict] = None) -> Tuple[Dict, torch.Tensor]:
        """Sequential prefill via decode steps (the reference path of the
        serving loop; production prefill runs ``forward``), the port's
        counterpart of the JAX package's ``lax.scan``. An encoder-decoder
        first encodes ``batch["frames"]`` and writes every layer's cross
        cache; a vision prefix of P rows runs first, one step a row with
        ``embeds=`` and zero tokens at positions 0 ... P - 1, the text then
        at P + i. ``step(params, cache, tokens, pos, embeds=None)`` runs
        each step (default ``self.decode_step``; ``serve.decode_batch``
        passes a CUDA-graph runner; ``embeds`` is only passed to the
        prefix's steps). ``cache``: the zeroed cache to fill, by default a
        new one of ``max_seq`` rows; a context-parallel step takes this
        rank's shard of it (``init_cache(B, max_seq // shards)``). Returns
        (cache, logits (B, 1, Vpad) of the last prompt token)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        prefix = self._prefix(batch)
        if max_seq < S + prefix:
            raise ValueError(f"prefill cache too small: {max_seq} < "
                             f"{S + prefix}")
        step = self.decode_step if step is None else step
        if cache is None:
            cache = self.init_cache(B, max_seq, dtype)
        if self.cfg.is_encoder_decoder:
            self._write_cross_cache(params, cache, self._encode(
                params, batch["frames"].to(_dtype(self.cfg))))
        if prefix:
            vis = batch["vis_embeds"]
            zeros = torch.zeros((B, 1), dtype=tokens.dtype,
                                device=self.device)
            for i in range(prefix):
                _, cache = step(params, cache, zeros, i,
                                embeds=vis[:, i:i + 1])
        logits = torch.zeros((B, 1, self.cfg.padded_vocab),
                             dtype=torch.float32, device=self.device)
        for i in range(S):
            logits, cache = step(params, cache, tokens[:, i:i + 1],
                                 prefix + i)
        return cache, logits

    def _write_cross_cache(self, params: Dict, cache: Dict,
                           enc_out: torch.Tensor) -> None:
        """Project the encoder's output into every decoder layer's cross
        cache xk/xv, in place (cast to the cache's dtype)."""
        cfg = self.cfg
        for j, (mixer, _f) in enumerate(cfg.pattern):
            if mixer != "xattn":
                continue
            slot_cache = cache["layers"][f"slot{j}"]
            for r in range(cfg.repeats):
                xattn = _layer(params["layers"][f"slot{j}"], r)["xattn"]
                k, v = blk.cross_kv(xattn, cfg, enc_out)
                slot_cache["xk"][r].copy_(k)
                slot_cache["xv"][r].copy_(v)


#: the encoder's layer: self-attention (non-causal) and a dense FFN
_ENCODER_PATTERN = (("attn", "dense"),)


def build_model(cfg: ArchConfig, device=None) -> Model:
    return Model(cfg, device)


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
