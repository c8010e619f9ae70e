"""Architecture config system + registry (the JAX package's
``configs/base.py``, copied: the port imports nothing of that package).

Each architecture is a frozen ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``). ``ArchConfig`` and ``reduced()`` are
unchanged, so ``reduced()`` gives the same small config in both packages.
``pattern`` × ``repeats`` defines the layer stack: a *pattern* is a tuple of
(mixer, ffn) slots — mixer ∈ {attn, xattn, mamba, mlstm, slstm}, ffn ∈
{dense, moe, none} — scanned ``repeats`` times (the port loops over the
stacked layers in Python).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

Slot = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|audio|hybrid|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Slot, ...]
    repeats: int
    head_dim: Optional[int] = None
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full attention
    parallel_block: bool = False     # command-r style parallel attn+ffn
    learned_pos: bool = False        # whisper decoder
    max_position: int = 0            # learned_pos table size (0: set by caller)
    causal: bool = True
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                # expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    ws_rebalance: bool = True        # paper-technique-flavoured overflow steal
    router_aux_coef: float = 0.01
    moe_groups: int = 1              # GShard dispatch groups (launch sets =|dp|)
    train_microbatches: int = 1      # gradient accumulation (activation memory)
    # ssm / xlstm
    ssm_expand: int = 2
    ssm_head_p: int = 64
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0         # stub frontend output length
    # vlm
    vision_prefix_len: int = 0       # stub patch-embedding prefix
    # misc
    act: str = "swiglu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    attn_block_kv: int = 1024        # chunked-attention KV block
    vocab_pad_multiple: int = 128
    # notes for DESIGN/EXPERIMENTS (applicability, skips)
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch qualifies for ``long_500k`` per the assignment:
        SSM / hybrid / linear-attention archs run it (recurrent state or few
        CP-sharded attention layers); sliding-window attention qualifies;
        pure full-attention archs skip it."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window > 0:
            return True
        mixers = {m for m, _ in self.pattern}
        return not ("attn" in mixers or "xattn" in mixers)

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        base = dict(
            d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128, vocab_size=512, repeats=min(self.repeats, 2),
            head_dim=16, moe_d_ff=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_tok=min(self.experts_per_tok, 2) if self.n_experts else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else 0,
            vision_prefix_len=8 if self.vision_prefix_len else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            max_position=256 if self.learned_pos else 0,
            ssm_head_p=16, ssm_state=8, ssm_chunk=16,
            attn_block_kv=64,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


#: the architectures this port runs: every one of the JAX package's
_REGISTRY: Dict[str, str] = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.CONFIG


# ---------------------------------------------------------------------------
# Input shapes (assigned): every (arch × shape) dry-run cell.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) dry-run cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: 500k-token decode has no "
                       "sub-quadratic path (skip per assignment rules)")
    return True, ""
