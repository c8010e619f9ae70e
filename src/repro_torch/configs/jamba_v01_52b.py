"""Jamba v0.1 52B [arXiv:2403.19887; hf-verified].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 65536,
Mamba:attention 7:1 interleave, MoE (16e top-2) every second layer.
Period-8 pattern (attention at slot 4, matching the released config),
scanned 4x. Mamba layers use the chunked SSD formulation (DESIGN.md §7).
"""
from repro_torch.configs.base import ArchConfig

_PATTERN = (
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PATTERN,
    repeats=4,
    ssm_chunk=64,   # tuned: intra-chunk traffic scales with S*L (EXPERIMENTS §Perf)
    n_experts=16,
    experts_per_tok=2,
    rope_theta=1e4,
    notes=("hybrid 1:7 attn:mamba + MoE/2; attention KV grows with context "
           "but per-token decode is O(window-free attn over 4 layers) — "
           "long_500k RUNS with context-parallel KV for the 4 attn layers"),
)
