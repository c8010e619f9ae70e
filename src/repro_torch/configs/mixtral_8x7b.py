"""Mixtral 8x7B [arXiv:2401.04088; hf-verified].

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
8 experts top-2, sliding-window attention (4096).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    pattern=(("attn", "moe"),),
    repeats=32,
    n_experts=8,
    experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1e6,
    notes="SWA 4096 => sub-quadratic decode => long_500k RUNS",
)
