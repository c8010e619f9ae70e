"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 6400, vocab 32064,
16 experts top-2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    pattern=(("attn", "moe"),),
    repeats=32,
    n_experts=16,
    experts_per_tok=2,
    rope_theta=1e4,
    notes="16e top-2 MoE every layer; long_500k skipped (full attention)",
)
