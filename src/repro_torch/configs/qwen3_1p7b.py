"""Qwen3 1.7B [hf:Qwen/Qwen3-8B family; hf-verified dims for the 1.7B size].

28L, d_model 2048, 16 heads (GQA kv=8, head_dim 128), d_ff 6144,
vocab 151936, qk-norm, RoPE theta 1e6.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=(("attn", "dense"),),
    repeats=28,
    qk_norm=True,
    rope_theta=1e6,
    notes="dense GQA + qk_norm; long_500k skipped (full attention)",
)
