"""DeepSeek 67B [arXiv:2401.02954; hf-verified].

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400, llama-arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    pattern=(("attn", "dense"),),
    repeats=95,
    rope_theta=1e4,
    notes="dense GQA llama-arch; long_500k skipped (full attention)",
)
