"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified tier].

32L, d_model 3072, 32 heads (kv=32 -> MHA), d_ff 8192, vocab 32064,
RoPE + SwiGLU. Head dim 96 at full width: the port's attention kernels
take it (flash attention's tensor-core route loads it as three 32-column
sub-tiles; flash decode pads its lane groups to a power of two).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    pattern=(("attn", "dense"),),
    repeats=32,
    rope_theta=1e4,
    notes="MHA (kv=32); long_500k skipped (full attention)",
)
