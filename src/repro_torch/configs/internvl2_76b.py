"""InternVL2 76B [arXiv:2404.16821; unverified tier].

LM backbone (Llama-3-70B-class): 80L, d_model 8192, 64 heads (GQA kv=8),
d_ff 28672, vocab 128256. InternViT frontend is a STUB per assignment:
input_specs() supplies projected patch embeddings (batch, 256, 8192)
prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    pattern=(("attn", "dense"),),
    repeats=80,
    vision_prefix_len=256,
    rope_theta=5e5,
    notes="ViT frontend stubbed (patch embeddings supplied); long_500k skipped",
)
