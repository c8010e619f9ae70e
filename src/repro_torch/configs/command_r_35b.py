"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified tier].

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000,
no biases, cohere-style parallel attention+FFN block.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    pattern=(("attn", "dense"),),
    repeats=40,
    parallel_block=True,
    rope_theta=1e4,
    tie_embeddings=True,
    notes="parallel residual block, tied embeddings; long_500k skipped",
)
