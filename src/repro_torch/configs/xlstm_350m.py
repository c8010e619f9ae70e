"""xLSTM 350M [arXiv:2405.04517; unverified tier].

24L, d_model 1024, 4 heads, vocab 50304; alternating mLSTM/sLSTM blocks
(paper mixes both; exact interleave ratio is a free parameter — we use 1:1,
noted in DESIGN.md). Blocks carry their own projections (d_ff=0).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(("mlstm", "none"), ("slstm", "none")),
    repeats=12,
    tie_embeddings=True,
    notes="recurrent state decode: O(1)/token => long_500k RUNS",
)
