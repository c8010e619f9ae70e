"""Whisper large-v3 [arXiv:2212.04356; unverified tier].

Enc-dec, 32+32L, d_model 1280, 20 heads (MHA), d_ff 5120, vocab 51866.
Conv frontend is a STUB per assignment: input_specs() supplies precomputed
frame embeddings (batch, 1500, 1280); decoder uses learned positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    pattern=(("xattn", "dense"),),
    repeats=32,
    is_encoder_decoder=True,
    n_encoder_layers=32,
    encoder_seq_len=1500,
    learned_pos=True,
    max_position=32768,
    causal=True,
    act="gelu",
    notes=("enc-dec; GeLU MLP; frontend stubbed (frame embeddings supplied); "
           "long_500k skipped (full attention)"),
)
