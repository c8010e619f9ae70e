"""Checkpoints of trees of tensors, in the JAX package's on-disk layout."""
