"""The optimizer (AdamW) and the error-feedback int8 gradient compression
of the training path."""
from repro_torch.optim import adamw  # noqa: F401
