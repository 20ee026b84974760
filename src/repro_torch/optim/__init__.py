"""Optimizers and distributed-optimization tricks (the counterpart of the
reference package's ``repro.optim``): plain PyTorch, no ``torch.optim``."""

from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import dequantize_int8, ef_compress_update, quantize_int8
from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, apply_updates, sgd
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "adamw",
    "adafactor",
    "sgd",
    "apply_updates",
    "Optimizer",
    "warmup_cosine",
    "clip_by_global_norm",
    "global_norm",
    "quantize_int8",
    "dequantize_int8",
    "ef_compress_update",
]
