"""Atomic, async checkpoints of trees of arrays and tensors (the plan
executor's state, a training run's parameters and optimizer state).

The layout is the reference package's (``repro.checkpoint``), so a
checkpoint written by either package restores in the other.
"""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    Stacked,
    flatten,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "Stacked",
    "flatten",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
