"""Atomic checkpoints of dicts of numpy arrays (the plan executor's state).

The layout is the reference package's (``repro.checkpoint``), so a
checkpoint written by either package restores in the other.
"""

from repro_torch.checkpoint.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
