"""Atomic, async checkpointing in the reference's format."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
