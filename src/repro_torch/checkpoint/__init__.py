"""Atomic, verified numpy checkpoints (the port of ``repro.checkpoint``)."""
from .store import (CorruptCheckpointError, gc_checkpoints, latest_step,
                    quarantine, read_metadata, restore_checkpoint,
                    restore_checkpoint_safe, save_checkpoint)

__all__ = [
    "CorruptCheckpointError", "gc_checkpoints", "latest_step", "quarantine",
    "read_metadata", "restore_checkpoint", "restore_checkpoint_safe",
    "save_checkpoint",
]
