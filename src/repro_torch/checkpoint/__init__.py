"""Checkpoints: the trainer's atomic keep-k manager and serving base
snapshots."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    load_base_snapshot,
    save_base_snapshot,
)
