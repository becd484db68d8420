"""Checkpoints of the port, in the JAX package's format."""
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
