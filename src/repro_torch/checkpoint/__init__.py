from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               restore_metadata,
                                               restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "restore_metadata"]
