from repro_torch.checkpoint.manager import (CheckpointManager, list_steps,
                                            restore_tree, save_tree)

__all__ = ["CheckpointManager", "list_steps", "restore_tree", "save_tree"]
