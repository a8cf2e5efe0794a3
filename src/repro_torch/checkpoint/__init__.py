from repro_torch.checkpoint.manager import (CheckpointError, CheckpointManager,
                                            ModelUpdateStream)

__all__ = ["CheckpointError", "CheckpointManager", "ModelUpdateStream"]
