from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            SaveHandle, load_checkpoint,
                                            save_checkpoint)
