from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: F401
                                           CheckpointError, fsync_directory)
