from repro_torch.checkpoint.checkpointing import (DiskCheckpointStore,
                                                  MemoryCheckpointStore,
                                                  flatten_params,
                                                  unflatten_params)

__all__ = ["DiskCheckpointStore", "MemoryCheckpointStore", "flatten_params",
           "unflatten_params"]
