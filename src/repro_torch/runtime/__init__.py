from repro_torch.runtime.trainer import (ResilientTrainer, TrainerConfig,
                                         TrainerJobHandle)
from repro_torch.runtime.server import StreamServer

__all__ = ["ResilientTrainer", "TrainerConfig", "TrainerJobHandle",
           "StreamServer"]
