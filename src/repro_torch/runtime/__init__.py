from repro_torch.runtime.trainer import (ResilientTrainer, TrainerConfig,
                                         TrainerJobHandle)

__all__ = ["ResilientTrainer", "TrainerConfig", "TrainerJobHandle"]
