from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedule import make_schedule

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "make_optimizer", "make_schedule"]
