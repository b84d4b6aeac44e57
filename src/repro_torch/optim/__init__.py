from repro_torch.optim.compression import (compress_tree, compressed_psum,
                                           decompress_tree, init_residual)
from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, sgd)
from repro_torch.optim.schedule import make_schedule

__all__ = ["Optimizer", "adamw", "sgd", "clip_by_global_norm",
           "global_norm", "make_optimizer", "make_schedule",
           "compress_tree", "decompress_tree", "init_residual",
           "compressed_psum"]
