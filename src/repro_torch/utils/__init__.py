from repro_torch.utils.trees import (TreeDef, np_dtype, resolve_device,
                                     tensor_to_numpy, to_tensor,
                                     tree_bytes, tree_flatten_with_names,
                                     tree_leaves, tree_map, tree_structure,
                                     tree_unflatten)
from repro_torch.utils.timing import Timer, now

__all__ = ["TreeDef", "np_dtype", "resolve_device", "tensor_to_numpy",
           "to_tensor", "tree_bytes", "tree_flatten_with_names",
           "tree_leaves", "tree_map", "tree_structure", "tree_unflatten",
           "Timer", "now"]
