from repro_torch.utils.trees import (TreeDef, np_dtype, resolve_device,
                                     tensor_to_numpy, to_tensor,
                                     tree_allclose, tree_bytes, tree_count,
                                     tree_flatten_with_names, tree_leaves,
                                     tree_map, tree_structure,
                                     tree_unflatten, tree_zeros_like)
from repro_torch.utils.timing import Timer, now

__all__ = ["TreeDef", "np_dtype", "resolve_device", "tensor_to_numpy",
           "to_tensor", "tree_allclose", "tree_bytes", "tree_count",
           "tree_flatten_with_names", "tree_leaves", "tree_map",
           "tree_structure", "tree_unflatten", "tree_zeros_like", "Timer",
           "now"]
