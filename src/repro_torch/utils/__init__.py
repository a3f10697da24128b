from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (cast_floating, global_norm, param_bytes,
                                    param_count, tree_flatten_with_names,
                                    tree_leaves, tree_map)
