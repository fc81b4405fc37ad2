from repro_torch.utils.tree import (
    tree_add,
    tree_broadcast_learners,
    tree_cast,
    tree_leaves,
    tree_map,
    tree_mean_axis0,
    tree_norm,
    tree_paths,
    tree_sub,
    tree_unflatten,
)
