"""repro_torch.sharding: the JAX package's sharding rules as DeviceMesh /
DTensor placements (``rules``), and the placed meta step's per-device
view of a state (``placed``)."""
from repro_torch.sharding.rules import (
    PREFS,
    REPLICATED,
    Spec,
    add_learner_axis,
    leaf_spec,
    make_param_specs,
    mesh_shape,
    named,
    placements,
)

__all__ = [
    "PREFS",
    "REPLICATED",
    "Spec",
    "add_learner_axis",
    "leaf_spec",
    "make_param_specs",
    "mesh_shape",
    "named",
    "placements",
]
