# Meta-level mixing topologies (the JAX package's repro.topology). Only
# the flat all-reduce is ported; the others are ROADMAP Queue 1, item 6.
from repro_torch.topology.base import (
    FlatAllReduce,
    Topology,
    block_momentum_update,
    effective_momentum,
    fused_momentum_broadcast_update,
)


def make_topology(cfg, reducer=None) -> Topology:
    """Build the topology described by ``cfg.topology`` (an MAvgConfig)."""
    if cfg.algorithm in ("eamsgd", "downpour"):
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r} is an alias onto the async server, "
            f"which is not ported yet (ROADMAP Queue 1, item 6)"
        )
    if cfg.robust is not None:
        raise NotImplementedError(
            "robust aggregation is not ported yet (ROADMAP Queue 1, item 7)"
        )
    if cfg.finite_guard:
        raise NotImplementedError(
            "the finite guard is not ported yet (ROADMAP Queue 1, item 7)"
        )
    kind = cfg.topology.kind
    if kind != "flat":
        raise NotImplementedError(
            f"topology {kind!r} is not ported yet (ROADMAP Queue 1, item 6)"
        )
    return FlatAllReduce(cfg, reducer)
