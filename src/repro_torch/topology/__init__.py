# Meta-level mixing topologies (the JAX package's repro.topology): who
# averages with whom, how often. Flat, hierarchical and gossip are ported,
# with elastic membership and robust aggregation; the async server (and
# the eamsgd/downpour aliases onto it) is ROADMAP Queue 1, item 6.
from repro_torch.topology.base import (
    FlatAllReduce,
    Topology,
    block_momentum_update,
    effective_momentum,
    fused_momentum_broadcast_update,
)
from repro_torch.topology.elastic import (
    mask_mixing_matrix,
    membership_at,
    membership_schedule,
    present_edge_count,
)
from repro_torch.topology.gossip import (
    Gossip,
    avg_graph_degree,
    compress_stack,
    graph_degree,
    mixing_matrix,
    mixing_matrix_stack,
    mixing_period,
)
from repro_torch.topology.hierarchical import Hierarchical


def make_topology(cfg, reducer=None, dither=None) -> Topology:
    """Build the topology described by ``cfg.topology`` (an MAvgConfig).

    ``reducer`` overrides the primary reducer (flat: the all-reduce;
    hierarchical: intra-group; gossip: neighbor exchange). ``dither``
    replaces the quantizers' dither source in every reducer the topology
    builds itself (``comm.quant.QuantReducer``).
    """
    kind = cfg.topology.kind
    if kind == "async" or cfg.algorithm in ("eamsgd", "downpour"):
        raise NotImplementedError(
            f"the async server (topology {kind!r}, algorithm "
            f"{cfg.algorithm!r}; eamsgd and downpour are aliases onto it) "
            f"is not ported yet (ROADMAP Queue 1, item 6)"
        )
    if kind == "flat":
        return FlatAllReduce(cfg, reducer, dither)
    if kind == "hierarchical":
        return Hierarchical(cfg, reducer, dither)
    if kind == "gossip":
        return Gossip(cfg, reducer, dither)
    raise ValueError(f"unknown topology {kind!r}")


__all__ = [
    "FlatAllReduce",
    "Gossip",
    "Hierarchical",
    "Topology",
    "avg_graph_degree",
    "block_momentum_update",
    "compress_stack",
    "effective_momentum",
    "fused_momentum_broadcast_update",
    "graph_degree",
    "make_topology",
    "mask_mixing_matrix",
    "membership_at",
    "membership_schedule",
    "mixing_matrix",
    "mixing_matrix_stack",
    "mixing_period",
    "present_edge_count",
]
