# Meta-level mixing topologies (the JAX package's repro.topology): who
# averages with whom, how often: flat, hierarchical, gossip and the async
# bounded-staleness server, with elastic membership and robust aggregation.
from repro_torch.topology.async_server import (
    AsyncServer,
    resolve_async_config,
    step_time_profile,
)
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
    # the legacy downpour/eamsgd algorithms are aliases onto the async
    # bounded-staleness server (resolve_async_config)
    if kind == "async" or cfg.algorithm in ("eamsgd", "downpour"):
        return AsyncServer(cfg, reducer, dither)
    if kind == "flat":
        return FlatAllReduce(cfg, reducer, dither)
    if kind == "hierarchical":
        return Hierarchical(cfg, reducer, dither)
    if kind == "gossip":
        return Gossip(cfg, reducer, dither)
    raise ValueError(f"unknown topology {kind!r}")


__all__ = [
    "AsyncServer",
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
    "resolve_async_config",
    "step_time_profile",
]
