"""The reference's wire model: bytes one meta step ships, per participant,
per flat round and per edge class of a topology (the JAX package's
``roofline/terms.py``, its byte counts).

Every function here counts bytes from a parameter count and the configs;
none carries a chip's rate. The JAX module also prices those bytes at a
TPU pod's link rates (its ``ICI_LINK_BW`` and ``DCN_LINK_BW``) and holds
the XLA cost terms; neither is the port's, and an H100 model with rates
measured on the card is ROADMAP Queue 1, item 10. The byte constants come
from the port's reducers (``comm.quant``, ``comm.topk``), so the model and
the reducers' own ``comm_bytes`` accounting cannot drift apart.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.comm.quant import SCALE_BYTES, VALUE_BYTES
from repro_torch.comm.topk import INDEX_BYTES
from repro_torch.configs.base import AsyncConfig, CommConfig
from repro_torch.topology import (
    avg_graph_degree,
    membership_schedule,
    mixing_matrix_stack,
    step_time_profile,
)


def participant_wire_bytes(n_params: int, comm: Optional[CommConfig], *,
                           learner_bytes: int = 4) -> float:
    """Payload ONE participant ships under ``comm`` (per meta round);
    scales are one f32 per chunk_rows x 128 values."""
    if comm is None or comm.scheme == "dense":
        return float(n_params * learner_bytes)
    n_chunks = max(1.0, n_params / (comm.chunk_rows * 128))
    if comm.scheme in VALUE_BYTES:
        per = n_params * VALUE_BYTES[comm.scheme] + n_chunks * SCALE_BYTES
    elif comm.scheme == "topk":
        per = comm.k_frac * n_params * (learner_bytes + INDEX_BYTES)
    elif comm.scheme == "int8_topk":
        per = (comm.k_frac * n_params * (VALUE_BYTES["int8"] + INDEX_BYTES)
               + n_chunks * SCALE_BYTES)
    else:
        raise ValueError(f"unknown comm scheme {comm.scheme!r}")
    return float(per)


def meta_wire_bytes(n_params: int, comm: Optional[CommConfig], *,
                    num_learners: int,
                    learner_bytes: int = 4) -> tuple[float, float]:
    """(dense_bytes, wire_bytes) of one *flat* meta averaging round:
    every learner ships its (possibly compressed) displacement."""
    dense = float(num_learners * n_params * learner_bytes)
    wire = num_learners * participant_wire_bytes(
        n_params, comm, learner_bytes=learner_bytes)
    return dense, wire


def elastic_presence(topology, num_learners: int) -> tuple[float, float]:
    """(learner_frac, edge_frac) expected under the membership schedule.

    ``learner_frac`` is the mean fraction of learners present per meta
    step; ``edge_frac`` the mean fraction of graph edges with both
    endpoints present, averaged over the combined schedule x graph period
    for time-varying graphs. Both are 1.0 when elasticity is off.
    """
    if topology is None or getattr(topology, "elastic", None) is None:
        return 1.0, 1.0
    groups = topology.groups if topology.kind == "hierarchical" else 1
    sched = membership_schedule(num_learners, topology.elastic, groups=groups)
    learner_frac = float(sched.mean())
    if topology.kind != "gossip":
        return learner_frac, learner_frac
    stack = mixing_matrix_stack(topology.graph, num_learners)
    T_g, T_s = stack.shape[0], sched.shape[0]
    eye = np.eye(num_learners, dtype=bool)
    tot = live = 0.0
    for t in range(math.lcm(T_g, T_s)):
        adj = (stack[t % T_g] > 0) & ~eye
        m = sched[t % T_s]
        tot += adj.sum()
        live += (adj & (m[:, None] > 0) & (m[None, :] > 0)).sum()
    return learner_frac, float(live / max(tot, 1.0))


def topology_wire_bytes(n_params: int, comm: Optional[CommConfig],
                        topology, *, num_learners: int,
                        learner_bytes: int = 4) -> dict:
    """Per-edge-class wire model of one meta iteration (amortized).

    Returns {"intra_bytes", "inter_bytes", "total_bytes"} plus the
    degree-over-time inputs ("avg_degree", "learner_presence",
    "edge_presence"), under the given ``TopologyConfig`` (None -> flat):

    flat          every learner's displacement feeds a global all-reduce,
                  all of it modeled as inter-node
    hierarchical  L intra-group payloads (inner_comm) every step, scaled
                  by the membership presence under elasticity; G
                  cross-group payloads (outer_comm) every outer_every
                  steps, amortized
    gossip        every learner ships to each live graph edge every step,
                  inter-node; the degree averaged over the graph period,
                  an edge dead when either endpoint is absent
    async         learner j ships its dense plane once per step_time[j]
                  ticks, so the per-tick payload is sum_j per / m_j
    """
    L = num_learners

    def per(c):
        return participant_wire_bytes(n_params, c,
                                      learner_bytes=learner_bytes)

    avg_deg = 0.0
    learner_frac, edge_frac = elastic_presence(topology, L)
    if topology is None or topology.kind == "flat":
        inter = L * per(comm)
        intra = 0.0
    elif topology.kind == "hierarchical":
        intra = L * per(topology.inner_comm or comm) * learner_frac
        inter = (topology.groups * per(topology.outer_comm or comm)
                 / topology.outer_every)
    elif topology.kind == "gossip":
        avg_deg = avg_graph_degree(topology.graph, L)
        intra = 0.0
        inter = L * avg_deg * per(topology.inner_comm or comm) * edge_frac
    elif topology.kind == "async":
        acfg = (topology.server if topology.server is not None
                else AsyncConfig())
        prof = step_time_profile(L, acfg)
        pushes_per_tick = float((1.0 / prof).sum())
        intra = 0.0
        inter = per(comm) * pushes_per_tick * learner_frac
    else:
        raise ValueError(f"unknown topology {topology.kind!r}")
    return {"intra_bytes": float(intra), "inter_bytes": float(inter),
            "total_bytes": float(intra + inter),
            "avg_degree": float(avg_deg),
            "learner_presence": learner_frac, "edge_presence": edge_frac}
