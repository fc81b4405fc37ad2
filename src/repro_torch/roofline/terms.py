"""The roofline model of the port on an NVIDIA H100 (the JAX package's
``roofline/terms.py``): the wire bytes one meta step ships, the compute,
memory and collective terms of a costed program, and the least time of a
kernel call.

    compute    = flops            / (chips x peak BF16 FLOP/s)
    memory     = bytes            / (chips x HBM B/s)
    collective = collective_bytes / (chips x intra-node link B/s)

The flops and bytes come from ``roofline.cost.jit_cost``; the collective
bytes are an argument (one card has none to give: the dry run of a mesh
fills them). ``model_flops`` (6 N D to train, 2 N D to infer) is the
useful-work yardstick. The modeled meta-communication (``wire_bytes``,
the byte counts of the reducers, ``comm.quant`` and ``comm.topk``) is
priced per edge class: ``wire_s`` = intra-node bytes over the intra-node
link rate + inter-node bytes over the inter-node one.

The rates are a ``Rates`` value. ``H100_SXM`` holds the H100 SXM data
sheet's: HBM3 3.35 TB/s; dense f32 67, TF32 494.7 and BF16 989.4
TFLOP/s; NVLink 4 at 450 GB/s each way per GPU for the intra-node class
and one ConnectX-7 NDR port, 400 Gb/s = 50 GB/s, for the inter-node
class. These are data-sheet inputs, not measurements: the card's
measured memory and matmul rates are ``chip_smoke.py``'s, and one card
has no link to measure. The JAX module's TPU constants are not the
port's; a test builds a ``Rates`` from them to hold ``compute_terms`` to
JAX's field for field.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

from repro_torch.comm.quant import SCALE_BYTES, VALUE_BYTES
from repro_torch.comm.topk import INDEX_BYTES
from repro_torch.configs.base import (
    AsyncConfig,
    CommConfig,
    InputShape,
    ModelConfig,
)
from repro_torch.kernels.cost import KernelCost
from repro_torch.topology import (
    avg_graph_degree,
    membership_schedule,
    mixing_matrix_stack,
    step_time_profile,
)


@dataclass(frozen=True)
class Rates:
    """The ceilings of one chip: memory bytes/s, flops/s by operand type,
    and bytes/s of one link of each edge class."""

    name: str
    hbm_bytes_per_s: float
    f32_flops_per_s: float
    tf32_flops_per_s: float
    bf16_flops_per_s: float
    intra_link_bytes_per_s: float
    inter_link_bytes_per_s: float

    def flops_per_s(self, unit: str) -> float:
        """The rate of a kernel's flops of ``unit`` (``KernelCost``):
        3xTF32 takes three TF32 products per f32 product."""
        if unit == "f32":
            return self.f32_flops_per_s
        if unit == "bf16":
            return self.bf16_flops_per_s
        if unit == "tf32x3":
            return self.tf32_flops_per_s / 3.0
        raise ValueError(f"unknown flop unit {unit!r}")


# the H100 SXM data sheet (dense tensor-core rates, no sparsity); the link
# rates are data-sheet inputs, not measured
H100_SXM = Rates(
    name="H100 SXM (data sheet)",
    hbm_bytes_per_s=3.35e12,
    f32_flops_per_s=67e12,
    tf32_flops_per_s=494.7e12,
    bf16_flops_per_s=989.4e12,
    intra_link_bytes_per_s=450e9,  # NVLink 4, each way, per GPU
    inter_link_bytes_per_s=50e9,  # one ConnectX-7 NDR port, 400 Gb/s
)


def kernel_bound(cost: KernelCost, rates: Rates = H100_SXM
                 ) -> tuple[float, str]:
    """The least time of one kernel call, in seconds: its bytes over the
    memory rate or its flops over the rate of their type, whichever is
    larger, and which (``"bytes"`` or ``"operations"``)."""
    t_bytes = cost.nbytes / rates.hbm_bytes_per_s
    t_ops = cost.flops / rates.flops_per_s(cost.unit)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wire_seconds(intra_bytes: float, inter_bytes: float, *, chips: int = 1,
                 rates: Rates = H100_SXM) -> float:
    """Link time of one meta step's modeled payload: each edge class on
    its own fabric."""
    return (intra_bytes / (chips * rates.intra_link_bytes_per_s)
            + inter_bytes / (chips * rates.inter_link_bytes_per_s))


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float  # model_flops / flops
    # modeled meta-communication (comm); 0 / "dense" when not computed
    wire_bytes: float = 0.0
    wire_s: float = 0.0
    comm_scheme: str = "dense"
    # per edge class: intra-node vs inter-node payload per meta step,
    # amortized over outer_every
    wire_intra_bytes: float = 0.0
    wire_inter_bytes: float = 0.0
    topology: str = "flat"

    def to_dict(self):
        return asdict(self)


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


def model_flops(cfg: ModelConfig, shape: InputShape,
                k_steps: int = 1) -> float:
    """6 N D per processed token (training) or 2 N D (inference forward)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * k_steps
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def compute_terms(*, arch: str, shape: InputShape, mesh_name: str,
                  chips: int, hlo_flops: float, hlo_bytes: float,
                  collective_bytes: float, cfg: ModelConfig,
                  k_steps: int = 1, per_device: bool = True,
                  comm: Optional[CommConfig] = None, num_learners: int = 1,
                  topology=None, rates: Rates = H100_SXM,
                  collectives_by_axes: Optional[dict] = None
                  ) -> RooflineTerms:
    """The roofline terms of one costed program (``hlo_flops`` and
    ``hlo_bytes``: ``jit_cost``'s flops and bytes, JAX's names kept).
    ``per_device``: the numbers are one chip's already; else the
    whole program's, divided over ``chips``. ``collectives_by_axes``:
    the collective bytes by the mesh axes their groups span
    (``JitCost.collectives_by_axes``); then a group inside the 'model'
    axis (one NVLink node) moves at the NVLink rate and any other at the
    node's network rate, instead of all at the NVLink rate."""
    mf = model_flops(cfg, shape, k_steps)
    div = 1 if per_device else chips
    compute_s = hlo_flops / (div * rates.bf16_flops_per_s)
    memory_s = hlo_bytes / (div * rates.hbm_bytes_per_s)
    if collectives_by_axes is None:
        collective_s = collective_bytes / (div * rates.intra_link_bytes_per_s)
    else:
        collective_s = sum(
            b / (div * (rates.intra_link_bytes_per_s if axes == "model"
                        else rates.inter_link_bytes_per_s))
            for axes, b in collectives_by_axes.items())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf_dev = mf / chips if per_device else mf
    wire_bytes = wire_s = intra_b = inter_b = 0.0
    if comm is not None or topology is not None:
        edge = topology_wire_bytes(cfg.param_count(), comm, topology,
                                   num_learners=num_learners)
        intra_b, inter_b = edge["intra_bytes"], edge["inter_bytes"]
        wire_bytes = edge["total_bytes"]
        wire_s = wire_seconds(intra_b, inter_b, chips=chips, rates=rates)
    return RooflineTerms(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=mf,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        useful_ratio=mf_dev / hlo_flops if hlo_flops else 0.0,
        wire_bytes=wire_bytes,
        wire_s=wire_s,
        comm_scheme=comm.scheme if comm is not None else "dense",
        wire_intra_bytes=intra_b,
        wire_inter_bytes=inter_b,
        topology=topology.kind if topology is not None else "flat",
    )
