"""repro_torch.roofline: the port's cost model on an NVIDIA H100 (the
JAX package's ``repro.roofline``): ``cost.jit_cost``, the cost of one call
counted on the meta device (``hlo_cost.jit_cost``'s counterpart), with the
collective bytes of one rank of a mesh (``roofline/hlo.py``'s
``collective_bytes``), and ``terms``, the wire bytes of a meta step, the
roofline terms at the H100's data-sheet rates and a kernel's bound."""
from repro_torch.roofline.cost import JitCost, collective_bytes, jit_cost
from repro_torch.roofline.terms import (
    H100_SXM,
    Rates,
    RooflineTerms,
    compute_terms,
    elastic_presence,
    kernel_bound,
    meta_wire_bytes,
    model_flops,
    participant_wire_bytes,
    topology_wire_bytes,
    wire_seconds,
)

__all__ = [
    "H100_SXM",
    "JitCost",
    "Rates",
    "RooflineTerms",
    "collective_bytes",
    "compute_terms",
    "elastic_presence",
    "jit_cost",
    "kernel_bound",
    "meta_wire_bytes",
    "model_flops",
    "participant_wire_bytes",
    "topology_wire_bytes",
    "wire_seconds",
]
