"""repro_torch.roofline — the JAX package's modeled wire bytes
(``repro.roofline.terms``' byte counts), arithmetic on parameter counts and
configs. The compute, memory and link-time terms of the JAX roofline are
rates of a TPU and are not ported here (ROADMAP Queue 1, item 10)."""
from repro_torch.roofline.terms import (
    elastic_presence,
    meta_wire_bytes,
    participant_wire_bytes,
    topology_wire_bytes,
)

__all__ = [
    "elastic_presence",
    "meta_wire_bytes",
    "participant_wire_bytes",
    "topology_wire_bytes",
]
