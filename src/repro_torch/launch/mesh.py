"""Production meshes on H100s (the JAX package's ``launch/mesh.py``, whose
meshes are TPU v5e pods).

Tensor parallelism stays inside one NVLink domain, an 8-GPU HGX node, so
the 'model' axis is 8 wide and the nodes make up 'data':

* single: (32, 8) over ('data', 'model'), 256 GPUs in 32 nodes. M-AVG
  learners live on 'data' (P = 32 learners, each an 8-way group).
* multi: (2, 32, 8) over ('pod', 'data', 'model'), 512 GPUs. Faithful
  mode: P = 64 learners over ('pod', 'data'). Hierarchical mode: P = 2
  learners, one a pod, each copy FSDP-split over 'data' x 'model'; the
  only traffic between the pods is the meta average every K steps.

JAX's production meshes are (16, 16) and (2, 16, 16): a v5e pod's 16x16
torus. This module defines functions only: importing it touches no
process group. ``make_production_mesh`` builds a DeviceMesh on the
process group that exists; the dry run (``launch/dryrun.py``) starts a
fake group of ``mesh.size`` ranks in its own process first
(``start_fake_group``), as JAX's dry run sets ``XLA_FLAGS`` in its own
process. The learner and FSDP axes are read off the axis sizes only, so
these functions also take an ``AbstractMesh``.
"""
from __future__ import annotations

import math

from repro_torch.sharding.rules import mesh_shape

SINGLE_POD_SHAPE = (32, 8)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")


class AbstractMesh:
    """Axis names and sizes, no devices (JAX's ``AbstractMesh``): what
    the sharding rules and specs read."""

    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the single or multi production mesh."""
    if multi_pod:
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return SINGLE_POD_SHAPE, SINGLE_POD_AXES


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """A fake process group of ``world_size`` ranks in this process (no
    devices, no peers: its collectives return at once), for a DeviceMesh
    of the production size. Only the dry run's own process calls this."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_world_size() == world_size
                and dist.get_backend() == "fake"):
            return
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks "
            f"({dist.get_backend()}) exists; the dry run needs a fake group "
            f"of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape, axis_names, device_type: str = "cpu"):
    """A DeviceMesh of ``shape`` over the existing process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def mesh_size(mesh) -> int:
    """Number of devices of a DeviceMesh or an AbstractMesh."""
    return math.prod(mesh_shape(mesh).values())


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def learner_axes(mesh, *, hierarchical: bool = False):
    """Mesh axes the learner (paper's P) dimension is split over."""
    if "pod" in mesh_shape(mesh):
        return ("pod",) if hierarchical else ("pod", "data")
    return ("data",)


def num_learners(mesh, *, hierarchical: bool = False) -> int:
    shape = mesh_shape(mesh)
    out = 1
    for a in learner_axes(mesh, hierarchical=hierarchical):
        out *= shape[a]
    return out


def fsdp_axes(mesh, *, hierarchical: bool = False):
    """Axes that split each learner's copy beyond tensor parallelism."""
    if hierarchical and "pod" in mesh_shape(mesh):
        return "data"
    return None


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cpu"):
    """A small mesh for CPU integration tests (a process group of at
    least data * model ranks must exist)."""
    return make_mesh((data, model), ("data", "model"), device_type)
