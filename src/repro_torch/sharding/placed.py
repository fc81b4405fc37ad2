"""The M-AVG meta step of one rank of a mesh: the state placed by
``launch/specs.state_shardings`` as DTensors, the step run on this rank's
pieces through the port's own ``core/meta.py::meta_step``.

What one rank runs, for the packed flat dense meta step (the default
configuration, the one JAX's dry run lowers):

* its L_loc = L / |learner axes| learners (the learner dim of the
  (L, rows, 128) stack is split over the learner axes);
* the local phase on the whole of each of its learners' planes: where the
  plane's rows are split over 'model', one all-gather over 'model' brings
  them in first, the K local steps run on this rank's copy, and its rows
  are taken back (no communication). JAX's GSPMD does the same with the
  packed plane: its dry run of the (4, 2) test mesh has no
  tensor-parallel collective and charges each device one whole learner's
  flops (``tests/test_torch_dryrun.py`` holds the port to those flops);
* the mix on the local rows: the mean over its L_loc learners, completed
  across the learner axes by one all-reduce, then the fused
  momentum-broadcast kernel on the local planes;
* the loss and grad-norm metrics averaged across the learner axes (one
  small all-reduce each).

On a mesh of size 1 every step of this is the unplaced step's, op for op:
no all-gather, no all-reduce, the same kernel launches
(``chip_smoke.py`` phase 19a and 19b hold that).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MAvgConfig
from repro_torch.comm.reducer import DenseReducer
from repro_torch.core.meta import MetaState, meta_step
from repro_torch.utils.tree import is_dtensor, tree_map


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


class GroupLabels:
    """Process group name -> the mesh axes the group spans ("data",
    "pod,data", ...), for ``jit_cost(groups=...)``. A group DTensor makes
    on its own (a flattened group for a redistribution over two axes) is
    resolved by its ranks: the axes along which their coordinates in the
    mesh differ."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.known = {}

    def get(self, name, default=None):
        if name not in self.known:
            self.known[name] = self._resolve(name) or default
        return self.known[name]

    def _resolve(self, name):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        try:
            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
        except (RuntimeError, ValueError, KeyError):
            return None
        grid = self.mesh.mesh
        coords = [(grid == r).nonzero()[0].tolist() for r in ranks
                  if bool((grid == r).any())]
        if not coords:
            return None
        names = self.mesh.mesh_dim_names
        return ",".join(n for i, n in enumerate(names)
                        if len({c[i] for c in coords}) > 1) or "self"


class Placement:
    """The mesh of a placed state and its learner axes: the process group
    that completes the learner mean, and the labels of the mesh's groups
    for the cost model (``GroupLabels``)."""

    def __init__(self, mesh, learner_axes):
        self.mesh = mesh
        self.learner_axes = tuple(learner_axes)
        names = tuple(mesh.mesh_dim_names)
        self.n_groups = _prod(mesh.size(names.index(a))
                              for a in self.learner_axes)
        self.labels = GroupLabels(mesh)
        self.learner_group = None
        if self.n_groups > 1:
            sub = mesh[self.learner_axes]
            if len(self.learner_axes) > 1:
                sub = sub._flatten()
            self.learner_group = sub.get_group(0)

    def all_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the learner groups (x itself when there
        is one group)."""
        if self.learner_group is None:
            return x
        import torch.distributed._functional_collectives as funcol

        out = funcol.all_reduce(x, "sum", self.learner_group)
        out = funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
            else out.wait()
        return out.mul_(1.0 / self.n_groups)


class GroupMeanReducer(DenseReducer):
    """The dense mean over a rank's learners, completed across the
    learner axes by one all-reduce of the local (rows_loc, 128) plane."""

    def __init__(self, meta_dtype: str, placement: Placement):
        super().__init__(meta_dtype)
        self.placement = placement

    def reduce(self, learners, gp, residual, *, step):
        avg, residual, metrics = super().reduce(learners, gp, residual,
                                                step=step)
        avg = tree_map(self.placement.all_mean_, avg)
        return avg, residual, metrics


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def local_state(state: MetaState) -> MetaState:
    """The MetaState of this rank's pieces (views, no copy)."""
    return dataclasses.replace(state, **{
        f: (None if getattr(state, f) is None
            else tree_map(_local, getattr(state, f)))
        for f in ("global_params", "momentum", "learners", "local_momentum",
                  "comm_residual")})


def _whole_rows(placements):
    """The learner stack's placements with its row dim (1) whole again."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in placements)


class RowGather:
    """The local phase's view of a learner stack whose rows are split:
    ``gather`` all-gathers the rows (a plain tensor of this rank's
    learners), ``scatter`` takes this rank's rows back into the state.
    With no split row dim both are the identity (the state's own local
    tensor, trained in place)."""

    def __init__(self, learners):
        self.dt = learners
        self.whole = _whole_rows(learners.placements)

    @property
    def split(self) -> bool:
        mesh = self.dt.device_mesh
        return any(p != w and mesh.size(i) > 1 for i, (p, w) in enumerate(
            zip(self.dt.placements, self.whole)))

    def gather(self, local):
        if not self.split:
            return local
        return self.dt.redistribute(self.dt.device_mesh,
                                    self.whole).to_local()

    def scatter(self, local, full):
        if full is local:
            return local
        from torch.distributed.tensor import DTensor

        whole = DTensor.from_local(full, self.dt.device_mesh, self.whole,
                                   run_check=False)
        local.copy_(whole.redistribute(self.dt.device_mesh,
                                       self.dt.placements).to_local())
        return local


def check_supported(cfg: MAvgConfig) -> None:
    if not cfg.packed or cfg.topology.kind != "flat" or \
            cfg.comm.scheme != "dense" or cfg.robust is not None or \
            cfg.finite_guard or cfg.algorithm == "mavg_mlocal":
        raise NotImplementedError(
            "the placed meta step runs the packed flat dense meta step (the "
            "dry run's and JAX's default); this config is "
            f"packed={cfg.packed}, topology={cfg.topology.kind}, "
            f"comm={cfg.comm.scheme}, algorithm={cfg.algorithm}")


def placed_meta_step(state: MetaState, batches, *, loss_fn, cfg: MAvgConfig,
                     placement: Placement, lr=None):
    """One meta step of this rank: ``state`` placed (DTensors), ``batches``
    (L, K, B_local, ...) DTensors split over the learner axes, or this
    rank's (L_loc, K, B_local, ...) pieces. Updates the state's pieces in
    place; returns (state, metrics), the metrics averaged over all
    learners."""
    check_supported(cfg)
    from repro_torch.topology import make_topology

    rows = RowGather(state.learners)
    loc = local_state(state)
    L_loc = loc.learners.shape[0]
    cfg_loc = dataclasses.replace(cfg, num_learners=L_loc)
    topology = make_topology(
        cfg_loc, GroupMeanReducer(cfg.meta_dtype, placement))
    new, metrics = meta_step(
        loc, {k: _local(v) for k, v in batches.items()}, loss_fn=loss_fn,
        cfg=cfg_loc, lr=lr, topology=topology,
        rows=(rows.gather, rows.scatter))
    for k in ("loss", "grad_norm"):
        metrics[k] = placement.all_mean_(metrics[k])
    return dataclasses.replace(state, step=new.step), metrics
