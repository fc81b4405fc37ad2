"""The M-AVG meta step of one rank of a mesh: the state placed by
``launch/specs.state_shardings`` as DTensors, the step run on this rank's
pieces through the port's own ``core/meta.py::meta_step``.

What one rank runs, for the packed flat dense meta step (the default
configuration, the one JAX's dry run lowers; ``mavg``, ``kavg``, ``sync``
and ``mavg_mlocal``, whose local-momentum plane is placed, gathered and
taken back as the learners' are):

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

Under ``tp_mode="fsdp"`` (JAX's dry run: a learner's local batch split
over 'model' where it divides) each rank of a learner's 'model' group
runs the local phase on its slice of the batch, and the gradient plane
and the loss are averaged over 'model' (one all-reduce each) before every
local SGD step, so each rank applies the learner's whole-batch step.

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


def _group_of(mesh, axes):
    """(the process group spanning ``axes`` of ``mesh``, its size), or
    (None, 1) when the axes hold one rank."""
    names = tuple(mesh.mesh_dim_names)
    n = _prod(mesh.size(names.index(a)) for a in axes)
    if n == 1:
        return None, 1
    sub = mesh[tuple(axes)]
    if len(axes) > 1:
        sub = sub._flatten()
    return sub.get_group(0), n


def _mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (one all-reduce; x itself when
    the group is None)."""
    if group is None:
        return x
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(x, "sum", group)
    out = funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
        else out.wait()
    return out.mul_(1.0 / n)


class Placement:
    """The mesh of a placed state and its learner axes: the process group
    that completes the learner mean, and the labels of the mesh's groups
    for the cost model (``GroupLabels``). ``batch_axis`` ('model' under
    ``tp_mode="fsdp"``, or None): the axis a learner's batch is split
    over, whose group averages the gradient in the local phase."""

    def __init__(self, mesh, learner_axes, batch_axis=None):
        self.mesh = mesh
        self.learner_axes = tuple(learner_axes)
        self.labels = GroupLabels(mesh)
        self.learner_group, self.n_groups = _group_of(mesh,
                                                      self.learner_axes)
        self.batch_group, self.n_batch = (
            _group_of(mesh, (batch_axis,)) if batch_axis else (None, 1))

    def all_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the learner groups (x itself when there
        is one group)."""
        return _mean_over(x, self.learner_group, self.n_groups)

    def grad_mean(self, loss, g):
        """The loss and, in place, the gradient plane ``g`` averaged over
        the ranks sharing a learner's batch (``core/meta.py::
        _local_phase``)."""
        if self.batch_group is None:
            return loss
        g.copy_(_mean_over(g, self.batch_group, self.n_batch))
        return _mean_over(loss, self.batch_group, self.n_batch)


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
    """The placed step runs the packed flat dense step of ``mavg``,
    ``kavg``, ``sync`` and ``mavg_mlocal``. Compressed comm and the
    hierarchical topology on a mesh, then per-leaf planes, gossip, the
    async server, robust aggregation and the finite guard, are ROADMAP
    Queue 1 item 14's steps 4 and 5."""
    off = [name for name, on in (
        ("per-leaf planes (packed=False)", not cfg.packed),
        (f"topology {cfg.topology.kind!r}", cfg.topology.kind != "flat"),
        (f"comm {cfg.comm.scheme!r}", cfg.comm.scheme != "dense"),
        ("robust aggregation", cfg.robust is not None),
        ("the finite guard", cfg.finite_guard),
        (f"algorithm {cfg.algorithm!r}",
         cfg.algorithm not in ("mavg", "kavg", "sync", "mavg_mlocal")))
        if on]
    if off:
        raise NotImplementedError(
            "the placed meta step runs the packed flat dense meta step; "
            f"{', '.join(off)} on a mesh: ROADMAP Queue 1 item 14, steps "
            "4-5")


def placed_meta_step(state: MetaState, batches, *, loss_fn, cfg: MAvgConfig,
                     placement: Placement, lr=None):
    """One meta step of this rank: ``state`` placed (DTensors), ``batches``
    (L, K, B_local, ...) DTensors split over the learner axes (and along
    B_local over the placement's batch axis), or this rank's pieces.
    Updates the state's pieces in place; returns (state, metrics), the
    metrics averaged over all learners."""
    check_supported(cfg)
    from repro_torch.topology import make_topology

    rows = RowGather(state.learners)
    mom_rows = (None if state.local_momentum is None
                else RowGather(state.local_momentum))

    def gather(learners, mom):
        return (rows.gather(learners),
                mom if mom_rows is None else mom_rows.gather(mom))

    def scatter(learners, mom, trained, trained_mom):
        return (rows.scatter(learners, trained),
                trained_mom if mom_rows is None
                else mom_rows.scatter(mom, trained_mom))

    loc = local_state(state)
    L_loc = loc.learners.shape[0]
    cfg_loc = dataclasses.replace(cfg, num_learners=L_loc)
    topology = make_topology(
        cfg_loc, GroupMeanReducer(cfg.meta_dtype, placement))
    new, metrics = meta_step(
        loc, {k: _local(v) for k, v in batches.items()}, loss_fn=loss_fn,
        cfg=cfg_loc, lr=lr, topology=topology, rows=(gather, scatter),
        grad_mean=(placement.grad_mean if placement.batch_group is not None
                   else None))
    for k in ("loss", "grad_norm"):
        metrics[k] = placement.all_mean_(metrics[k])
    return dataclasses.replace(state, step=new.step), metrics
