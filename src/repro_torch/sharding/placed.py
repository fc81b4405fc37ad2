"""The M-AVG meta step of one rank of a mesh: the state placed by
``launch/specs.state_shardings`` as DTensors, the step run on this rank's
pieces through the port's own ``core/meta.py::meta_step``, and every
metric the one-process value on every rank. Every algorithm, topology
and comm scheme runs placed, on the packed plane or on per-leaf planes.

What one rank runs:

* its L_loc = L / |learner axes| learners, learners ``off`` to
  ``off + L_loc - 1`` (the learner dim of the (L, rows, 128) stacks, or
  of each per-leaf leaf's (L, ...) stack, is split over the learner
  axes), and, where the packed plane's rows (or a leaf's dim, by the
  megatron leaf specs) are split over 'model', its piece of every plane
  (``RankView``);
* the local phase on the whole of each of its learners: where a plane's
  rows or a leaf are split over 'model', one all-gather over 'model'
  brings them in first (``RowGather``), the K local steps run on this
  rank's copy, and its pieces are taken back (no communication). JAX's
  GSPMD does the same: its dry run of the (4, 2) test mesh has no
  tensor-parallel collective in the packed step and charges each device
  one whole learner's flops (``tests/test_torch_dryrun.py`` holds the
  port to those flops). The payload corruptor (``chaos``, global learner
  indices) and the finite guard's flags work on those whole learners
  before the pieces are taken back; the flags are gathered over the
  learner axes, so every rank reads one verdict, and each rank resets
  its own learners that carry a NaN/Inf;
* the mix (``PlacedFlat``, ``PlacedHierarchical``, ``PlacedGossip``,
  ``PlacedAsync``):
  - flat, dense: the mean over its learners, completed across the learner
    axes by one all-reduce, then the fused momentum-broadcast kernel on
    the local planes; on per-leaf planes the mean of each leaf's pieces
    likewise, ``block_momentum`` on each leaf's pieces and the broadcast
    into the rank's learners;
  - flat, int8/int4 + error feedback: the one-process quantizer on the
    rank's pieces of the learners and the residual (``PieceQuant``):
    ``pack_update`` with the uniforms of its learners (the dither is keyed
    by learner), and the f64 sum of C(delta) over its learners completed
    by one all-reduce (exact sums: the mean is one process's bitwise).
    Where a chunk of ``chunk_rows`` would straddle two ranks' rows, on
    per-leaf planes (a leaf's chunks straddle its 'model' pieces: the
    one-process ``quantize``/``dequantize``), and for the schemes whose
    chunks or top-k span a learner's whole plane (fp8, topk, int8_topk),
    the stack and the residual are gathered whole and the one-process
    reducer runs on them (``PlacedReducer``);
  - flat, robust: the (L_loc, rows_loc, 128) stack is re-split from
    learners to rows over the learner axes (Shard(0) -> Shard(1)), the
    partial (L, L) Gram matrices of that layout, each formed and summed in
    f64, are summed by one all-reduce and rounded to f32 once, as one
    process rounds its f64 sum (every rank then clips the same learners
    and advances the same ring), ``robust_reduce`` runs on
    (L, rows_loc / n, 128) and one all-gather brings the rows back;
  - hierarchical with a dense inner level (static or elastic, dense or
    int8 outer): the (G, rows, 128) group stacks stay replicated, as JAX
    places them; a rank forms its groups' averages where it holds whole
    groups, or f32 partial sums where a group spans ranks, completed by
    one all-reduce of the (G, rows_loc, 128) partial over the learner
    axes and gathered over 'model'; the inner block momentum then runs on
    the whole group planes, the outer fused momentum-broadcast (an int8
    outer level as ``PieceQuant``) on the rank's rows of w~, v and the
    group planes, and the learners are reset from their rows;
  - gossip (ring, exponential, the stepped one_peer_exponential, elastic
    masking, momentum tracking; dense, or int8/int4 + EF where its chunks
    line up with the rank's rows): the ``params`` and ``momentum`` stacks
    are split like the learners, the EF residual is replicated (JAX's
    placement). The rank compresses its pieces (``pack_compress`` with its
    learners' uniforms, into its piece of the residual; the new residual
    is all-gathered into every rank's copy), all-gathers x + C(delta) over
    the learner axes (the rows stay split: the all-gather GSPMD compiles
    for JAX's dense contraction over L) and mixes only its own L_loc
    outputs (``neighbor_mix``'s output window, bitwise the rows of the
    square call); ``block_momentum`` and the momentum's mix likewise on
    its pieces; w~, the mean of the params, is one all-reduce;
  - the async server (mavg and elastic updates, so eamsgd; downpour;
    elastic membership; the robust clip of each anchor displacement):
    the clocks, ``pull_update`` and ``updates`` are host tensors every
    rank replays alike, the ``anchor`` stack is split like the learners.
    The decayed sum of the fired displacements is formed from the rank's
    learners in f64 windows (exact) and completed by one all-reduce a
    window, one process's bitwise; the update and the pulls run on the
    rank's pieces; the clip's Gram matrix as the flat robust mix's. The
    degenerate profile takes ``PlacedFlat``;
  - anything else (per-leaf planes under robust aggregation, in the
    hierarchical or gossip topologies or in a non-degenerate async
    server; gossip under robust aggregation or a compressor whose chunks
    straddle the rows; a hierarchical compressed inner level, robust
    aggregation, or a layout that neither holds nor splits groups
    evenly): the stack, the planes and the split topology buffers are
    gathered whole and the one-process mix runs on them
    (``GatheredMix``). JAX's placement replicates the hierarchical
    (G, S, rows, 128) inner EF residual, so every rank must end the inner
    level holding every learner's residual: gathering it moves as many
    bytes as gathering the learners, and the rank-pieces route would move
    the partial sums besides;
* the metrics: loss and grad-norm weighted by each rank's active local
  steps, loss_spread over every learner, norms and distances as the
  square root of the sums of squares over the axes their operands are
  split over (a per-leaf leaf replicated over 'model' counted once), the
  wire bytes of the global shapes, and the host numbers (staleness,
  fired counts, the spectral gap, present learners) as one process's.

Under ``tp_mode="fsdp"`` (JAX's dry run: a learner's local batch split
over 'model' where it divides) each rank of a learner's 'model' group
runs the local phase on its slice of the batch, and the gradient and the
loss are averaged over 'model' (one all-reduce each) before every local
SGD step, so each rank applies the learner's whole-batch step.

On a mesh of size 1 every step of this is the unplaced step's, op for op:
no all-gather, no all-reduce, the same kernel launches, the same dither
(``chip_smoke.py`` phases 19a and 19b hold that).

Why the pieces where they are used, and the gathered stack elsewhere:
``tests/test_torch_dryrun.py::
test_the_placed_mixes_move_and_hold_less_than_the_gathered_ones`` costs
both routes of each configuration at Qwen3-1.7B's full width on a fake
(4, 2) mesh, L = 8: the flat int8 mix and the dense-inner hierarchical
mixes on the pieces move and hold a fraction of what the gathered mix
does; under an int8 + EF inner level the gathered mix moves no more than
JAX's replicated inner residual alone. Dense gossip on the pieces moves
and holds half of the gathered mix or less; with int8 + EF and momentum
tracking it holds less but moves up to the replicated residual more (a
halo exchange of the neighbours' planes alone is ROADMAP's).

Memory: a rank's flat int8 mix holds its L_loc learners' uniforms (each
learner's whole plane: its rows are one draw) and the f64 sum of one
(rows_loc, 128) plane; its gossip mix the gathered (L, rows_loc, 128)
f32 stack. The gathered routes hold the whole (L, rows, 128) stack, its
residual and their uniforms on every rank, as does JAX's replicated
inner residual of the hierarchical topology and the gossip residual (L
f32 planes on every rank: at Qwen3-1.7B's full width, 6.9 GB a learner,
beyond an 80 GB card from L = 12; ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from fractions import Fraction

from repro_torch.comm.quant import SCALE_BYTES, VALUE_BYTES, QuantReducer
from repro_torch.comm.reducer import DenseReducer, ErrorFeedback, dense_bytes
from repro_torch.configs.base import MAvgConfig
from repro_torch.core.meta import (
    MetaState,
    _learner_finite_mask,
    _loss_spread,
    meta_step,
)
from repro_torch.kernels.quantize import QMAX, choose_block
from repro_torch.robust.aggregator import clip_rows, gram64
from repro_torch.topology.async_server import AsyncServer
from repro_torch.topology.base import (
    FlatAllReduce,
    Topology,
    block_momentum_update,
    consensus_dist,
    displacement_norm,
    fused_momentum_broadcast_update,
    stack_dist,
)
from repro_torch.topology.elastic import membership_at
from repro_torch.topology.gossip import Gossip
from repro_torch.topology.hierarchical import Hierarchical, _put, masked_mean
from repro_torch.utils.tree import (
    is_dtensor,
    sq_sum,
    tree_cast,
    tree_leaves,
    tree_map,
    tree_norm,
)


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


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced with ``op`` over ``group`` (one all-reduce)."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(x, op, group)
    return funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
        else out.wait()


def _mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (one all-reduce; x itself when
    the group is None)."""
    if group is None:
        return x
    return _all_reduce(x, "sum", group).mul_(1.0 / n)


def _sub_mesh(mesh, axes):
    """The 1-D mesh of this rank's ranks along ``axes`` (flattened when
    there are several), or None when they hold one rank."""
    names = tuple(mesh.mesh_dim_names)
    if _prod(mesh.size(names.index(a)) for a in axes) == 1:
        return None
    sub = mesh[tuple(axes)]
    return sub._flatten() if len(axes) > 1 else sub


def _stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _redistribute(local, mesh, src, dst, shape):
    """This rank's piece of the ``shape`` tensor laid out as ``src`` on
    ``mesh``, laid out as ``dst`` (a plain tensor: this rank's piece)."""
    from torch.distributed.tensor import DTensor

    dt = DTensor.from_local(local, mesh, src, run_check=False,
                            shape=tuple(shape), stride=_stride(shape))
    return dt.redistribute(mesh, dst).to_local()


def _whole(local, dt):
    """This rank's piece ``local`` of the placed tensor ``dt`` -> the whole
    tensor (one redistribution; ``local`` itself where it is whole)."""
    if tuple(local.shape) == tuple(dt.shape):
        return local
    from torch.distributed.tensor import Replicate

    return _redistribute(local.contiguous(), dt.device_mesh,
                         tuple(dt.placements),
                         tuple(Replicate() for _ in dt.placements),
                         tuple(dt.shape))


def _piece(whole, dt):
    """This rank's piece of ``whole``, laid out as the placed ``dt`` (a
    view; ``whole`` itself where the piece is whole)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, off = compute_local_shape_and_global_offset(
        dt.shape, dt.device_mesh, dt.placements)
    if tuple(shape) == tuple(whole.shape):
        return whole
    return whole[tuple(slice(o, o + n) for o, n in zip(off, shape))]


def _copy_back(piece, whole_piece):
    """``piece`` <- ``whole_piece`` in place, leaf by leaf, where they are
    not one storage already (None passes)."""
    if piece is None:
        return None

    def put(p, w):
        if p.data_ptr() != w.data_ptr() or p.shape != w.shape:
            p.copy_(w)
        return p

    return tree_map(put, piece, whole_piece)


def _split_beyond_learners(dt) -> bool:
    """Is a dim of ``dt`` other than the learner dim (0) split over a mesh
    dim of more than one rank?"""
    from torch.distributed.tensor import Shard

    mesh = dt.device_mesh
    return any(isinstance(p, Shard) and p.dim >= 1 and mesh.size(i) > 1
               for i, p in enumerate(dt.placements))


class Placement:
    """The mesh of a placed state and its learner axes: the process group
    that completes the learner mean, the groups the telemetry's sums run
    over ('model', every axis), and the labels of the mesh's groups for
    the cost model (``GroupLabels``). ``batch_axis`` ('model' under
    ``tp_mode="fsdp"``, or None): the axis a learner's batch is split
    over, whose group averages the gradient in the local phase."""

    def __init__(self, mesh, learner_axes, batch_axis=None):
        self.mesh = mesh
        self.learner_axes = tuple(learner_axes)
        self.labels = GroupLabels(mesh)
        self.learner_group, self.n_groups = _group_of(mesh,
                                                      self.learner_axes)
        self.learner_mesh = _sub_mesh(mesh, self.learner_axes)
        self.batch_group, self.n_batch = (
            _group_of(mesh, (batch_axis,)) if batch_axis else (None, 1))
        names = tuple(mesh.mesh_dim_names)
        self.model_group = (_group_of(mesh, ("model",))[0]
                            if "model" in names else None)
        self.all_group = _group_of(mesh, names)[0]

    def all_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the learner groups (x itself when there
        is one group)."""
        return _mean_over(x, self.learner_group, self.n_groups)

    def grad_mean(self, loss, g):
        """The loss and, in place, the gradient ``g`` (a plane, or a tree
        of per-leaf gradients) averaged over the ranks sharing a learner's
        batch (``core/meta.py::_local_phase``)."""
        if self.batch_group is None:
            return loss
        tree_map(lambda x: x.copy_(_mean_over(x, self.batch_group,
                                              self.n_batch)), g)
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


def host_topo(topo):
    """``topo`` with its host buffers (``topology.HOST_BUFFERS``: the
    membership schedule, the robust ring) as plain host tensors, as one
    process keeps them (placing a state puts every buffer on the mesh's
    device)."""
    from repro_torch.topology import HOST_BUFFERS

    if not isinstance(topo, dict):
        return topo
    return {k: (_local(v).cpu() if k in HOST_BUFFERS and v is not None
                else v) for k, v in topo.items()}


def local_state(state: MetaState) -> MetaState:
    """The MetaState of this rank's pieces (views, no copy; the host
    buffers on the host)."""
    topo = host_topo(state.topo)
    if isinstance(topo, dict):
        topo = {k: (None if v is None else tree_map(_local, v)) for k, v in
                topo.items()}
    return dataclasses.replace(state, topo=topo, **{
        f: (None if getattr(state, f) is None
            else tree_map(_local, getattr(state, f)))
        for f in ("global_params", "momentum", "learners", "local_momentum",
                  "comm_residual")})


def _placed_topo(old, new):
    """The placed state's ``topo`` after a step that returned ``new`` for
    its local buffers: a DTensor buffer keeps its place (``_rewrap``); a
    host buffer (``topology.HOST_BUFFERS``) is replaced by the step's host
    tensor, as in one process."""
    if not isinstance(old, dict) or not isinstance(new, dict):
        return new
    from repro_torch.topology import HOST_BUFFERS

    out = dict(new)
    for k, o in old.items():
        leaves = tree_leaves(o)
        if k not in HOST_BUFFERS and leaves and is_dtensor(leaves[0]):
            out[k] = _rewrap(o, new[k])
    return out


def _rewrap(old, new):
    """The placed state's field after a step that returned ``new`` for its
    local pieces: each DTensor keeps its place, and where the step made a
    new tensor (a per-leaf leaf's momentum update returns one) it is
    wrapped as that DTensor's new local tensor, with no copy."""
    if old is None or new is None:
        return old

    def one(dt, x):
        if not is_dtensor(dt) or x.data_ptr() == dt.to_local().data_ptr():
            return dt
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, dt.device_mesh, dt.placements,
                                  run_check=False, shape=dt.shape,
                                  stride=dt.stride())

    return tree_map(one, old, new)


def _whole_rows(placements):
    """A learner stack's placements with every dim but the learner dim
    (0) whole again: the packed plane's rows, a per-leaf leaf's split
    dim."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim >= 1 else p
                 for p in placements)


class RowGather:
    """The local phase's view of a learner stack (a packed (L, rows, 128)
    stack or a tree of per-leaf stacks) whose rows or leaf dims are split
    over 'model': ``gather`` all-gathers them (plain tensors of this
    rank's learners), ``scatter`` takes this rank's pieces back into the
    state. Where nothing is split both are the identity (the state's own
    local tensors, trained in place)."""

    def __init__(self, learners):
        self.dts = learners

    @property
    def split(self) -> bool:
        return any(_split_beyond_learners(dt)
                   for dt in tree_leaves(self.dts))

    def gather(self, local):
        if not self.split:
            return local

        def one(dt, x):
            if not _split_beyond_learners(dt):
                return x
            return dt.redistribute(dt.device_mesh,
                                   _whole_rows(dt.placements)).to_local()

        return tree_map(one, self.dts, local)

    def scatter(self, local, full):
        if full is local:
            return local
        from torch.distributed.tensor import DTensor

        def one(dt, x, f):
            if f is x:
                return x
            whole = DTensor.from_local(f, dt.device_mesh,
                                       _whole_rows(dt.placements),
                                       run_check=False)
            return x.copy_(whole.redistribute(dt.device_mesh,
                                              dt.placements).to_local())

        tree_map(one, self.dts, local, full)
        return local


# ---------------------------------------------------------------------------
# this rank's view of the placed stacks and planes
# ---------------------------------------------------------------------------


class RankView:
    """This rank's pieces of a placed state: learners ``off`` to ``off +
    L_loc - 1`` of L, and of the packed plane rows ``rs`` of ``rows`` (all
    of them unless the rows are split over 'model'), or of each per-leaf
    leaf the piece its spec gives; and the redistributions and sums that
    take a piece to the whole and a local metric to the global one. Every
    method is the identity where the mesh holds one rank."""

    def __init__(self, state: MetaState, placement: Placement):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        self.placement = placement
        self.packed = state.spec is not None
        # the placed tensors every piece is cut as: the learner stacks
        # (the residual and the local momentum are laid out alike), the
        # planes (w~, v) and the split topology buffers
        self.stack_tpl = state.learners
        self.plane_tpl = state.global_params
        self.topo_tpl = {k: v for k, v in (state.topo or {}).items()
                         if v is not None and is_dtensor(tree_leaves(v)[0])}
        dt = tree_leaves(state.learners)[0]
        self.mesh = dt.device_mesh
        shape, off = compute_local_shape_and_global_offset(
            dt.shape, self.mesh, dt.placements)
        self.L, self.L_loc, self.off = int(dt.shape[0]), int(shape[0]), \
            int(off[0])
        if self.L % placement.n_groups:
            raise ValueError(f"{self.L} learners do not split evenly over "
                             f"{placement.n_groups} learner ranks")
        names = tuple(self.mesh.mesh_dim_names)
        n_model = self.mesh.size(names.index("model")) if "model" in names \
            else 1
        if self.packed:
            self.rows, self.rows_loc = int(dt.shape[1]), int(shape[1])
            self.row_off = int(off[1])
            self.rs = slice(self.row_off, self.row_off + self.rows_loc)
            self.rows_split = self.rows_loc < self.rows
            rowdim = [isinstance(p, Shard) and p.dim == 1
                      for p in dt.placements]
            # (n, rows, 128) stacks replicated over the learner axes
            self.group_pl = tuple(Shard(1) if r else Replicate()
                                  for r in rowdim)
            self.whole_pl = tuple(Replicate() for _ in rowdim)
            model_split = self.rows_split
        else:
            # a leaf replicated over 'model' is counted in a sum by the
            # ranks of 'model' coordinate 0 alone
            mi = names.index("model") if "model" in names else None
            first = mi is None or self.mesh.get_coordinate()[mi] == 0
            self.counted = [first or (isinstance(x.placements[mi], Shard)
                                      and n_model > 1)
                            for x in tree_leaves(state.learners)]
            model_split = n_model > 1
        # the sums of a metric over the pieces of a stack and of a plane
        self.stack_group = (placement.all_group if model_split
                            else placement.learner_group)
        self.plane_group = placement.model_group if model_split else None
        self.trivial = placement.learner_group is None and not model_split
        # the whole learner stack's values over this rank's (wire bytes)
        self.scale = Fraction(
            sum(_prod(x.shape) for x in tree_leaves(state.learners)),
            sum(_prod(x.to_local().shape)
                for x in tree_leaves(state.learners)))

    # -- pieces and wholes ---------------------------------------------
    def whole_stack(self, x):
        """This rank's pieces of a stack placed as the learners (a tree of
        them per leaf) -> the whole (L, ...) stack."""
        return tree_map(_whole, x, self.stack_tpl)

    def whole_plane(self, x):
        """This rank's pieces of a plane placed as w~ -> the whole."""
        return tree_map(_whole, x, self.plane_tpl)

    def whole_topo(self, topo):
        """A ``topo`` dict with its split buffers whole."""
        if not isinstance(topo, dict):
            return topo
        return {k: (tree_map(_whole, v, self.topo_tpl[k])
                    if k in self.topo_tpl and v is not None else v)
                for k, v in topo.items()}

    def whole_groups(self, x):
        """This rank's rows of an (n, rows, 128) stack replicated over the
        learner axes -> (n, rows, 128)."""
        if not self.rows_split:
            return x
        return _redistribute(x.contiguous(), self.mesh, self.group_pl,
                             self.whole_pl, (x.shape[0], self.rows, 128))

    def gather_learners(self, x):
        """This rank's (L_loc, ...) piece of a stack placed as the
        learners -> every learner's (L, ...) at this rank's rows (one
        all-gather over the learner axes; x itself on one learner rank)."""
        from torch.distributed.tensor import Replicate, Shard

        lm = self.placement.learner_mesh
        if lm is None:
            return x
        return _redistribute(x.contiguous(), lm, (Shard(0),), (Replicate(),),
                             (self.L,) + tuple(x.shape[1:]))

    def stack_piece(self, whole):
        return tree_map(_piece, whole, self.stack_tpl)

    def plane_piece(self, whole):
        return tree_map(_piece, whole, self.plane_tpl)

    def learner_slice(self, xs):
        """This rank's entries of a per-learner list (None passes)."""
        return None if xs is None else xs[self.off:self.off + self.L_loc]

    # -- the robust re-split ---------------------------------------------
    def resplit(self, x):
        """(L_loc, R, 128) -> (L, R_part, 128): every learner's rows
        ``part_rows(R)`` (one redistribution over the learner axes; R need
        not divide evenly)."""
        from torch.distributed.tensor import Shard

        lm = self.placement.learner_mesh
        if lm is None:
            return x
        return _redistribute(x, lm, (Shard(0),), (Shard(1),),
                             (self.L,) + tuple(x.shape[1:]))

    def part_rows(self, R: int) -> slice:
        """The rows of an R-row piece this rank holds after ``resplit``."""
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        lm = self.placement.learner_mesh
        if lm is None:
            return slice(0, R)
        shape, off = compute_local_shape_and_global_offset(
            (self.L, R, 128), lm, (Shard(1),))
        return slice(off[1], off[1] + shape[1])

    def unsplit(self, y, R: int):
        """(R_part, 128) rows of ``part_rows(R)`` -> (R, 128) (one
        all-gather over the learner axes)."""
        from torch.distributed.tensor import Replicate, Shard

        lm = self.placement.learner_mesh
        if lm is None:
            return y
        return _redistribute(y, lm, (Shard(0),), (Replicate(),),
                             (R,) + tuple(y.shape[1:]))

    def gram(self, stack, anchor):
        """The (L, L) f32 Gram matrix of the re-split displacements on the
        host: this rank's f64 partial, summed over every rank (one
        all-reduce) and rounded to f32 once, as one process rounds its
        f64 sum (``robust/aggregator.py::gram``)."""
        G = gram64(stack, anchor)
        if self.stack_group is not None:
            G = _all_reduce(G, "sum", self.stack_group)
        G = G.to(torch.float32)
        return G if G.device.type == "meta" else G.cpu()

    # -- global metrics ----------------------------------------------------
    @staticmethod
    def _norm(x, group):
        if group is None:
            return x
        return torch.sqrt(_all_reduce(x * x, "sum", group))

    def stack_norm(self, x):
        """A norm of a packed stack's pieces -> the norm of the whole."""
        return self._norm(x, self.stack_group)

    def plane_norm(self, x):
        """A norm of a packed plane's rows -> the norm of the whole."""
        return self._norm(x, self.plane_group)

    def _leaf_norm(self, a, b, stacked: bool):
        """The norm of ``a`` (- ``b``) over every rank's pieces of per-leaf
        trees: each counted leaf's f64 sum of squares (``sq_sum``, of each
        learner apart where ``stacked``), summed over the ranks."""
        la = tree_leaves(a)
        lb = [None] * len(la) if b is None else tree_leaves(b)
        sq = []
        for x, y, on in zip(la, lb, self.counted):
            if not on:
                continue
            if stacked:
                sq += [sq_sum(x[j] if y is None else x[j] - y[j])
                       for j in range(x.shape[0])]
            else:
                sq.append(sq_sum(x if y is None else x - y))
        total = (torch.stack(sq).sum() if sq else
                 torch.zeros((), dtype=torch.float64, device=la[0].device))
        group = self.stack_group if stacked else self.plane_group
        if group is not None:
            total = _all_reduce(total, "sum", group)
        return torch.sqrt(total).to(torch.float32)

    def consensus(self, learners, avg):
        """``consensus_dist`` of the whole stack from its pieces."""
        if self.trivial or self.packed:
            return self.stack_norm(consensus_dist(learners, avg))
        return self._leaf_norm(learners, tree_map(
            lambda w, a: a.unsqueeze(0).expand(w.shape), learners, avg),
            stacked=True)

    def displacement(self, avg, gp):
        """``displacement_norm`` of the whole planes from their pieces."""
        if self.trivial or self.packed:
            return self.plane_norm(displacement_norm(avg, gp))
        return self._leaf_norm(avg, gp, stacked=False)

    def norm(self, x, stacked: bool):
        """``tree_norm`` of a whole stack (or plane) from its pieces."""
        if self.trivial or self.packed:
            return (self.stack_norm if stacked else self.plane_norm)(
                tree_norm(x))
        return self._leaf_norm(x, None, stacked)

    def global_bytes(self, metrics: dict) -> dict:
        """A reducer's wire metrics of this rank's pieces scaled to the
        whole stack (the wire is linear in the values and the chunks)."""
        out = dict(metrics)
        for k in ("comm_bytes", "comm_bytes_dense"):
            out[k] = float(Fraction(metrics[k]) * self.scale)
        if metrics.get("comm_compression", 1.0) != 1.0:
            out["comm_compression"] = (out["comm_bytes_dense"]
                                       / out["comm_bytes"])
        return out

    def loss_spread(self, loss_l, active):
        """max - min of the per-learner mean losses over every rank's
        active learners (0 when none is)."""
        group = self.placement.learner_group
        if group is None:
            return _loss_spread(loss_l, active)
        on = (torch.ones(loss_l.shape, dtype=torch.bool, device=loss_l.device)
              if active is None else active.to(loss_l.device))
        hi = torch.where(on, loss_l, float("-inf")).max()
        lo = torch.where(on, loss_l, float("inf")).min()
        ext = _all_reduce(torch.stack([hi, -lo]), "max", group)
        spread = ext[0] + ext[1]
        return torch.where(torch.isfinite(spread), spread,
                           torch.zeros((), dtype=spread.dtype,
                                       device=spread.device))

    def active_means(self, loss, gnorm, n_active: int):
        """The loss and grad-norm means over every rank's active local
        steps, from this rank's means over its ``n_active``."""
        group = self.placement.learner_group
        if group is None:
            return loss, gnorm
        n = torch.full((), float(n_active), dtype=loss.dtype,
                       device=loss.device)
        s = _all_reduce(torch.stack([loss * n, gnorm * n, n]), "sum", group)
        total = torch.clamp(s[2], min=1.0)
        return s[0] / total, s[1] / total

    def finite_flags(self, learners, local_mom):
        """The finite guard's flags of all L learners (``core/meta.py::
        _learner_finite_mask`` of each rank's whole learners, gathered
        over the learner axes), or None when the planes hold no float."""
        ok = _learner_finite_mask(learners)
        if local_mom is not None:
            mok = _learner_finite_mask(local_mom)
            if mok is not None:
                ok = mok if ok is None else [a and b for a, b in zip(ok, mok)]
        lm = self.placement.learner_mesh
        if ok is None or lm is None:
            return ok
        dev = tree_leaves(learners)[0].device
        if dev.type == "meta":  # costed: a clean step
            return [True] * self.L
        from torch.distributed.tensor import Replicate, Shard

        flags = _redistribute(torch.tensor(ok, dtype=torch.int32, device=dev),
                              lm, (Shard(0),), (Replicate(),), (self.L,))
        return [bool(f) for f in flags.tolist()]


def _base(reducer):
    return reducer.inner if isinstance(reducer, ErrorFeedback) else reducer


def _quant(reducer):
    """The packed-plane quantizer (int8/int4) of ``reducer``, or None."""
    b = _base(reducer)
    return b if isinstance(b, QuantReducer) and b.dtype in QMAX else None


def _aligned(reducer, view: RankView) -> bool:
    """Does ``reducer`` run on this rank's rows: dense, or a packed
    quantizer whose chunks never straddle two ranks' rows? (A per-leaf
    leaf's chunks straddle its 'model' pieces.)"""
    if isinstance(_base(reducer), DenseReducer):
        return True
    q = _quant(reducer)
    return q is not None and view.packed and view.rows_loc % choose_block(
        view.rows, q.chunk_rows) == 0


def _wire(reducer, lead: int, rows: int, elem: int) -> float:
    """The modeled wire bytes of ``reducer`` on a (lead, rows, 128) stack
    of ``elem``-byte values (``comm/reducer.py``, ``comm/quant.py``)."""
    q = _quant(reducer)
    if q is None:
        return float(lead * rows * 128 * elem)
    return (lead * rows * 128 * VALUE_BYTES[q.dtype]
            + lead * (rows // choose_block(rows, q.chunk_rows)) * SCALE_BYTES)


class PieceQuant(QuantReducer):
    """The packed quantizer ``q`` on this rank's pieces of a ``lead``-learner
    stack (its learners from ``lead_off`` on, its rows): the one-process
    code, with the uniforms of those learners alone (``comm/quant.py``
    keys each learner's plane; a source that cannot is drawn whole and
    sliced) and, given ``group``, the f64 learner sum completed by one
    all-reduce over it. The f64 sums are exact, so the mean is one
    process's bitwise, whatever the order of the ranks' additions."""

    def __init__(self, q: QuantReducer, view: RankView, lead: int,
                 lead_off: int, group=None):
        self.__dict__.update(vars(q))
        self.view, self.lead, self.lead_off = view, lead, lead_off
        self.group = group

    def _uniforms(self, step, shape, device):
        view, n, r = self.view, shape[0], shape[1]
        rest = tuple(shape[2:])
        pick = getattr(self.dither, "learners", None)
        if pick is not None:
            u, lo = pick(0, step, self.lead_off, (n, view.rows) + rest,
                         device), 0
        else:
            u, lo = self.dither(0, step, (self.lead, view.rows) + rest,
                                device), self.lead_off
        if tuple(u.shape[:2]) == (n, r):
            return u
        return u[lo:lo + n, view.row_off:view.row_off + r].clone()

    def _learner_sum(self, c):
        total, n = super()._learner_sum(c)
        if self.group is None:
            return total, n
        return _all_reduce(total, "sum", self.group), self.lead


def _on_pieces(reducer, view: RankView, lead: int, lead_off: int,
               group=None):
    """``reducer`` for this rank's pieces of a ``lead``-learner stack: a
    packed quantizer as ``PieceQuant`` (under its error feedback), any
    other reducer, or any on a mesh of one rank, as it is."""
    q = _quant(reducer)
    if q is None or view.trivial:
        return reducer
    piece = PieceQuant(q, view, lead, lead_off, group)
    return ErrorFeedback(piece) if isinstance(reducer, ErrorFeedback) \
        else piece


# ---------------------------------------------------------------------------
# the placed topologies
# ---------------------------------------------------------------------------


class PlacedReducer:
    """The flat mix's reducer on this rank's pieces: the dense mean
    completed over the learner axes (``GroupMeanReducer``); the packed
    int8/int4 quantizer on the rank's pieces (``PieceQuant``), its learner
    sum completed over the learner axes; any other scheme, or a chunk that
    straddles two ranks' rows, on the whole stack gathered (the
    one-process reducer; its residual's piece kept)."""

    def __init__(self, inner, view: RankView, meta_dtype: str):
        self.view = view
        self.dense = isinstance(_base(inner), DenseReducer)
        self.aligned = _aligned(inner, view)
        if self.dense:
            inner = GroupMeanReducer(meta_dtype, view.placement)
        elif self.aligned:
            inner = _on_pieces(inner, view, view.L, view.off,
                               view.placement.learner_group)
        self.inner = inner

    def reduce(self, learners, gp, residual, *, step):
        view = self.view
        if self.aligned:
            avg, residual, m = self.inner.reduce(learners, gp, residual,
                                                 step=step)
            m = view.global_bytes(m)
            if "comm_error_norm" in m:
                m["comm_error_norm"] = view.stack_norm(m["comm_error_norm"])
            return avg, residual, m
        whole_res = None if residual is None else view.whole_stack(residual)
        avg, new_res, m = self.inner.reduce(
            view.whole_stack(learners), view.whole_plane(gp), whole_res,
            step=step)
        if residual is not None:
            _copy_back(residual, view.stack_piece(new_res))
        return view.plane_piece(avg), residual, m


class PlacedFlat(FlatAllReduce):
    """``FlatAllReduce`` on this rank's pieces (see the module doc)."""

    def __init__(self, cfg: MAvgConfig, view: RankView):
        super().__init__(cfg)
        self.view = view
        self.reducer = PlacedReducer(self.reducer, view, cfg.meta_dtype)

    def _robust(self, learners, gp, topo):
        """The norm clip and the scores on every rank's displacements, the
        clip written into this rank's learners; returns (learners, the
        re-split stack (clipped too) or None, topo', metrics)."""
        view, robust = self.view, self.robust
        R = learners.shape[1]
        need = robust.has_clip or robust.cfg.score or robust.aggregates
        x = view.resplit(learners) if need else None
        anchor = None if x is None else gp[view.part_rows(R)].unsqueeze(0)
        scale, topo, metrics = robust.guard(
            learners if x is None else x, topo, anchor=anchor,
            gram_fn=view.gram)
        if robust.has_clip:
            clipped = robust._clipped(scale)
            clip_rows(learners, gp.unsqueeze(0), clipped, offset=view.off)
            if x is not None and x is not learners:
                clip_rows(x, anchor, clipped)
        return learners, x, topo, metrics

    def _consensus(self, learners, avg):
        return self.view.consensus(learners, avg)

    def _displacement(self, avg, gp):
        return self.view.displacement(avg, gp)

    def _v_norm(self, v):
        return self.view.norm(v, stacked=False)

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        view = self.view
        metrics = {}
        avg = x = None
        if self.robust is not None:
            learners, x, topo, rmetrics = self._robust(learners, gp, topo)
            metrics.update(rmetrics)
        if x is not None and self.robust.aggregates and self.reducer.dense:
            # the robust estimator in place of the mean: every learner's
            # value at each of this rank's re-split coordinates
            avg = view.unsplit(self.robust.aggregate(x), learners.shape[1])
            b = dense_bytes(learners)
            comm_metrics = view.global_bytes({
                "comm_bytes": b, "comm_bytes_dense": b,
                "comm_compression": 1.0})
        del x
        if avg is None:
            avg, comm_residual, comm_metrics = self.reducer.reduce(
                learners, gp, comm_residual, step=step)
        gp, v, learners = self._update(learners, gp, v, avg, metrics)
        metrics.update(comm_metrics)
        return gp, v, learners, comm_residual, topo, metrics


class GatheredMix(Topology):
    """Any topology's one-process mix on the whole stack: this rank's
    pieces of the learners, w~, v, the residual and the split topology
    buffers (gossip's params and momentum, the async anchors) are
    gathered, the ``inner`` topology mixes them as one process does
    (every rank the same), and each rank keeps its pieces. The other
    ``topo`` buffers are replicated already."""

    def __init__(self, inner: Topology, view: RankView):
        self.inner = inner
        self.view = view
        self.cfg = inner.cfg

    def local_steps(self, topo, step):
        return self.view.learner_slice(self.inner.local_steps(topo, step))

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        view = self.view
        W, gw, vw = (view.whole_stack(learners), view.whole_plane(gp),
                     view.whole_plane(v))
        R = None if comm_residual is None else view.whole_stack(
            comm_residual)
        gw, vw, W, R, wtopo, metrics = self.inner.mix(
            W, gw, vw, R, view.whole_topo(topo), step=step)
        _copy_back(learners, view.stack_piece(W))
        _copy_back(gp, view.plane_piece(gw))
        _copy_back(v, view.plane_piece(vw))
        if R is not None:
            _copy_back(comm_residual, view.stack_piece(R))
        if isinstance(wtopo, dict):
            wtopo = dict(wtopo)
            for k, tpl in view.topo_tpl.items():
                if wtopo.get(k) is not None:
                    wtopo[k] = _copy_back(topo[k], tree_map(
                        _piece, wtopo[k], tpl))
        return gp, v, learners, comm_residual, wtopo, metrics


class PlacedHierarchical(Hierarchical):
    """``Hierarchical`` with a dense inner level on this rank's pieces (see
    the module doc): the rank holds whole groups (``contained``: L_loc a
    multiple of S) or a part of one (``spanning``: S a multiple of
    L_loc)."""

    def __init__(self, cfg: MAvgConfig, view: RankView):
        super().__init__(cfg)
        self.view = view
        self.contained = view.L_loc % self.S == 0
        self.spanning = not self.contained and self.S % view.L_loc == 0
        # an int8 outer level draws the uniforms of this rank's rows of
        # the G group planes
        self.outer_reducer = _on_pieces(self.outer_reducer, view, self.G, 0)

    @property
    def supported(self) -> bool:
        """Does this rank's layout take the placed route (else
        ``GatheredMix``)? Not under robust aggregation, and not with a
        compressed inner level: JAX's placement replicates its (G, S,
        rows, 128) EF residual, and all-gathering it after every inner
        level moves more than the whole gathered mix
        (``tests/test_torch_dryrun.py::
        test_the_placed_mixes_move_and_hold_less_than_the_gathered_ones``)."""
        return (self.robust is None
                and isinstance(self.inner_reducer, DenseReducer)
                and (self.contained or self.spanning)
                and _aligned(self.outer_reducer, self.view))

    def local_steps(self, topo, step):
        return self.view.learner_slice(super().local_steps(topo, step))

    def _inner(self, learners, gp_rows, part, mask, present, step):
        """This rank's share of the inner averages on its rows, into
        ``part``: the means of its whole groups (the one-process code per
        group), or the f32 sum of its present learners of a group that
        spans ranks."""
        S, view = self.S, self.view
        if self.spanning:
            m = (torch.ones(view.L_loc) if mask is None else
                 mask.reshape(-1)[view.off:view.off + view.L_loc])
            keep = torch.nonzero(torch.as_tensor(m)).flatten().tolist()
            if keep:
                part[view.off // S] = torch.sum(
                    learners[keep].to(torch.float32), dim=0)
            return
        n, glo = view.L_loc // S, view.off // S
        grouped = learners.view((n, S) + tuple(learners.shape[1:]))
        for i in range(n):
            if mask is None:
                a, _, _ = self.inner_reducer.reduce(
                    grouped[i], gp_rows[glo + i], None, step=step)
            else:
                # the mean of the weights, as ``Hierarchical._inner_masked``
                a = masked_mean(grouped[i], mask[glo + i], present[glo + i])
            _put(part, glo + i, a)
            del a

    def mix(self, learners, gp, v, comm_residual, topo, *, step):
        cfg, view = self.cfg, self.view
        G, S = self.G, self.S
        meta_dt = getattr(torch, cfg.meta_dtype)
        gparams = topo["group_params"]
        gmom = topo["group_momentum"]
        gp_rows = gparams[:, view.rs]
        mask = present = None
        if self.elastic is not None:
            mask = membership_at(topo["membership"], step).reshape(G, S)
            present = [float(mask[g].sum()) for g in range(G)]
            assert min(present) > 0, present

        # ---- inner level: each group's average on this rank's rows -----
        group = view.placement.learner_group
        part = (torch.empty if group is None else torch.zeros)(
            gp_rows.shape, dtype=meta_dt, device=gp.device)
        self._inner(learners, gp_rows, part, mask, present, step)
        if group is not None:
            part = _all_reduce(part, "sum", group)
        if self.spanning:
            ldt = learners.dtype
            for g in range(G):
                n = float(S) if mask is None else present[g]
                a = part[g].div_(torch.full((), n, dtype=torch.float32,
                                            device=part.device))
                if mask is None:  # the mean in the learner dtype
                    a.copy_(a.to(ldt))
        avg = view.whole_groups(part)
        inner_disp = stack_dist(avg, gparams)
        gparams, gmom = block_momentum_update(
            gparams, gmom, avg, mu=self.mu_in, eta=cfg.meta_lr,
            nesterov=cfg.nesterov)
        del avg, part

        # ---- outer level on this rank's rows, every H meta steps -------
        fire = (int(step) + 1) % self.H == 0
        outer_res = topo["outer_residual"]
        if fire:
            g_rows = gparams[:, view.rs]
            work_g = g_rows if g_rows.is_contiguous() else g_rows.contiguous()
            o_rows = None if outer_res is None else outer_res[:, view.rs]
            work_o = (o_rows if o_rows is None or o_rows.is_contiguous()
                      else o_rows.contiguous())
            A, work_o2, _ = self.outer_reducer.reduce(work_g, gp, work_o,
                                                      step=step)
            A = tree_cast(A, meta_dt)
            gp, v, work_g = fused_momentum_broadcast_update(
                gp, v, A, work_g, mu=self.mu_out, eta=1.0, nesterov=False)
            del A
            if view.rows_split:
                gparams.copy_(view.whole_groups(work_g))
                if outer_res is not None:
                    outer_res.copy_(view.whole_groups(work_o2))
            elif outer_res is not None and work_o2 is not outer_res:
                outer_res.copy_(work_o2)

        # ---- reset learners to their group's rows ----------------------
        if self.contained:
            n, glo = view.L_loc // S, view.off // S
            grouped = learners.view((n, S) + tuple(learners.shape[1:]))
            grouped.copy_(gparams[glo:glo + n, view.rs].unsqueeze(1)
                          .expand_as(grouped))
        else:
            learners.copy_(gparams[view.off // S, view.rs].unsqueeze(0)
                           .expand_as(learners))

        topo = dict(topo, group_params=gparams, group_momentum=gmom,
                    outer_residual=outer_res)
        metrics = {
            "v_norm": view.plane_norm(tree_norm(v)),
            "group_v_norm": tree_norm(gmom),
            "displacement_norm": inner_disp,
            "consensus_dist": consensus_dist(gparams, tree_map(
                lambda x: torch.mean(x, dim=0), gparams)),
            "outer_fired": float(fire),
        }
        metrics.update(self._bytes(learners.element_size(),
                                   gparams.element_size(), present, fire))
        if present is not None:
            metrics["present_count"] = float(sum(present))
        return gp, v, learners, comm_residual, topo, metrics

    def _bytes(self, l_elem: int, m_elem: int, present, fire) -> dict:
        """The wire metrics of the whole mix, from the global shapes, in
        the one-process mix's order of operations."""
        G, S, rows = self.G, self.S, self.view.rows
        intra = dense = 0.0
        if present is None:
            for _ in range(G):
                intra += _wire(self.inner_reducer, S, rows, l_elem)
                dense += float(S * rows * 128 * l_elem)
        else:
            wire_sum = 0.0
            for g in range(G):
                wire_sum += _wire(self.inner_reducer, S, rows,
                                  l_elem) * present[g]
            intra = wire_sum / S
            dense = (float(G * S * rows * 128 * l_elem) / G) * sum(
                present) / S
        outer = outer_dense = 0.0
        if fire:
            outer = _wire(self.outer_reducer, G, rows, m_elem)
            outer_dense = float(G * rows * 128 * m_elem)
        total, total_dense = intra + outer, dense + outer_dense
        return {
            "comm_bytes_intra": intra,
            "comm_bytes_inter": outer,
            "comm_bytes": total,
            "comm_bytes_dense": total_dense,
            "comm_compression": (total_dense / max(total, 1.0)
                                 if total > 0 else 1.0),
        }


class PlacedGossip(Gossip):
    """``Gossip`` on this rank's pieces (see the module doc): its learners'
    rows of the split ``params`` and ``momentum`` stacks, its piece of the
    replicated residual, and the exchange of its own outputs from the
    stack gathered over the learner axes (``neighbor_mix``'s window)."""

    def __init__(self, cfg: MAvgConfig, view: RankView):
        super().__init__(cfg)
        self.view = view
        self._piece_reducer = _on_pieces(self.reducer, view, view.L, view.off)

    @property
    def supported(self) -> bool:
        """The packed plane, no robust clip (its Gram matrix spans every
        learner: the gathered mix), and a dense exchange or a packed
        quantizer whose chunks line up with the rank's rows."""
        return (self.view.packed and self.robust is None
                and _aligned(self.reducer, self.view))

    def local_steps(self, topo, step):
        return self.view.learner_slice(super().local_steps(topo, step))

    def _first_learner(self) -> int:
        return self.view.off

    @property
    def _compressor(self):
        return self._piece_reducer

    def _residual_piece(self, res):
        if res is None:
            return None
        piece = self.view.stack_piece(res)
        return piece if piece.is_contiguous() else piece.contiguous()

    def _residual_whole(self, res, piece):
        # the residual is replicated (JAX's placement): every rank takes
        # every rank's new pieces (one all-gather)
        if res is None or self.view.trivial:
            return piece
        return res.copy_(self.view.whole_stack(piece))

    def _gathered(self, x):
        view = self.view
        whole = view.gather_learners(x)
        return whole, (None if whole is x else (view.off, view.L_loc))

    def _stack_norm(self, x):
        return self.view.stack_norm(x)

    def _mean_into(self, gp, xp):
        group = self.view.placement.learner_group
        if group is None:
            return super()._mean_into(gp, xp)
        total = _all_reduce(torch.sum(xp, dim=0), "sum", group)
        return gp.copy_(total.div_(self.view.L))

    def _wire_bytes(self, wire, learners):
        view, elem = self.view, learners.element_size()
        return (_wire(self.reducer, view.L, view.rows, elem),
                float(view.L * view.rows * 128 * elem))


class PlacedAsync(AsyncServer):
    """``AsyncServer`` on this rank's pieces (see the module doc): the
    degenerate case as ``PlacedFlat``; otherwise the host clocks replayed
    on every rank, the rank's learners' share of each f64 window of the
    decayed displacement sum completed by one all-reduce, the update and
    the pulls on its pieces of w~, v, the learners and their anchors."""

    def __init__(self, cfg: MAvgConfig, view: RankView):
        super().__init__(cfg)
        self.view = view
        self._flat = PlacedFlat(cfg, view)

    @property
    def supported(self) -> bool:
        """The degenerate case (``PlacedFlat``), or the packed plane (its
        telemetry sums and the clip's re-split are a packed stack's)."""
        return self.degenerate or self.view.packed

    def local_steps(self, topo, step):
        return self.view.learner_slice(super().local_steps(topo, step))

    def _first_learner(self) -> int:
        return self.view.off

    def _complete_sum(self, a64):
        group = self.view.placement.learner_group
        return a64 if group is None else _all_reduce(a64, "sum", group)

    def _stack_norm(self, x):
        return self.view.stack_norm(x)

    def _plane_norm(self, x):
        return self.view.plane_norm(x)

    def _plane_sum(self, sq):
        group = self.view.plane_group
        return sq if group is None else _all_reduce(sq, "sum", group)

    def _dense_bytes(self, learners) -> float:
        return float(Fraction(dense_bytes(learners)) * self.view.scale)

    def _guard(self, learners, topo, base):
        """The scores and clip factors of every learner's displacement
        from its base: the stack and the anchors re-split from learners
        to rows (as ``PlacedFlat._robust``), the partial Gram matrices
        summed over every rank."""
        view = self.view
        x = view.resplit(learners)
        R = learners.shape[1]
        a = (view.resplit(base) if base.shape[0] == learners.shape[0]
             else base[:, view.part_rows(R)])
        return self.robust.guard(x, topo, anchor=a, gram_fn=view.gram)


def placed_topology(cfg: MAvgConfig, view: RankView) -> Topology:
    """The topology of ``cfg`` on this rank's pieces, or the one-process
    mix on the gathered stack (``GatheredMix``) where no placed route
    takes it."""
    kind = cfg.topology.kind
    if kind == "async" or cfg.algorithm in ("eamsgd", "downpour"):
        a = PlacedAsync(cfg, view)
        return a if a.supported else GatheredMix(AsyncServer(cfg), view)
    if kind == "flat":
        if view.packed or cfg.robust is None:
            return PlacedFlat(cfg, view)
        return GatheredMix(FlatAllReduce(cfg), view)
    if kind == "gossip":
        g = PlacedGossip(cfg, view)
        return g if g.supported else GatheredMix(Gossip(cfg), view)
    h = PlacedHierarchical(cfg, view) if view.packed else None
    return h if h is not None and h.supported else GatheredMix(
        Hierarchical(cfg), view)


def _local_cfg(cfg: MAvgConfig, L_loc: int) -> MAvgConfig:
    """What ``meta_step``'s local phase reads of ``cfg`` for this rank's
    L_loc learners; the mix, the guard and the corruptor are the placed
    step's (the config's checks of the topology, the groups and the trim
    against the learner count hold for the whole mesh, not a rank)."""
    from repro_torch.configs.base import TopologyConfig

    return dataclasses.replace(cfg, num_learners=L_loc, finite_guard=False,
                               robust=None, topology=TopologyConfig())


def placed_meta_step(state: MetaState, batches, *, loss_fn, cfg: MAvgConfig,
                     placement: Placement, lr=None, chaos=None):
    """One meta step of this rank: ``state`` placed (DTensors), ``batches``
    (L, K, B_local, ...) DTensors split over the learner axes (and along
    B_local over the placement's batch axis), or this rank's pieces.
    ``chaos``: the payload corruptor (``chaos.PayloadCorruptor``) or None.
    Updates the state's pieces in place; returns (state, metrics), every
    metric the one-process value (see the module doc)."""
    view = RankView(state, placement)
    rows = RowGather(state.learners)
    mom_rows = (None if state.local_momentum is None
                else RowGather(state.local_momentum))
    loc = local_state(state)
    topology = placed_topology(cfg, view)
    steps = topology.local_steps(loc.topo, loc.step)
    n_active = (view.L_loc * cfg.k_steps if steps is None
                else int(sum(steps)))
    guard = {}

    def gather(learners, mom):
        return (rows.gather(learners),
                mom if mom_rows is None else mom_rows.gather(mom))

    def scatter(learners, mom, trained, trained_mom):
        # the corruptor and the guard's flags on the whole learners, as in
        # one process (core/meta.py), before this rank's rows go back
        ok = None
        with torch.no_grad():
            if chaos is not None:
                with torch.profiler.record_function("chaos.payload"):
                    trained = chaos(trained, loc.step, offset=view.off)
            if cfg.finite_guard:
                with torch.profiler.record_function("chaos.finite_guard"):
                    ok = view.finite_flags(trained, trained_mom)
            learners = rows.scatter(learners, trained)
            if mom_rows is not None:
                mom = mom_rows.scatter(mom, trained_mom)
            else:
                mom = trained_mom
            if ok is not None:
                for j in range(view.L_loc):
                    if not ok[view.off + j]:
                        tree_map(lambda w, g: w[j].copy_(g), learners,
                                 loc.global_params)
                        if mom is not None:
                            tree_map(lambda m: m[j].zero_(), mom)
                guard["ok"] = ok
        return learners, mom

    new, metrics = meta_step(
        loc, {k: _local(v) for k, v in batches.items()}, loss_fn=loss_fn,
        cfg=_local_cfg(cfg, view.L_loc), lr=lr, topology=topology,
        rows=(gather, scatter),
        grad_mean=(placement.grad_mean if placement.batch_group is not None
                   else None), spread=view.loss_spread)
    metrics["loss"], metrics["grad_norm"] = view.active_means(
        metrics["loss"], metrics["grad_norm"], n_active)
    if "ok" in guard:
        metrics["nonfinite_learners"] = torch.tensor(
            float(view.L - sum(guard["ok"])), dtype=torch.float32)
    return dataclasses.replace(state, step=new.step,
                               topo=_placed_topo(state.topo, new.topo), **{
        f: _rewrap(getattr(state, f), getattr(new, f))
        for f in ("global_params", "momentum", "learners", "local_momentum",
                  "comm_residual")}), metrics


def placed_phases(loss_fn, cfg: MAvgConfig, placement: Placement):
    """The placed step's three attribution phases for ``obs.profile_phases``
    (``phases=``): the whole step, the local phase (this rank's learners
    gathered, trained and taken back) and the mix, each of a placed state
    and placed batches."""
    from repro_torch.core.meta import _local_phase
    from repro_torch.kernels.planes import f32

    def whole_step(s, b, lr):
        return placed_meta_step(s, b, loss_fn=loss_fn, cfg=cfg,
                                placement=placement, lr=lr)

    def local_phase(s, b, lr):
        view = RankView(s, placement)
        loc = local_state(s)
        rows = RowGather(s.learners)
        mom_rows = (None if s.local_momentum is None
                    else RowGather(s.local_momentum))
        mom = (loc.local_momentum if mom_rows is None
               else mom_rows.gather(loc.local_momentum))
        out = _local_phase(
            loss_fn, rows.gather(loc.learners), mom,
            {k: _local(v) for k, v in b.items()},
            _local_cfg(cfg, view.L_loc), f32(lr),
            spec=s.spec, steps=placed_topology(cfg, view).local_steps(
                loc.topo, loc.step),
            grad_mean=(placement.grad_mean if placement.batch_group
                       is not None else None))
        rows.scatter(loc.learners, out[0])
        if mom_rows is not None:
            mom_rows.scatter(loc.local_momentum, out[1])
        return out

    def meta_mix(s):
        view = RankView(s, placement)
        loc = local_state(s)
        with torch.no_grad():
            return placed_topology(cfg, view).mix(
                loc.learners, loc.global_params, loc.momentum,
                loc.comm_residual, loc.topo, step=loc.step)

    return whole_step, local_phase, meta_mix
