"""Sharding rules: parameter name -> placement spec (the JAX package's
``sharding/rules.py``), with the same preference lists.

A spec has one entry per dimension of the tensor: ``None`` (not split), a
mesh axis name, or a tuple of names (the dimension split over several
axes, major first). Rules are *negative-dim preference lists*, so they
apply unchanged to layer-stacked parameters (the stacked leading dims
stay whole). For each leaf the tensor-parallel (``model``) axis goes on
the first preferred dim whose size the axis divides; an optional FSDP
axis (``data`` inside a learner, hierarchical mode, serving the largest
configs) goes on a second dim.

Examples
--------
* ``wq (d_model, heads, head_dim)`` prefers heads (Megatron head-parallel);
  qwen2-7b's 28 heads do not divide an 8- or 16-way model axis, so it falls
  back to d_model (row-parallel, completed by an all-reduce).
* MoE ``w_in (E, d, 2, d_e)`` splits the expert dim: expert parallelism.
* xLSTM / mamba projections split the inner dim.

The rules read only the axis sizes of the mesh (as JAX's ``_axis_size``),
so ``mesh`` is a ``torch.distributed`` DeviceMesh with dim names or any
object whose ``.shape`` maps axis name to size. ``named`` turns specs into
DTensor placements on a DeviceMesh.
"""
from __future__ import annotations

from collections.abc import Mapping

# name -> preference list of negative dims for the model (TP) axis
PREFS: dict[str, tuple[int, ...]] = {
    # attention (d, h, hd) / (h, hd, d)
    "wq": (-2, -3),
    "wk": (-2, -3),
    "wv": (-2, -3),
    "wo": (-3, -1),
    "bq": (-2,),
    "bk": (-2,),
    "bv": (-2,),
    # mlp
    "wi": (-1, -3),
    # embeddings
    "embedding": (-2,),
    "head": (-1,),
    # moe
    "router": (-1,),
    "w_in": (-4,),
    "w_out": (-3,),
    # xlstm / mamba inner projections
    "w_up": (-1, -3),
    "w_down": (-2,),
    "w_xz": (-1, -3),
    "w_ssm_out": (-2,),
    "conv": (-1,),
    "w_bc": (-2,),
    "w_dt_down": (-2,),
    "w_dt_up": (-1,),
    "A_log": (-2,),
    "D": (-1,),
    "b_dt": (-1,),
    "w_i": (-2,),
    "w_f": (-2,),
    # sLSTM per-head recurrent + gates
    "r_i": (-1,),
    "r_f": (-1,),
    "r_z": (-1,),
    "r_o": (-1,),
    "w_z": (-1,),
    "w_o": (-1,),
    "b_i": (-1,),
    "b_f": (-1,),
    "b_z": (-1,),
    "b_o": (-1,),
}

# shared-mlp 'wo' (f, d) wants (-2,); attention 'wo' (h, hd, d) wants
# (-3, -1): told apart by rank in _prefs_for
REPLICATED = {"scale", "beta_attn", "beta_ssm", "meta", "patch_pos"}


class Spec(tuple):
    """A placement spec: one entry a dimension, each ``None``, a mesh axis
    name or a tuple of names (JAX's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a DeviceMesh (by its dim names) or of any
    object whose ``.shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    raise TypeError(f"{mesh!r} has no named axes")


def _prefs_for(name: str, ndim_base: int) -> tuple[int, ...]:
    if name == "wo" and ndim_base == 2:  # mlp down-proj (f, d)
        return (-2,)
    if name in ("w_i", "w_f") and ndim_base == 3:  # sLSTM gate (d, nh, hd)
        return (-1,)
    if name in ("b_i", "b_f") and ndim_base == 1:  # mLSTM gate bias (nh,)
        return ()
    return PREFS.get(name, ())


def _axis_size(shape: dict, axis) -> int:
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= shape[a]
        return out
    return shape[axis]


def leaf_spec(path, leaf, mesh, *, model_axis="model", fsdp_axis=None,
              stack_dims: int = 0) -> Spec:
    """The spec of one parameter leaf; ``path`` is its tuple of keys.

    stack_dims: number of leading scan/stack dims; dims a preference does
    not reach are never split, so layer stacking needs no special case.
    """
    shape = mesh_shape(mesh)
    name = str(path[-1])
    ndim = len(leaf.shape)
    spec = [None] * ndim
    if name in REPLICATED or ndim == 0:
        return Spec(*spec)
    used = set()
    prefs = _prefs_for(name, ndim - stack_dims)
    if model_axis is not None:
        msize = _axis_size(shape, model_axis)
        for neg in prefs:
            dim = ndim + neg
            if (0 <= dim < ndim and leaf.shape[dim] % msize == 0
                    and leaf.shape[dim] >= msize):
                spec[dim] = model_axis
                used.add(dim)
                break
    if fsdp_axis is not None:
        fsize = _axis_size(shape, fsdp_axis)
        # the FSDP axis goes on the first remaining preferred dim, else the
        # largest remaining divisible dim (skipping stacked leading dims)
        candidates = [ndim + n for n in prefs if (ndim + n) not in used]
        rest = [d for d in range(stack_dims, ndim)
                if d not in used and d not in candidates]
        rest.sort(key=lambda d: -leaf.shape[d])
        for dim in candidates + rest:
            if (0 <= dim < ndim and leaf.shape[dim] % fsize == 0
                    and leaf.shape[dim] >= fsize):
                spec[dim] = fsdp_axis
                break
    return Spec(*spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def make_param_specs(params, mesh, *, model_axis="model", fsdp_axis=None,
                     stack_dims_fn=None):
    """A tree of specs matching ``params`` (a dict tree of tensors, or of
    anything with ``.shape``)."""

    def f(path, leaf):
        sd = stack_dims_fn(path) if stack_dims_fn else _default_stack_dims(
            path)
        return leaf_spec(path, leaf, mesh, model_axis=model_axis,
                         fsdp_axis=fsdp_axis, stack_dims=sd)

    return _map_with_path(f, params)


def _default_stack_dims(path) -> int:
    for k in path:
        if k == "mlstm":
            return 2  # (groups, blocks-per-group, ...)
        if k in ("blocks", "dense_blocks", "slstm"):
            return 1
    return 0


def map_specs(fn, specs):
    """``fn`` on every spec of a tree (a dict, or one spec)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def add_learner_axis(specs, learner_axes):
    """Prepend the learner mesh axis to every spec (stacked learner
    copies)."""
    return map_specs(lambda s: Spec(learner_axes, *s), specs)


def placements(spec, mesh) -> tuple:
    """DTensor placements of one spec on a DeviceMesh: ``Shard(d)`` on each
    mesh dim the spec names for tensor dim ``d`` (a tuple of names splits
    dim ``d`` over those mesh dims, major first), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(ax)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {ax!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def named(specs, mesh):
    """A tree of specs -> the same tree of DTensor placement tuples on
    ``mesh`` (JAX's ``NamedSharding``s)."""
    return map_specs(lambda s: placements(s, mesh), specs)


def spec_shards(spec, mesh) -> int:
    """Into how many pieces ``spec`` splits a tensor on ``mesh`` (JAX's
    per-device argument bytes divide by this)."""
    shape = mesh_shape(mesh)
    n = 1
    for entry in spec:
        if entry is not None:
            n *= _axis_size(shape, entry)
    return n
