"""The cost of one call of a function, counted on the meta device: the
port's counterpart of the JAX package's ``roofline/hlo_cost.py``
(``jit_cost`` at ``:392``, ``JitCost`` at ``:362``).

JAX lowers and compiles the function on abstract arguments and walks the
optimized HLO. The port runs eagerly, so ``jit_cost`` runs the function
once on ``meta``-device copies of its tensor arguments under one
``TorchDispatchMode`` that sees every ATen op: nothing is allocated or
computed, so a full-scale config (llama3-405b) costs nothing, and the
caller's tensors are never touched. It counts:

* **FLOPs**: the dot and convolution rule of JAX's walk, through the
  registry of ``torch.utils.flop_counter`` (mm, addmm, bmm, baddbmm,
  convolution, the SDPA kernels), plus the tensor-core flops a kernel of
  the port declares (flash attention's visible pairs). An op outside the
  registry is first decomposed where it can be, as ``FlopCounterMode``
  does, so the count equals that mode's.
* **HBM bytes**: JAX's per-instruction model on every ATen op: result
  bytes plus operand bytes. An op whose result is a pure view of an input
  (a schema alias without ``!``, or a result on an input's storage from a
  non-mutating op) moves nothing, as JAX skips bitcast and
  get-tuple-element. Gathers (``index_select``, ``gather``,
  ``index.Tensor``, ``embedding``, slice copies) cost twice the result,
  indexed writes (``index_put_``, ``index_copy_``, ``slice_scatter``)
  twice the update and scatters (``scatter``, ``scatter_add``,
  ``index_add``) three times it (``_instr_bytes``, ``:177-201``). A
  kernel of the port, a ctypes launch no dispatch mode sees, charges its
  declared cost through its meta route (``kernels/cost.py``): its inputs
  read once and its outputs written once, as JAX charges a
  ``pallas_call``.

  This is the eager, unfused count: what ATen moves op by op. XLA's
  count assumes perfect fusion (fused intermediates never touch HBM), so
  the two packages' byte counts are not comparable, and byte parity with
  JAX is not a goal. FLOPs are comparable and held to JAX's in the tests.
* **Memory**: every meta storage is followed from its allocation to its
  release (a weakref finaliser), so ``temp_bytes`` is the peak of what
  the call allocates beyond its outputs. An argument the call writes in
  place (an ATen op's ``!`` argument, or listed in ``in_place``) is an
  output aliased onto an input, the counterpart of donation:
  ``alias_bytes``.

``kernel_calls`` counts the kernel calls by name (the names of
``kernels.ops.launch_counts``). ``aten::bincount`` has no meta kernel; on
meta with ``minlength`` it gives its ``(minlength,)`` result here.

**One device of a mesh** (the dry run, ``launch/dryrun_lib.py``): an
argument may be a DTensor (``torch.distributed.tensor``). The counter
then sees what one rank runs: for an op with a DTensor argument it
returns ``NotImplemented``, as ``CommDebugMode`` does, so DTensor lowers
the op into the local ops of this rank's pieces and the
``_c10d_functional`` collectives of its redistributions, and those come
back through the counter. Only local ops are counted, and a DTensor
argument's bytes are those of its local piece. Every collective adds its
result bytes (JAX's rule, ``roofline/hlo.py:95-136``) under its type
(JAX's names: ``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``; ``broadcast``) and under the
mesh axes its group spans (``groups`` names them). The port runs
eagerly, so every layer and local step is counted as it runs: no trip
counts are needed.

Only ops on the device count: an op with no meta tensor among its
arguments and results runs on the host and is not counted.

A host read (``.tolist()``, ``bool(t)``) of a meta tensor raises, as an
abstract value does under ``jax.jit``. The finite guard and the robust
clip, which read a mask or clip factors once a step on a real device,
take a clean step on meta instead (every learner finite, none clipped:
``core/meta.py::_learner_finite_mask``, ``robust/aggregator.py``), with
their passes over the planes counted. The host-side buffers a step
reads on purpose (membership schedules, the async clocks, the clip's
ring), which the caller names in ``host``, are cloned on their own
device instead of moved to meta.

Remat (``torch.utils.checkpoint``) is counted as it runs: the recomputed
forward in the backward pass, up to the checkpoint's early stop (the
last saved input recomputed), as XLA counts the recompute it keeps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as _kcost

aten = torch.ops.aten

# ops that allocate without moving a byte
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided}
# (factor, argument holding the update, or None for the result):
# JAX's dynamic-slice / gather, dynamic-update-slice and scatter rules
_SLICING = {
    aten.index_select: (2.0, None),
    aten.gather: (2.0, None),
    aten.index: (2.0, None),
    aten.embedding: (2.0, None),
    aten.slice_copy: (2.0, None),
    aten.narrow_copy: (2.0, None),
    aten.index_put: (2.0, "values"),
    aten.index_put_: (2.0, "values"),
    aten._index_put_impl_: (2.0, "values"),
    aten.index_copy: (2.0, "source"),
    aten.index_copy_: (2.0, "source"),
    aten.slice_scatter: (2.0, "src"),
    aten.select_scatter: (2.0, "src"),
    aten.scatter: (3.0, "src"),
    aten.scatter_: (3.0, "src"),
    aten.scatter_add: (3.0, "src"),
    aten.scatter_add_: (3.0, "src"),
    aten.scatter_reduce: (3.0, "src"),
    aten.scatter_reduce_: (3.0, "src"),
    aten.index_add: (3.0, "source"),
    aten.index_add_: (3.0, "source"),
}


# ``_c10d_functional`` collectives -> JAX's collective names
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "send": "collective-permute",
    "recv": "collective-permute",
}


def _collective(func):
    """JAX's name of a functional collective, or None for another op."""
    if func.namespace not in ("_c10d_functional",
                              "_c10d_functional_autograd"):
        return None
    return COLLECTIVES.get(func._overloadpacket.__name__)


_DTENSOR: list = []  # [DTensor class or None], imported at first use


def _is_dtensor_type(t) -> bool:
    if not _DTENSOR:
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:  # a build without torch.distributed
            DTensor = None
        _DTENSOR.append(DTensor)
    return _DTENSOR[0] is not None and issubclass(t, _DTENSOR[0])


@dataclass
class JitCost:
    """The cost of one call of a function (JAX's fields, plus
    ``kernel_calls`` and the collectives).

    hbm_bytes        bytes the call moves (the eager model above)
    flops            matmul and convolution flops (JAX's dot/conv rule)
    arg_bytes        bytes of the tensor arguments' storages on the device
    out_bytes        bytes of the outputs: the returned tensors' storages
                     and the arguments written in place
    alias_bytes      bytes of outputs that are arguments' storages (the
                     in-place state update, JAX's donation)
    temp_bytes       peak bytes allocated by the call beyond its outputs
    kernel_calls     calls of the port's kernels, by name
    collective_bytes result bytes of every collective (0 on one device)
    collectives_by_type  the same, by JAX's collective name
    collectives_by_axes  the same, by the mesh axes a group spans
                     ("data", "pod,data", ...; the group name if unknown)
    collective_calls number of collective calls
    peak_state_bytes arg + out + temp - alias
    """

    hbm_bytes: float
    flops: float
    arg_bytes: int
    out_bytes: int
    alias_bytes: int
    temp_bytes: int
    kernel_calls: dict = field(default_factory=dict)
    collective_bytes: float = 0.0
    collectives_by_type: dict = field(default_factory=dict)
    collectives_by_axes: dict = field(default_factory=dict)
    collective_calls: int = 0

    @property
    def peak_state_bytes(self) -> int:
        return (self.arg_bytes + self.out_bytes + self.temp_bytes
                - self.alias_bytes)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(x) -> list:
    """The tensors of a tensor / dataclass / dict / list / tuple tree (a
    DTensor's local piece in its place)."""
    if isinstance(x, torch.Tensor):
        if _is_dtensor_type(type(x)):
            return [x._local_tensor]
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _map(fn, x):
    """``fn`` on every tensor of a tree, the tree rebuilt around it."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changed = {}
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            m = _map(fn, v)
            if m is not v:
                changed[f.name] = m
        return dataclasses.replace(x, **changed) if changed else x
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _bytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts flops, bytes, kernel calls and live meta storages of the ATen
    ops run under it."""

    def __init__(self, args: dict, groups: dict | None = None):
        super().__init__()
        self.args = args  # storage key -> bytes, the arguments on meta
        self.groups = groups or {}  # process group name -> mesh axes
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.kernel_calls = Counter()
        self.coll_by_type = Counter()
        self.coll_by_axes = Counter()
        self.coll_calls = 0
        self.written: set = set()  # argument storages written in place
        self.new: dict = {}  # storage key -> bytes, allocated by the call
        self.live = 0
        self.peak = 0
        self._uncounted = 0  # depth of plain-version runs for the meta route

    @contextlib.contextmanager
    def uncounted(self):
        """The ATen ops of the block are not counted (a plain version run
        for a kernel's output shapes); writes to arguments still are."""
        self._uncounted += 1
        try:
            yield
        finally:
            self._uncounted -= 1

    # -- live storages ---------------------------------------------------

    def _freed(self, key: int, nb: int) -> None:
        if self.new.pop(key, None) is not None:
            self.live -= nb

    def track(self, t: torch.Tensor) -> None:
        """Follow ``t``'s storage if the call allocated it just now."""
        if t.device.type != "meta":
            return
        key = _key(t)
        if key in self.args or key in self.new:
            return
        storage = t.untyped_storage()
        nb = storage.nbytes()
        self.new[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._freed, key, nb)

    # -- the meta route of the port's kernels ------------------------------

    def charge(self, cost: _kcost.KernelCost, out) -> None:
        self.kernel_calls[cost.name] += 1
        self.hbm_bytes += cost.nbytes
        self.flops += cost.matmul_flops
        for t in _tensors(out):
            key = _key(t) if t.device.type == "meta" else None
            if key in self.args:
                self.written.add(key)
            else:
                self.track(t)

    # -- ATen ops ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # DTensor lowers the op into this rank's local ops and its
            # collectives, which come back here
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's shape propagation: no op of the program
            return func(*args, **kwargs)
        if func is aten.bincount.default and args[0].device.type == "meta":
            out = self._bincount(*args, **kwargs)
        elif self._uncounted:
            out = func(*args, **kwargs)
            self._note_writes(func, args, kwargs)
            return out
        else:
            if func is not torch.ops.prim.device.default:
                # as FlopCounterMode: an op with a decomposition is counted
                # through it
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
        if not any(t.device.type == "meta" for t in _tensors(out)
                   + _tensors(list(args)) + _tensors(kwargs)):
            # a host op: a ``host`` buffer of the step, or DTensor's own
            # bookkeeping of shard sizes and offsets (done once, then
            # cached); nothing on the device
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self._note_writes(func, args, kwargs)
        self.hbm_bytes += self._op_bytes(func, args, kwargs, out)
        kind = _collective(func)
        if kind is not None:
            self._count_collective(func, kind, args, kwargs, out)
        for t in _tensors(out):
            self.track(t)
        return out

    @staticmethod
    def _bincount(x, weights=None, minlength=0):
        if not minlength:
            raise ValueError("bincount on the meta device needs minlength "
                             "(its length is the data's otherwise)")
        dtype = torch.int64
        if weights is not None:
            dtype = (torch.float32 if weights.dtype == torch.float32
                     else torch.float64)
        return torch.empty((int(minlength),), dtype=dtype, device="meta")

    def _count_collective(self, func, kind, args, kwargs, out) -> None:
        names = [a.name for a in func._schema.arguments]
        i = names.index("group_name") if "group_name" in names else -1
        group = (kwargs.get("group_name") if "group_name" in kwargs
                 else args[i] if 0 <= i < len(args) else None)
        nb = float(sum(_bytes_of(t) for t in _tensors(out)))
        axes = self.groups.get(group, str(group))
        self.coll_by_type[kind] += nb
        self.coll_by_axes[axes] += nb
        self.coll_calls += 1

    def _note_writes(self, func, args, kwargs) -> None:
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            for t in _tensors(v):
                if t.device.type == "meta" and _key(t) in self.args:
                    self.written.add(_key(t))

    @staticmethod
    def _op_bytes(func, args, kwargs, out) -> float:
        packet = func._overloadpacket
        if packet in _NO_TRAFFIC:
            return 0.0
        schema = func._schema
        outs = _tensors(out)
        # every tensor argument is read, but an ``out=`` buffer
        ins = _tensors(list(args)) + _tensors(
            {k: v for k, v in kwargs.items() if k != "out"})
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in schema.arguments)
        if not writes:
            in_keys = {_key(t) for t in ins if t.device.type == "meta"}
            view = all(r.alias_info is not None for r in schema.returns)
            if outs and (view or all(
                    t.device.type == "meta" and _key(t) in in_keys
                    for t in outs)):
                return 0.0  # a pure view of an input
        rule = _SLICING.get(packet)
        if rule is not None:
            factor, name = rule
            if name is None:
                return factor * sum(_bytes_of(t) for t in outs)
            names = [a.name for a in schema.arguments]
            i = names.index(name)
            upd = kwargs.get(name, args[i] if i < len(args) else None)
            return factor * sum(_bytes_of(t) for t in _tensors(upd))
        return float(sum(_bytes_of(t) for t in outs)
                     + sum(_bytes_of(t) for t in ins))


def _to_meta(t: torch.Tensor, bases: dict) -> torch.Tensor:
    """A meta tensor with ``t``'s shape, strides, dtype and storage
    offset, on one meta storage per storage of the arguments (views of
    one storage stay views of one)."""
    if _is_dtensor_type(type(t)):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(_to_meta(t._local_tensor, bases),
                                  t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    storage = t.untyped_storage()
    key = storage._cdata
    if key not in bases:
        bases[key] = torch.empty((storage.nbytes(),), dtype=torch.uint8,
                                 device="meta")
    m = bases[key].view(t.dtype).as_strided(t.size(), t.stride(),
                                            t.storage_offset())
    if t.requires_grad:
        m.requires_grad_(True)
    return m


def meta_copy(*args):
    """Meta copies of the tensors of ``args`` (trees kept), with their
    shapes, strides and dtypes; views of one storage stay views of one.
    Nothing is allocated: a costing run (``jit_cost``) can be repeated on
    them after the real tensors are gone."""
    bases: dict = {}
    out = tuple(_map(lambda t: _to_meta(t, bases), a) for a in args)
    return out[0] if len(out) == 1 else out


def jit_cost(fn, *args, in_place=(), host=(), groups=None) -> JitCost:
    """The cost of ``fn(*args)``, counted on meta copies of the tensor
    arguments (see the module docstring). ``in_place``: indices of
    arguments that ``fn`` updates in place (the state), counted as
    aliased outputs; an argument an ATen op writes is found on its own.
    ``host``: tensors of the arguments kept on their own device (cloned)
    because ``fn`` reads them on the host. ``groups``: process group name
    -> the mesh axes it spans, the labels of ``collectives_by_axes`` (a
    dict, or anything with its ``get``: ``sharding.placed.GroupLabels``)."""
    host_ids = {id(t) for t in host}
    bases: dict = {}

    def copy(t):
        if id(t) in host_ids:
            return t.clone()
        return _to_meta(t, bases)

    margs = [_map(copy, a) for a in args]
    arg_keys = {_key(b): b.untyped_storage().nbytes()
                for b in bases.values()}
    counter = _Counter(arg_keys, groups)
    for i in in_place:
        for t in _tensors(margs[i]):
            if t.device.type == "meta":
                counter.written.add(_key(t))
    with _kcost.counting(counter), counter:
        out = fn(*margs)
    out_keys = {}
    for t in _tensors(out):
        if t.device.type == "meta":
            out_keys[_key(t)] = t.untyped_storage().nbytes()
    for k in counter.written:
        out_keys[k] = arg_keys[k]
    alias = sum(nb for k, nb in out_keys.items() if k in arg_keys)
    out_new = sum(nb for k, nb in out_keys.items() if k not in arg_keys)
    temp = max(counter.peak - out_new, 0)
    result = JitCost(
        hbm_bytes=float(counter.hbm_bytes),
        flops=float(counter.flops),
        arg_bytes=int(sum(arg_keys.values())),
        out_bytes=int(sum(out_keys.values())),
        alias_bytes=int(alias),
        temp_bytes=int(temp),
        kernel_calls=dict(counter.kernel_calls),
        collective_bytes=float(sum(counter.coll_by_type.values())),
        collectives_by_type=dict(counter.coll_by_type),
        collectives_by_axes=dict(counter.coll_by_axes),
        collective_calls=counter.coll_calls,
    )
    del out, margs, bases
    return result


def collective_bytes(fn, *args, groups=None, **kwargs) -> dict:
    """The collectives of one rank's ``fn(*args)`` (DTensor arguments on
    a mesh), counted by ``jit_cost``: JAX's ``roofline/hlo.py``
    ``collective_bytes`` for a program that runs eagerly. Returns
    {'total': bytes, 'by_type': {...}, 'by_axes': {...}, 'calls': n}."""
    c = jit_cost(fn, *args, groups=groups, **kwargs)
    return {"total": c.collective_bytes, "by_type": c.collectives_by_type,
            "by_axes": c.collectives_by_axes, "calls": c.collective_calls}


# the ATen matmuls whose flops ``torch.profiler`` counts (it also counts
# elementwise mul and add, which JAX's dot rule does not)
PROFILER_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def profiled_matmul_flops(fn, *args):
    """``fn(*args)`` run for real under ``torch.profiler`` with
    ``with_flops``: (its result, the matmul flops the profiler counted),
    the count ``jit_cost``'s ``flops`` is held to on a device. The
    profiler records an op when it is dispatched, so it also counts a
    product a checkpoint's early stop ends inside its autograd wrapper,
    before its kernel; ``jit_cost`` does not. Compare the two with
    ``torch.utils.checkpoint.set_checkpoint_early_stop(False)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        out = fn(*args)
    flops = sum(e.flops for e in prof.events() if e.name in PROFILER_MATMULS)
    return out, flops
