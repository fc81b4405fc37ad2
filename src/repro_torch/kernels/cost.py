"""The declared cost of a hand-written kernel, and the meta route that
charges it to the cost model (``repro_torch.roofline.cost``).

A kernel of the port is a ctypes launch (``kernels/build.py``): the ATen
dispatcher, and so a dispatch mode counting ATen ops, sees none of its
work. Each kernel module therefore declares what one call costs
(``cost(...)`` beside its CUDA wrapper), the way the JAX package's cost
walk charges a ``pallas_call``, whose operands and result it counts
(``roofline/hlo_cost.py:199-201``):

* ``nbytes``: each input read once and each output written once;
* ``flops``: the arithmetic of the call, with ``unit`` naming the
  ceiling it runs against: ``"f32"`` the CUDA cores' f32 rate (the
  elementwise kernels), ``"bf16"`` the BF16 tensor cores, ``"tf32x3"``
  three TF32 tensor-core products per f32 product (the f32 flash
  kernel's split). Only tensor-core flops are matmul flops, the ones the
  cost model adds to its dot/conv count as JAX's walk does.

The same numbers are each kernel's bound in ``chip_smoke.py`` (over the
card's rates, ``roofline.terms.Rates``), so one formula holds for both.

The meta route: ``kernels/ops.py`` sends a meta tensor here. The plain
version runs on the meta tensors for its output shapes (nothing is
computed), its ATen ops uncounted, and the declared cost and one kernel
call go to the innermost active counter (``counting``). CPU tensors
never take this route, and it launches nothing: the launch counters stay
as they were.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

UNITS = ("f32", "bf16", "tf32x3")

# the active cost counters (``roofline.cost``), innermost last
_COUNTERS: list = []


@dataclass(frozen=True)
class KernelCost:
    """What one call of a kernel costs: bytes moved (each input read and
    each output written once) and flops against the ``unit`` ceiling."""

    name: str
    nbytes: float
    flops: float
    unit: str = "f32"

    def __post_init__(self):
        if self.unit not in UNITS:
            raise ValueError(f"unit {self.unit!r} is not one of {UNITS}")

    @property
    def matmul_flops(self) -> float:
        """The flops that run on the tensor cores (JAX's dot rule)."""
        return 0.0 if self.unit == "f32" else float(self.flops)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` the one the meta route charges, for the ``with``
    block: it has ``uncounted()``, a context in which its ATen ops are
    not counted, and ``charge(cost, out)``."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def on_meta(plain, cost):
    """The meta route of one kernel: ``plain`` on the meta tensors for the
    output shapes, ``cost(*args, **kwargs)`` charged to the active
    counter with the outputs."""

    def run(*args, **kwargs):
        if not _COUNTERS:
            return plain(*args, **kwargs)
        counter = _COUNTERS[-1]
        with counter.uncounted():
            out = plain(*args, **kwargs)
        counter.charge(cost(*args, **kwargs), out)
        return out

    return run
