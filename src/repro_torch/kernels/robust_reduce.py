"""Coordinate-wise trimmed mean over the learner axis: sort the L values of
each coordinate, drop the ``trim`` largest and smallest, average the rest.

Replaces the Pallas TPU kernel ``src/repro/kernels/robust_reduce.py``
``robust_reduce_3d``. It stands in for the L-way mean inside the mean-based
reducers when robust aggregation is on (``robust.RobustAggregator``):
once per flat meta step over the (L, rows, 128) learner plane, per group
and across groups in the hierarchical topology. ``trim=0`` is the plain
mean, sum / L, with no sort; ``trim=median_trim(L)`` the coordinate-wise
median.

Bound by the card's memory rate: each value of the stack is read once and
each result written once, (L + 1) * 4 bytes a coordinate in f32 (34.4 GB
per call at Qwen3-1.7B, L=4). The CUDA kernel
(``csrc/robust_kernels.cu``, ``repro_robust_reduce``) gives each thread 4
coordinates (one 16-byte load from each learner plane; 1 where the leaf's
size is not a multiple of 4 or L > 8), sorts their L values in registers
with an odd-even transposition network and writes one f32 each. It takes
any contiguous (L, ...) stack, so the per-leaf (``packed=False``) path
launches it leaf by leaf, where JAX used its jnp oracle.

Order and arithmetic, in the kernel and in ``robust_reduce_plain`` alike:
a stable sort by the int32 key of ``sort_keys`` (the order of
``jnp.sort``: -0.0 equal to +0.0, every NaN last, +-inf at the ends), then
``acc = acc + s_k`` over the kept rows in ascending order from +0.0 (one
kept value is taken as it is) and one true division by L - 2 trim. That
equals the JAX package's eager oracle (``kernels/ref.py::robust_reduce_ref``)
and, at trim 0 and L >= 2, ``torch.mean`` on the CPU, bitwise, signed
zeros included. CPU tensors take the plain version; ``chip_smoke.py``
holds the kernel to it bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import KERNEL_DTYPES, stream_of

MAX_LEARNERS = 16  # the kernel is instantiated for 1 to 16 learners
NAN_KEY = 0x7FFFFFFF

LAUNCHES = 0  # kernel launches; ``robust_reduce_cuda`` adds one per launch


def median_trim(L: int) -> int:
    """The trim that turns the trimmed mean into the coordinate-wise
    median: keeps 1 value for odd L, the 2 middle values for even L."""
    return (L - 1) // 2


def sort_keys(x32: torch.Tensor) -> torch.Tensor:
    """int32 keys of the sort order: -0.0 and +0.0 give 0, every NaN
    INT32_MAX, and the other values their float order (the bits, with the
    magnitude bits of negatives flipped)."""
    b = x32.view(torch.int32)
    key = b ^ ((b >> 31) & 0x7FFFFFFF)
    key = torch.where(x32 == 0, torch.zeros((), dtype=torch.int32,
                                            device=x32.device), key)
    return torch.where(torch.isnan(x32),
                       torch.full((), NAN_KEY, dtype=torch.int32,
                                  device=x32.device), key)


def robust_reduce_plain(x, trim: int = 0):
    """x (L, ...) any float -> the f32 trimmed mean over axis 0."""
    L = x.shape[0]
    assert 0 <= 2 * trim < L, (trim, L)
    x32 = x.to(torch.float32)
    if trim == 0:
        s = x32
    else:
        order = torch.sort(sort_keys(x32), dim=0, stable=True).indices
        s = torch.gather(x32, 0, order)
    # +0.0 starts a sum of two or more values (a column of -0.0 sums to
    # +0.0, as in XLA and ATen); one kept value is returned as it is
    acc = s[trim] + (0.0 if L - 2 * trim > 1 else -0.0)
    for k in range(trim + 1, L - trim):
        acc = acc + s[k]
    # a divisor on the tensor's device: a CPU scalar would let the CUDA
    # division multiply by a rounded reciprocal
    return acc.div_(torch.full((), float(L - 2 * trim), dtype=torch.float32,
                               device=acc.device))


def robust_reduce_cuda(x, trim: int = 0, *, out=None):
    """The CUDA kernel on a contiguous (L, ...) f32 or bf16 CUDA stack,
    1 <= L <= 16. Returns the f32 result of shape ``x.shape[1:]``, written
    into ``out`` when given."""
    global LAUNCHES
    L = x.shape[0]
    assert 0 <= 2 * trim < L, (trim, L)
    if not 1 <= L <= MAX_LEARNERS:
        raise ValueError(f"{L} learners: the kernel takes 1 to "
                         f"{MAX_LEARNERS}")
    if x.device.type != "cuda" or x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x: expected a float32 or bfloat16 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    n = x.numel() // L
    if n < 1:
        raise ValueError(f"x: shape {tuple(x.shape)} has no coordinates")
    out = (torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
           if out is None else out)
    if (out.dtype != torch.float32 or out.device != x.device
            or tuple(out.shape) != tuple(x.shape[1:])
            or not out.is_contiguous()):
        raise ValueError(f"out: expected a contiguous float32 tensor of "
                         f"shape {tuple(x.shape[1:])} on {x.device}")
    vec4 = (n % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
            and out.data_ptr() % 16 == 0)
    lib = build.library()
    with torch.cuda.device(x.device):
        lib.call("repro_robust_reduce", x.data_ptr(), out.data_ptr(), L, n,
                 trim, int(x.dtype == torch.bfloat16), int(vec4),
                 stream_of(x))
    LAUNCHES += 1
    return out
