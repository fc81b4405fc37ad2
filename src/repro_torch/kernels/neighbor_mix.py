"""Gossip neighbor mix: ``out_j = sum_k W_jk x_k`` over the (L, rows, 128)
learner stack, for one (L, L) f32 mixing matrix W.

Replaces the Pallas TPU kernels ``src/repro/kernels/neighbor_mix.py``
``neighbor_mix_3d`` and ``neighbor_mix_3d_stepped``; the stepped entry
selects ``W = w_stack[step % T]`` on the host (``mixing_matrix_at``) and
launches the same kernel. Every gossip meta step mixes the learners'
meta params once, and the momentum buffers a second time under momentum
tracking.

Bound by the card's memory rate: each value of the stack is read once
and written once, 8 L bytes per coordinate in f32 against 2 L^2 flops
(55.06 GB per call at Qwen3-1.7B, L=4). The CUDA kernel
(``csrc/topology_kernels.cu``, ``repro_neighbor_mix``) gives each thread
4 coordinates of every learner plane, holds the L inputs in registers
and stores the L outputs; W rides by value in the kernel's parameters,
so no per-step matrix is copied to the card or read back from it. The
output may be the input (``out=x``): the gossip step mixes in place.

Arithmetic, in the kernel and in ``neighbor_mix_plain`` alike:
``acc = 0; acc = acc + W_jk * x_k`` for k = 0..L-1, one rounded multiply
and one rounded add per term, zero weights included, so NaN and Inf
spread as through the Pallas kernel's dense contraction. A bf16 stack is
mixed in f32 and rounded back to bf16. ``einsum`` is not used: its sum
order is the library's. CPU tensors take the plain version;
``chip_smoke.py`` holds the kernel to it bitwise on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import LANES, check_cuda, stream_of

MAX_LEARNERS = 16  # the kernel's matrix holds at most 16 x 16 weights

# kernel launches, each counted once under the entry that made it:
# ``neighbor_mix_cuda`` adds one to LAUNCHES, ``neighbor_mix_stepped_cuda``
# one to STEPPED_LAUNCHES
LAUNCHES = 0
STEPPED_LAUNCHES = 0


def mixing_matrix_at(w_or_stack, step):
    """The meta step's mixing matrix: a (L, L) matrix as it is, or entry
    ``step % T`` of a (T, L, L) stack of the time-varying graphs."""
    if w_or_stack.ndim == 2:
        return w_or_stack
    return w_or_stack[int(step) % w_or_stack.shape[0]]


def host_matrix(w, num_learners: int) -> np.ndarray:
    """``w`` (numpy or a CPU tensor) as a contiguous f32 (L, L) array.
    A matrix on the card is refused: reading it back would stall the
    step, and the topologies build theirs on the host."""
    if isinstance(w, torch.Tensor):
        if w.device.type != "cpu":
            raise ValueError(f"mixing matrix on {w.device}: pass it on the "
                             f"host (numpy or a CPU tensor)")
        w = w.numpy()
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.shape != (num_learners, num_learners):
        raise ValueError(f"mixing matrix of shape {w.shape} for "
                         f"{num_learners} learners")
    return w


def neighbor_mix_plain(x, w, *, out=None):
    """x (L, rows, 128) f32 or bf16 -> the mixed stack in x's dtype,
    written into ``out`` when given (it may be ``x``)."""
    L = x.shape[0]
    wt = torch.from_numpy(host_matrix(w, L)).to(x.device)
    xf = x.to(torch.float32)
    mixed = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    for j in range(L):
        acc = torch.zeros_like(xf[0])
        for k in range(L):
            acc.add_(wt[j, k] * xf[k])
        mixed[j] = acc
    mixed = mixed.to(x.dtype)
    return mixed if out is None else out.copy_(mixed)


def neighbor_mix_stepped_plain(x, w_stack, step, *, out=None):
    return neighbor_mix_plain(x, mixing_matrix_at(w_stack, step), out=out)


def _launch(x, w, out):
    """Launch the kernel on a contiguous (L, rows, 128) f32 or bf16 stack
    with rows % 8 == 0, L <= 16; ``w`` on the host. Counts nothing."""
    if x.dim() != 3 or x.shape[2] != LANES or x.shape[1] % 8:
        raise ValueError(f"x: shape {tuple(x.shape)} is not (L, rows, 128) "
                         f"with rows % 8 == 0")
    L, rows, _ = x.shape
    if not 1 <= L <= MAX_LEARNERS:
        raise ValueError(f"{L} learners: the kernel takes 1 to "
                         f"{MAX_LEARNERS}")
    check_cuda("x", x)
    w = host_matrix(w, L)
    out = torch.empty_like(x) if out is None else out
    check_cuda("out", out, x.dtype, shape=x.shape, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        lib.call("repro_neighbor_mix", x.data_ptr(), out.data_ptr(),
                 w.ctypes.data_as(ctypes.c_void_p), L, rows,
                 int(x.dtype == torch.bfloat16), stream_of(x))
    return out


def neighbor_mix_cuda(x, w, *, out=None):
    """The CUDA kernel on a contiguous (L, rows, 128) f32 or bf16 stack
    with rows % 8 == 0, L <= 16; ``w`` on the host. ``out`` (same shape
    and dtype) may be ``x``. Returns the mixed stack."""
    global LAUNCHES
    out = _launch(x, w, out)
    LAUNCHES += 1
    return out


def neighbor_mix_stepped_cuda(x, w_stack, step, *, out=None):
    """The time-varying entry: ``w_stack[step % T]`` chosen on the host,
    then the kernel of ``neighbor_mix_cuda``."""
    global STEPPED_LAUNCHES
    out = _launch(x, mixing_matrix_at(w_stack, step), out)
    STEPPED_LAUNCHES += 1
    return out
