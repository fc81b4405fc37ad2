"""Learner SGD apply ``w <- (f32(w) - lr * f32(g)).astype(w.dtype)`` on one
(rows, 128) plane.

Replaces the Pallas TPU kernel ``src/repro/kernels/local_sgd.py``
``sgd_apply_2d``; the JAX meta step does the same arithmetic as a tree map
(``core/meta.py:219-224``). The port keeps each learner as one packed
plane, so a local step's whole update is one launch of this kernel, K·L
times per meta step.

2 plane reads and 1 write, 2 flops per element: the card's memory rate
bounds it (20.6 GB per call at Qwen3-1.7B in f32). The CUDA kernel
(``csrc/meta_kernels.cu``, ``repro_sgd_apply``) gives each thread one
16-byte vector (4 f32 or 8 bf16 elements) and each block of threads one
chunk of the plane, as many blocks as chunks; it updates in place
(``out=w``).

``sgd_apply_plain`` is the same function in PyTorch ops, in the op order
of ``kernels/ref.py::sgd_apply_ref``. CPU tensors take it;
``chip_smoke.py`` holds the kernel to it bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import check_plane_cuda, f32, stream_of

LAUNCHES = 0  # kernel launches; ``sgd_apply_cuda`` adds one per launch


def sgd_apply_plain(w, g, lr, *, out=None):
    """Returns the updated plane, written into ``out`` when given."""
    new = (w.to(torch.float32) - f32(lr) * g.to(torch.float32)).to(w.dtype)
    return new if out is None else out.copy_(new)


def sgd_apply_cuda(w, g, lr, *, out=None):
    """The CUDA kernel; ``w``, ``g`` and ``out`` share one dtype (float32
    or bfloat16) and shape. ``out`` may be ``w``."""
    global LAUNCHES
    check_plane_cuda("w", w)
    check_plane_cuda("g", g, w.dtype)
    out = torch.empty_like(w) if out is None else out
    check_plane_cuda("out", out, w.dtype)
    for name, x in (("g", g), ("out", out)):
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"{name} does not match w")
    lib = build.library()
    with torch.cuda.device(w.device):
        lib.call("repro_sgd_apply", w.data_ptr(), g.data_ptr(),
                 out.data_ptr(), w.numel(), int(w.dtype == torch.bfloat16),
                 f32(lr), stream_of(w))
    LAUNCHES += 1
    return out
