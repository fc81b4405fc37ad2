"""Fused block momentum + learner broadcast: the whole packed meta update
of Algorithm 1 in one pass over the planes.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_meta.py``
``fused_momentum_broadcast_2d``:

    d = a - w;  v' = mu v + eta d;  w' = w + v'   (Nesterov: w' = w + mu v' + eta d)
    learners[j] = w'.astype(ldtype)  for j < L

3 plane reads and 2 + L plane writes (the learner writes in ``ldtype``):
the card's memory rate bounds it (61.9 GB per call at Qwen3-1.7B, L=4,
f32). The CUDA kernel (``csrc/meta_kernels.cu``,
``repro_fused_momentum_broadcast``) computes w' once in registers and
stores it to w and to each learner plane, so w' is never read back.

In place: the meta step passes ``w_out=w``, ``v_out=v`` and the learner
plane the mean has already consumed as ``learners_out``. A fresh
(L, rows, 128) output would take the full-width run past 80 GB.

``fused_momentum_broadcast_plain`` is the same function in PyTorch ops,
in the op order of ``kernels/ref.py::fused_momentum_broadcast_ref``
(block momentum, then cast and broadcast). CPU tensors take it;
``chip_smoke.py`` holds the kernel to it bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_momentum import block_momentum_plain
from repro_torch.kernels.planes import (
    check_cuda,
    check_plane_cuda,
    f32,
    stream_of,
)

LAUNCHES = 0  # kernel launches; ``fused_momentum_broadcast_cuda`` adds one


def _learner_shape(w, num_learners):
    return (int(num_learners),) + tuple(w.shape)


def fused_momentum_broadcast_plain(w, v, a, mu, eta, num_learners: int,
                                   ldtype, *, nesterov: bool = False,
                                   w_out=None, v_out=None,
                                   learners_out=None):
    """Returns (w', v', learners); written into the given outputs."""
    w_new, v_new = block_momentum_plain(w, v, a, mu, eta, nesterov=nesterov,
                                        w_out=w_out, v_out=v_out)
    reset = w_new.to(ldtype).unsqueeze(0).expand(
        _learner_shape(w, num_learners))
    if learners_out is None:
        learners_out = reset.clone()
    else:
        learners_out.copy_(reset)
    return w_new, v_new, learners_out


def fused_momentum_broadcast_cuda(w, v, a, mu, eta, num_learners: int,
                                  ldtype, *, nesterov: bool = False,
                                  w_out=None, v_out=None,
                                  learners_out=None):
    """The CUDA kernel on f32 (rows, 128) planes; ``ldtype`` is float32 or
    bfloat16. Outputs may alias ``w``/``v``. Returns (w', v', learners)."""
    global LAUNCHES
    check_plane_cuda("w", w, torch.float32)
    for name, x in (("v", v), ("a", a)):
        check_plane_cuda(name, x, torch.float32)
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"{name} does not match w")
    w_out = torch.empty_like(w) if w_out is None else w_out
    v_out = torch.empty_like(v) if v_out is None else v_out
    for name, x in (("w_out", w_out), ("v_out", v_out)):
        check_plane_cuda(name, x, torch.float32)
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"{name} does not match w")
    shape = _learner_shape(w, num_learners)
    if learners_out is None:
        learners_out = torch.empty(shape, dtype=ldtype, device=w.device)
    check_cuda("learners_out", learners_out, dtype=ldtype, shape=shape,
               device=w.device)
    lib = build.library()
    with torch.cuda.device(w.device):
        lib.call("repro_fused_momentum_broadcast", w.data_ptr(),
                 v.data_ptr(), a.data_ptr(), w_out.data_ptr(),
                 v_out.data_ptr(), learners_out.data_ptr(), w.numel(),
                 shape[0], int(ldtype == torch.bfloat16), f32(mu), f32(eta),
                 int(nesterov), stream_of(w))
    LAUNCHES += 1
    return w_out, v_out, learners_out
