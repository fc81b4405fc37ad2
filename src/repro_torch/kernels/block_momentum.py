"""Block-momentum meta update on one (rows, 128) plane.

Replaces the Pallas TPU kernel ``src/repro/kernels/block_momentum.py``
``block_momentum_2d``:

    d = a - w;  v' = mu v + eta d;  w' = w + v'    (Nesterov: w' = w + mu v' + eta d)

3 plane reads and 2 plane writes with a handful of flops per element: the
card's memory rate bounds it. The CUDA kernel (``csrc/meta_kernels.cu``,
``repro_block_momentum``) streams the planes once with 16-byte accesses
and may write in place (``w_out=w``, ``v_out=v``). It serves the per-leaf
(``packed=False``) meta step, leaf by leaf through ``ops.block_momentum``.

``block_momentum_plain`` is the same function in PyTorch ops, in the op
order of the JAX oracle ``kernels/ref.py::block_momentum_ref``. CPU tensors
take it; ``chip_smoke.py`` holds the kernel to it bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import check_plane_cuda, f32, stream_of

LAUNCHES = 0  # kernel launches; ``block_momentum_cuda`` adds one per launch


def block_momentum_plain(w, v, a, mu, eta, *, nesterov: bool = False,
                         w_out=None, v_out=None):
    """Returns (w', v'), written into ``w_out``/``v_out`` when given."""
    mu, eta = f32(mu), f32(eta)
    w32, v32, a32 = (x.to(torch.float32) for x in (w, v, a))
    d = a32 - w32
    v_new = mu * v32 + eta * d
    if nesterov:
        w_new = w32 + mu * v_new + eta * d
    else:
        w_new = w32 + v_new
    w_new, v_new = w_new.to(w.dtype), v_new.to(v.dtype)
    if w_out is not None:
        w_new = w_out.copy_(w_new)
    if v_out is not None:
        v_new = v_out.copy_(v_new)
    return w_new, v_new


def block_momentum_cuda(w, v, a, mu, eta, *, nesterov: bool = False,
                        w_out=None, v_out=None):
    """The CUDA kernel on f32 (rows, 128) planes; outputs may alias
    ``w``/``v``. Returns (w', v')."""
    global LAUNCHES
    check_plane_cuda("w", w, torch.float32)
    for name, x in (("v", v), ("a", a)):
        check_plane_cuda(name, x, torch.float32)
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"{name}: {tuple(x.shape)} on {x.device} does "
                             f"not match w {tuple(w.shape)} on {w.device}")
    w_out = torch.empty_like(w) if w_out is None else w_out
    v_out = torch.empty_like(v) if v_out is None else v_out
    for name, x in (("w_out", w_out), ("v_out", v_out)):
        check_plane_cuda(name, x, torch.float32)
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"{name} does not match w")
    lib = build.library()
    with torch.cuda.device(w.device):
        lib.call("repro_block_momentum", w.data_ptr(), v.data_ptr(),
                 a.data_ptr(), w_out.data_ptr(), v_out.data_ptr(),
                 w.numel(), f32(mu), f32(eta), int(nesterov), stream_of(w))
    LAUNCHES += 1
    return w_out, v_out
