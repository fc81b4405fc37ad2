"""Fused packed-displacement update: displacement, error-feedback add and
stochastic-rounding quantize of the whole (L, rows, 128) learner plane in
one pass.

Replaces the Pallas TPU kernel ``src/repro/kernels/pack_update.py``
``pack_update_3d``. Per learner j and chunk of ``block`` rows:

    d = w_j - g (+ e_j)                       f32
    s = max(max|d_chunk|, 1e-12) / qmax
    q = clip(floor(d / s + u_j), -qmax, qmax)
    c = q s;  err = d - c                     f32 (L, rows, 128) each

and the scales (L, rows / block). ``c`` is what crosses the wire, ``err``
the next error-feedback residual. Chunks are per learner (``block``
divides ``rows``), so each learner's displacement is scaled on its own.

Bound by the card's memory rate: with error feedback it reads w, e, u
and writes c, err (20 bytes per value of the stack), plus the meta plane
g. The CUDA kernel (``csrc/comm_kernels.cu``, ``repro_pack_update``) gives
each chunk to 4 * block threads that hold d in registers, reduce the
chunk's max |d| and quantize from registers; g is read by chunk index and
never broadcast in memory. Outputs may alias inputs: the meta step writes
``c`` over the dither and ``err`` over the residual (``c_out=u``,
``err_out=e``), since a fresh (L, rows, 128) plane each would take the
full-width run past 80 GB.

``pack_compress`` replaces ``pack_compress_3d`` of the same JAX module:
the quantize stage alone, on a displacement plane d the caller formed
(the gossip exchange and the masked hierarchical inner average), with no
meta-plane read and, under ``with_err=False``, no err plane: 16 bytes per
value with err, 12 without. It is the same CUDA chunk kernel with the
g read and the residual add compiled out, so ``pack_compress(d, u)`` is
bitwise ``pack_update(d, zeros, None, u)`` (d - 0 is exact). ``c_out``
may be ``u`` and ``err_out`` may be ``d``.

``pack_update_plain`` and ``pack_compress_plain`` are the same functions
in PyTorch ops, in the op order of ``kernels/ref.py::pack_update_ref`` and
``pack_compress_ref``. CPU tensors take them; ``chip_smoke.py`` holds the
kernels to them bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.planes import LANES, check_cuda, stream_of
from repro_torch.kernels.quantize import check_block, chunk_scales

# kernel launches; ``pack_update_cuda`` and ``pack_compress_cuda`` add
# one each per launch
LAUNCHES = 0
COMPRESS_LAUNCHES = 0


def pack_update_plain(w, g, e, u, qmax: int, block: int, *, c_out=None,
                      err_out=None):
    """Returns (c, err, scales); c and err written into ``c_out`` and
    ``err_out`` when given (they may be ``u`` and ``e``)."""
    d = w.to(torch.float32) - g.to(torch.float32)[None]
    if e is not None:
        d = d + e.to(torch.float32)
    return pack_compress_plain(d, u, qmax, block, c_out=c_out,
                               err_out=err_out)


def pack_compress_plain(d, u, qmax: int, block: int, *, with_err=True,
                        c_out=None, err_out=None):
    """Quantize the displacement plane ``d``. Returns (c, err, scales),
    err None unless ``with_err``; c and err written into ``c_out`` and
    ``err_out`` when given (they may be ``u`` and ``d``)."""
    L, rows, lanes = d.shape
    db = d.to(torch.float32).reshape(L, rows // block, block * lanes)
    scales = chunk_scales(db, qmax)  # (L, nchunks)
    s = scales[..., None]
    q = torch.clamp(torch.floor(db / s + u.reshape(db.shape)), -qmax, qmax)
    c = q * s
    err = (db - c).reshape(d.shape) if with_err else None
    c = c.reshape(d.shape)
    if c_out is not None:
        c = c_out.copy_(c)
    if err is not None and err_out is not None:
        err = err_out.copy_(err)
    return c, err, scales


def pack_update_cuda(w, g, e, u, qmax: int, block: int, *, c_out=None,
                     err_out=None):
    """The CUDA kernel. ``w`` (L, rows, 128) f32 or bf16; ``g`` (rows, 128)
    f32; ``e`` None or (L, rows, 128) f32; ``u`` (L, rows, 128) f32.
    ``c_out``/``err_out`` may alias ``u``/``e`` (or an f32 ``w``).
    Returns (c, err, scales (L, rows / block))."""
    global LAUNCHES
    if w.dim() != 3 or w.shape[2] != LANES:
        raise ValueError(f"w: shape {tuple(w.shape)} is not (L, rows, 128)")
    L, rows, _ = w.shape
    check_cuda("w", w)
    check_cuda("g", g, torch.float32, shape=(rows, LANES), device=w.device)
    for name, x in (("e", e), ("u", u), ("c_out", c_out),
                    ("err_out", err_out)):
        if x is not None:
            check_cuda(name, x, torch.float32, shape=w.shape,
                       device=w.device)
    check_block(rows, block)
    c = torch.empty(w.shape, dtype=torch.float32, device=w.device) \
        if c_out is None else c_out
    err = torch.empty(w.shape, dtype=torch.float32, device=w.device) \
        if err_out is None else err_out
    scales = torch.empty((L, rows // block), dtype=torch.float32,
                         device=w.device)
    lib = build.library()
    with torch.cuda.device(w.device):
        lib.call("repro_pack_update", w.data_ptr(), g.data_ptr(),
                 0 if e is None else e.data_ptr(), u.data_ptr(),
                 c.data_ptr(), err.data_ptr(), scales.data_ptr(), L, rows,
                 block, int(w.dtype == torch.bfloat16), int(qmax),
                 stream_of(w))
    LAUNCHES += 1
    return c, err, scales


def pack_compress_cuda(d, u, qmax: int, block: int, *, with_err=True,
                       c_out=None, err_out=None):
    """The CUDA kernel on f32 (L, rows, 128) planes ``d`` and ``u``.
    ``c_out`` may alias ``u`` or ``d``, ``err_out`` ``d``. Returns
    (c, err or None, scales (L, rows / block))."""
    global COMPRESS_LAUNCHES
    if d.dim() != 3 or d.shape[2] != LANES:
        raise ValueError(f"d: shape {tuple(d.shape)} is not (L, rows, 128)")
    L, rows, _ = d.shape
    check_cuda("d", d, torch.float32)
    for name, x in (("u", u), ("c_out", c_out), ("err_out", err_out)):
        if x is not None:
            check_cuda(name, x, torch.float32, shape=d.shape,
                       device=d.device)
    if err_out is not None and not with_err:
        raise ValueError("err_out given with with_err=False")
    check_block(rows, block)
    c = torch.empty_like(d) if c_out is None else c_out
    err = None
    if with_err:
        err = torch.empty_like(d) if err_out is None else err_out
    scales = torch.empty((L, rows // block), dtype=torch.float32,
                         device=d.device)
    lib = build.library()
    with torch.cuda.device(d.device):
        lib.call("repro_pack_compress", d.data_ptr(), u.data_ptr(),
                 c.data_ptr(), 0 if err is None else err.data_ptr(),
                 scales.data_ptr(), L, rows, block, int(qmax), stream_of(d))
    COMPRESS_LAUNCHES += 1
    return c, err, scales
