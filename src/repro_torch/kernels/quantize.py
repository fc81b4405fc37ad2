"""Stochastic-rounding quantize and dequantize of meta displacements (the
int8/int4 wire compression of ``repro_torch.comm``), and the fp8 round
trip.

Replaces the Pallas TPU kernels ``src/repro/kernels/quantize.py``
``quantize_2d`` and ``dequantize_2d``. On a (rows, 128) plane, in chunks
of ``block`` rows (``choose_block``):

    s = max(max|x_chunk|, 1e-12) / qmax       one f32 scale per chunk
    q = clip(floor(x / s + u), -qmax, qmax)   int8; qmax 127 (int8) or 7 (int4)
    x' = f32(q) * s                           dequantize

``u`` in [0, 1) is the stochastic-rounding dither, made by the caller
(``comm.quant.QuantReducer``), so the kernel and its plain version take
the same numbers. Both kernels are bound by the card's memory rate:
quantize moves 9 bytes per value (x and u in, q out), dequantize 5.
The CUDA kernels (``csrc/comm_kernels.cu``, ``repro_quantize`` and
``repro_dequantize``) give each chunk to 4 * block threads, which hold it
in registers, reduce its max |x| by warp shuffles, and quantize from
registers: every value is read once and written once.

``quantize_plain``/``dequantize_plain`` are the same functions in PyTorch
ops, in the op order of the JAX oracles ``kernels/ref.py::quantize_ref``
and ``dequantize_ref``; CPU tensors take them, and ``chip_smoke.py``
holds the kernels to them bitwise on the card. ``fp8_roundtrip_plain``
copies ``ref.fp8_roundtrip_ref``: JAX has no Pallas kernel for fp8, so
this ``torch.float8_e4m3fn`` cast is the port on every device.

NaN: a chunk holding a NaN gets a NaN scale in the kernel and in the
plain version (the max propagates NaN, as ``jnp.max`` does). The kernel
writes q = 0 for a NaN value; the plain version's int8 cast of NaN is
whatever the platform's float-to-int conversion gives.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import KernelCost, nbytes
from repro_torch.kernels.planes import LANES, check_cuda, check_plane_cuda, stream_of

BLOCK_ROWS = 64  # 64 x 128 values per scale chunk
EPS = 1e-12  # all-zero chunks: the scale stays finite, q stays 0
FP8_MAX = 448.0  # largest float8_e4m3fn value
QMAX = {"int8": 127, "int4": 7}

# kernel launches; the ``*_cuda`` wrappers add one per launch
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0


# flops a value: |x|, the chunk max, x / s, + u, floor, the clip's two
# bounds
QUANTIZE_FLOPS = 7


def quantize_cost(x, u, qmax: int, block: int) -> KernelCost:
    """x and u read; q (one byte a value) and a f32 scale a chunk
    written."""
    n, nchunks = x.numel(), x.shape[0] // block
    return KernelCost("quantize", nbytes(x, u) + n + 4 * nchunks,
                      QUANTIZE_FLOPS * n)


def dequantize_cost(q, scales) -> KernelCost:
    """q and the scales read, f32 values written; one multiply a value."""
    return KernelCost("dequantize", nbytes(q, scales) + 4 * q.numel(),
                      q.numel())


def choose_block(rows: int, block: int | None = None) -> int:
    """Largest power-of-two-reduced chunk height that divides ``rows``."""
    b = min(BLOCK_ROWS if block is None else block, rows)
    while rows % b:
        b //= 2
    return b


def check_block(rows: int, block: int) -> None:
    """Raise unless the CUDA kernels take chunks of ``block`` rows here."""
    if not (8 <= block <= 64 and block % 8 == 0 and rows % block == 0):
        raise ValueError(f"chunk height {block} for {rows} rows: the "
                         f"kernels take a multiple of 8 up to 64 that "
                         f"divides the rows")


def divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as a true division on x's device. PyTorch divides a
    CUDA tensor by a Python number through its reciprocal, which can
    round differently from the kernels' division."""
    return x / torch.full((), value, dtype=torch.float32, device=x.device)


def chunk_scales(xb: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(max|x|, 1e-12) / qmax over the last axis of ``xb``."""
    return divide(torch.clamp_min(xb.abs().amax(dim=-1), EPS), qmax)


def quantize_plain(x, u, qmax: int, block: int):
    """x, u (rows, 128) -> (q int8 (rows, 128), scales f32 (rows/b, 1))."""
    rows = x.shape[0]
    xb = x.to(torch.float32).reshape(rows // block, block * LANES)
    scales = chunk_scales(xb, qmax)
    q = torch.floor(xb / scales[:, None] + u.reshape(xb.shape))
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    return q.reshape(rows, LANES), scales.reshape(-1, 1)


def dequantize_plain(q, scales):
    """int8 (rows, 128) times its chunk's scale -> f32 (rows, 128)."""
    nchunks = scales.shape[0]
    out = q.to(torch.float32).reshape(nchunks, -1) * scales.reshape(
        nchunks, 1)
    return out.reshape(q.shape)


def fp8_roundtrip_plain(x, block: int):
    """Per-chunk-scaled float8_e4m3fn cast and back (round to nearest;
    no dither): ``ref.fp8_roundtrip_ref``."""
    rows = x.shape[0]
    xb = x.to(torch.float32).reshape(rows // block, block * LANES)
    s = chunk_scales(xb, FP8_MAX)[:, None]
    x8 = (xb / s).to(torch.float8_e4m3fn)
    return (x8.to(torch.float32) * s).reshape(rows, LANES)


def quantize_cuda(x, u, qmax: int, block: int):
    """The CUDA kernel on f32 (rows, 128) planes ``x`` and ``u``.
    Returns (q int8 (rows, 128), scales f32 (rows/b, 1)), new tensors."""
    global QUANTIZE_LAUNCHES
    check_plane_cuda("x", x, torch.float32)
    check_cuda("u", u, torch.float32, shape=x.shape, device=x.device)
    rows = x.shape[0]
    check_block(rows, block)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((rows // block, 1), dtype=torch.float32,
                         device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        lib.call("repro_quantize", x.data_ptr(), u.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), rows, block, int(qmax), stream_of(x))
    QUANTIZE_LAUNCHES += 1
    return q, scales


def dequantize_cuda(q, scales):
    """The CUDA kernel: int8 (rows, 128) and (rows/b, 1) f32 scales ->
    a new f32 (rows, 128) plane."""
    global DEQUANTIZE_LAUNCHES
    check_plane_cuda("q", q, torch.int8, allowed=(torch.int8,))
    rows, nchunks = q.shape[0], scales.shape[0]
    check_cuda("scales", scales, torch.float32, device=q.device)
    if scales.numel() != nchunks or nchunks == 0 or rows % nchunks:
        raise ValueError(f"scales {tuple(scales.shape)} do not chunk "
                         f"{rows} rows")
    check_block(rows, rows // nchunks)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        lib.call("repro_dequantize", q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), rows, rows // nchunks, stream_of(q))
    DEQUANTIZE_LAUNCHES += 1
    return out
