"""The (rows, 128) plane layout every kernel here takes, and the checks a
kernel wrapper makes before it hands pointers to CUDA."""
from __future__ import annotations

import numpy as np
import torch

LANES = 128
SUBLANES = 8
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def f32(x) -> float:
    """A scalar rounded to float32, as a Python float (exact in f32), so
    the plain versions and the kernels multiply by the same number."""
    return float(np.float32(x))


def is_packed_plane(x) -> bool:
    """Is ``x`` one lane-aligned (rows, 128) plane with rows % 8 == 0?"""
    return (isinstance(x, torch.Tensor) and x.dim() == 2
            and x.shape[1] == LANES and x.shape[0] % SUBLANES == 0)


def layout(n: int) -> tuple[int, int]:
    """(rows, pad) of the (rows, 128) layout of an n-element leaf."""
    rows = -(-n // LANES)
    rows = -(-rows // SUBLANES) * SUBLANES
    return rows, rows * LANES - n


def to_2d(x: torch.Tensor, rows: int, pad: int) -> torch.Tensor:
    """A new zero-padded (rows, 128) copy of one leaf."""
    return torch.nn.functional.pad(x.reshape(-1), (0, pad)).view(rows, LANES)


def from_2d(x2: torch.Tensor, shape, n: int) -> torch.Tensor:
    return x2.reshape(-1)[:n].view(shape)


def check_cuda(name: str, x: torch.Tensor, dtype=None, shape=None,
               device=None, allowed=KERNEL_DTYPES) -> None:
    """Raise unless ``x`` is what the CUDA kernel takes: a contiguous,
    16-byte aligned CUDA tensor of the given dtype (one of ``allowed``),
    shape and device."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(x, 'device', type(x))}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dtype not in allowed:
        raise ValueError(f"{name}: dtype {x.dtype} is not one of "
                         f"{allowed}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def check_plane_cuda(name: str, x: torch.Tensor, dtype=None,
                     allowed=KERNEL_DTYPES) -> None:
    check_cuda(name, x, dtype=dtype, allowed=allowed)
    if not is_packed_plane(x):
        raise ValueError(f"{name}: shape {tuple(x.shape)} is not a "
                         f"(rows, 128) plane with rows % 8 == 0")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
