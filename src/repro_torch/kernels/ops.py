"""Dispatch to the hand-written CUDA kernels or to their plain versions.

The rule is the tensor's device and nothing else: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel (building it at
first use) or raises. There is no fallback from one to the other, and
``MAvgConfig.use_pallas`` plays no part here (it is kept for config
parity with the JAX package only).

Per-leaf callers (``packed=False``) go through the same kernels after the
(rows, 128) pad/reshape of the JAX package's ``kernels/ops.py:37-56``;
packed planes are fed to the kernels as they are. The wire compression
(``quantize``, ``dequantize``, ``quant_dequant``, ``pack_update``) takes
its stochastic-rounding dither from the caller, as JAX's
``kernels/ops.py:183-249`` draws it from a key the caller gives.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_momentum as _bm
from repro_torch.kernels import fused_meta as _fm
from repro_torch.kernels import local_sgd as _sgd
from repro_torch.kernels import pack_update as _pu
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.planes import (
    from_2d,
    is_packed_plane,
    layout,
    to_2d,
)
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten


def _route(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# block momentum
# ---------------------------------------------------------------------------


def block_momentum(w, v, a, *, mu, eta=1.0, nesterov=False, w_out=None,
                   v_out=None):
    """The momentum update on one array. Returns (w', v').

    A packed plane goes to the kernel as it is (outputs may alias the
    inputs); any other shape is padded into a (rows, 128) copy, updated,
    and returned as new tensors of the original shape.
    """
    fn = _route(w, _bm.block_momentum_plain, _bm.block_momentum_cuda)
    if is_packed_plane(w):
        return fn(w, v, a, mu, eta, nesterov=nesterov, w_out=w_out,
                  v_out=v_out)
    rows, pad = layout(w.numel())
    w2, v2, a2 = (to_2d(t, rows, pad) for t in (w, v, a))
    w2n, v2n = fn(w2, v2, a2, mu, eta, nesterov=nesterov, w_out=w2,
                  v_out=v2)
    return from_2d(w2n, w.shape, w.numel()), from_2d(v2n, v.shape, v.numel())


def block_momentum_tree(gp, v, avg, *, mu, eta=1.0, nesterov=False):
    """The momentum update leaf by leaf over a parameter tree."""
    new_w, new_v = [], []
    for wi, vi, ai in zip(tree_leaves(gp), tree_leaves(v), tree_leaves(avg)):
        wn, vn = block_momentum(wi, vi, ai, mu=mu, eta=eta,
                                nesterov=nesterov)
        new_w.append(wn)
        new_v.append(vn)
    paths = tree_paths(gp)
    return tree_unflatten(paths, new_w), tree_unflatten(paths, new_v)


# ---------------------------------------------------------------------------
# learner SGD apply
# ---------------------------------------------------------------------------


def sgd_apply(w, g, lr, *, out=None):
    """(f32(w) - lr f32(g)).astype(w.dtype) on one array, into ``out``
    when given (``out=w`` updates in place)."""
    fn = _route(w, _sgd.sgd_apply_plain, _sgd.sgd_apply_cuda)
    if is_packed_plane(w):
        return fn(w, g, lr, out=out)
    rows, pad = layout(w.numel())
    w2 = to_2d(w, rows, pad)
    new = from_2d(fn(w2, to_2d(g, rows, pad), lr, out=w2), w.shape,
                  w.numel())
    return new if out is None else out.copy_(new)


# ---------------------------------------------------------------------------
# fused momentum -> learner broadcast
# ---------------------------------------------------------------------------


def fused_momentum_broadcast(w, v, a, *, mu, eta=1.0, num_learners,
                             ldtype=None, nesterov=False, w_out=None,
                             v_out=None, learners_out=None):
    """Block momentum + learner reset on the packed (rows, 128) meta plane
    in one pass. Returns (w', v', learners (L, rows, 128) ``ldtype``)."""
    if not is_packed_plane(w):
        raise ValueError(f"not a packed (rows, 128) plane: {tuple(w.shape)}")
    fn = _route(w, _fm.fused_momentum_broadcast_plain,
                _fm.fused_momentum_broadcast_cuda)
    ldtype = w.dtype if ldtype is None else ldtype
    return fn(w, v, a, mu, eta, num_learners, ldtype, nesterov=nesterov,
              w_out=w_out, v_out=v_out, learners_out=learners_out)


# ---------------------------------------------------------------------------
# displacement quantization (repro_torch.comm wire compression)
# ---------------------------------------------------------------------------


def _wire_2d(x):
    """Any-shaped ``x`` as f32 in the (rows, 128) wire layout (a view when
    no padding is needed), with its shape and size."""
    x = x.to(torch.float32)
    rows, pad = layout(x.numel())
    x2 = x.reshape(rows, 128) if pad == 0 else to_2d(x, rows, pad)
    return x2, x.shape, x.numel()


def quantize(x, dither, *, qmax=127, block=None):
    """Quantize any-shaped ``x`` to (q int8 2-D, per-chunk scales).
    ``dither(shape)`` gives the U[0, 1) f32 dither of the padded (rows,
    128) layout. Returns (q, scales, shape, n): feed the last three to
    ``dequantize``."""
    x2, shape, n = _wire_2d(x)
    b = _q.choose_block(x2.shape[0], block)
    fn = _route(x2, _q.quantize_plain, _q.quantize_cuda)
    q, s = fn(x2, dither(tuple(x2.shape)), qmax, b)
    return q, s, shape, n


def dequantize(q, scales, shape, n):
    fn = _route(q, _q.dequantize_plain, _q.dequantize_cuda)
    return from_2d(fn(q, scales), shape, n)


def quant_dequant(x, dither, *, dtype="int8", block=None):
    """Round trip of one leaf through the wire compression. Returns
    (x-like f32 after quantize and dequantize, number of scale chunks).
    ``dtype``: int8 | int4 (the stochastic-rounding kernels) | fp8 (the
    per-chunk-scaled e4m3 cast; no dither)."""
    if dtype == "fp8":
        x2, shape, n = _wire_2d(x)
        b = _q.choose_block(x2.shape[0], block)
        return (from_2d(_q.fp8_roundtrip_plain(x2, b), shape, n),
                x2.shape[0] // b)
    q, s, shape, n = quantize(x, dither, qmax=_q.QMAX[dtype], block=block)
    return dequantize(q, s, shape, n), s.shape[0]


def pack_update(w, g, e, u, *, qmax=127, block=None, c_out=None,
                err_out=None):
    """Displacement + EF add + stochastic-rounding quantize over the
    packed (L, rows, 128) learner plane against the (rows, 128) meta
    params, in one pass. Returns (c, err, scales (L, rows / b))."""
    b = _q.choose_block(w.shape[1], block)
    fn = _route(w, _pu.pack_update_plain, _pu.pack_update_cuda)
    return fn(w, g, e, u, qmax, b, c_out=c_out, err_out=err_out)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {
        "fused_momentum_broadcast": _fm.LAUNCHES,
        "block_momentum": _bm.LAUNCHES,
        "sgd_apply": _sgd.LAUNCHES,
        "pack_update": _pu.LAUNCHES,
        "quantize": _q.QUANTIZE_LAUNCHES,
        "dequantize": _q.DEQUANTIZE_LAUNCHES,
    }


def reset_launch_counts() -> None:
    _fm.LAUNCHES = _bm.LAUNCHES = _sgd.LAUNCHES = _pu.LAUNCHES = 0
    _q.QUANTIZE_LAUNCHES = _q.DEQUANTIZE_LAUNCHES = 0
