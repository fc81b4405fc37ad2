"""Dispatch to the hand-written CUDA kernels or to their plain versions.

The rule is the tensor's device and nothing else: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel (building it at
first use) or raises, and a meta tensor (the cost model,
``roofline.cost.jit_cost``) takes the meta route of ``kernels/cost.py``,
which launches nothing and charges the kernel's declared cost. There is
no fallback from one to the other, and
``MAvgConfig.use_pallas`` plays no part here (it is kept for config
parity with the JAX package only).

Per-leaf callers (``packed=False``) go through the same kernels after the
(rows, 128) pad/reshape of the JAX package's ``kernels/ops.py:37-56``;
packed planes are fed to the kernels as they are, and a stack of packed
planes (L, rows, 128) as one (L * rows, 128) plane. The wire compression
(``quantize``, ``dequantize``, ``quant_dequant``, ``pack_update``,
``pack_compress``) takes its stochastic-rounding dither from the caller,
as JAX's ``kernels/ops.py:183-249`` draws it from a key the caller gives.
The gossip mix (``neighbor_mix``) takes its (L, L) matrix on the host.
The robust reduction (``robust_reduce``) takes any contiguous (L, ...)
stack as it is, packed plane or per-leaf leaf. Flash attention
(``flash_attention``) takes the model's (B, S, H, D) projections: the
kernel reads them through their strides, the plain version through the
(B H, S, D) copies of JAX's ``kernels/ops.py:347-378``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import block_momentum as _bm
from repro_torch.kernels import cost as _kcost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_meta as _fm
from repro_torch.kernels import local_sgd as _sgd
from repro_torch.kernels import neighbor_mix as _nm
from repro_torch.kernels import pack_update as _pu
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import robust_reduce as _rr
from repro_torch.kernels.planes import (
    LANES,
    from_2d,
    is_packed_plane,
    layout,
    to_2d,
)
from repro_torch.utils.tree import is_dtensor, tree_map


def _route(x: torch.Tensor, plain, cuda, cost):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor,
    and for a meta tensor the meta route (``kernels/cost.py``): the plain
    version for the output shapes, ``cost`` charged to the active cost
    counter, nothing launched. A DTensor raises: a kernel works on one
    rank's local pieces (``_local_pieces``), never on a DTensor, so it
    cannot take the plain version unnoticed."""
    if is_dtensor(x):
        raise TypeError(
            "a DTensor reached a kernel; pass its local piece "
            "(x.to_local()): the kernels run on one rank's pieces")
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    if x.device.type == "meta":
        return _kcost.on_meta(plain, cost)
    raise ValueError(f"no kernel for device {x.device}")


def _local_pieces(*xs, stacked=()):
    """The local pieces of the arguments of an elementwise kernel, where
    they are DTensors, and None where they are not.

    The pieces of one rank must line up element for element: every
    DTensor on one mesh, with one layout, and each of ``stacked`` (an
    (L, ...) stack over the others' (...)) with its split dims one further
    and its learner dim split only over mesh dims the others are whole
    on (this rank's learners). Anything else raises (redistribute first).
    """
    ds = [x for x in xs + tuple(stacked) if is_dtensor(x)]
    if not ds:
        return None
    from torch.distributed.tensor import Replicate, Shard

    ref = next((x for x in xs if is_dtensor(x)), None)
    want = ref.placements if ref is not None else None

    def stacks(p, w):  # placement p of a stack over w of a plane
        if isinstance(w, Shard):
            return p == Shard(w.dim + 1)
        return p in (w, Shard(0))

    for x in xs + tuple(stacked):
        if x is None:
            continue
        if not is_dtensor(x):
            raise TypeError("a kernel got DTensors and plain tensors mixed")
        pl = tuple(x.placements)
        ok = x.device_mesh == ref.device_mesh and (
            pl == tuple(want) if any(x is y for y in xs)
            else all(stacks(p, w) for p, w in zip(pl, want)))
        if not ok or any(not isinstance(p, (Shard, Replicate)) for p in pl):
            raise ValueError(
                f"the pieces do not line up: {pl} against {tuple(want)}")
    return [None if x is None else x.to_local() for x in xs + tuple(stacked)]


# ---------------------------------------------------------------------------
# block momentum
# ---------------------------------------------------------------------------


def is_plane_stack(x) -> bool:
    """Is ``x`` a contiguous stack (..., rows, 128) of packed planes, as
    the (L, rows, 128) learner planes and (G, rows, 128) group planes?"""
    return (isinstance(x, torch.Tensor) and x.dim() >= 3
            and x.shape[-1] == LANES and x.shape[-2] % 8 == 0
            and x.is_contiguous())


def block_momentum(w, v, a, *, mu, eta=1.0, nesterov=False, w_out=None,
                   v_out=None):
    """The momentum update on one array. Returns (w', v').

    A packed plane goes to the kernel as it is (outputs may alias the
    inputs). A stack of packed planes is updated IN PLACE as one
    (L * rows, 128) plane (the same arithmetic, no copy of the stack).
    Any other shape is padded into a (rows, 128) copy, updated, and
    returned as new tensors of the original shape.
    """
    fn = _route(w, _bm.block_momentum_plain, _bm.block_momentum_cuda,
                _bm.cost)
    if is_plane_stack(w) and is_plane_stack(v) and is_plane_stack(a):
        w2, v2, a2 = (t.view(-1, LANES) for t in (w, v, a))
        fn(w2, v2, a2, mu, eta, nesterov=nesterov, w_out=w2, v_out=v2)
        return w, v
    if is_packed_plane(w):
        return fn(w, v, a, mu, eta, nesterov=nesterov, w_out=w_out,
                  v_out=v_out)
    rows, pad = layout(w.numel())
    w2, v2, a2 = (to_2d(t, rows, pad) for t in (w, v, a))
    w2n, v2n = fn(w2, v2, a2, mu, eta, nesterov=nesterov, w_out=w2,
                  v_out=v2)
    return from_2d(w2n, w.shape, w.numel()), from_2d(v2n, v.shape, v.numel())


def block_momentum_tree(gp, v, avg, *, mu, eta=1.0, nesterov=False):
    """The momentum update leaf by leaf over a parameter tree (or one
    array). Returns (w', v') trees."""
    pairs = tree_map(
        lambda wi, vi, ai: block_momentum(wi, vi, ai, mu=mu, eta=eta,
                                          nesterov=nesterov),
        gp, v, avg)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


# ---------------------------------------------------------------------------
# gossip neighbor mix (repro_torch.topology)
# ---------------------------------------------------------------------------


mixing_matrix_at = _nm.mixing_matrix_at


def neighbor_mix(x, w, *, step=None, out=None, window=None):
    """Mix one (L, ...) learner stack with the (L, L) matrix ``w``, or
    with entry ``step % T`` of a (T, L, L) stack (the time-varying
    graphs; the stepped kernel entry). ``w`` lies on the host. Returns
    sum_k w_jk x_k in x's dtype, written into ``out`` when given (it may
    be ``x``: a packed stack is then mixed in place). ``window=(j0,
    L_out)``: only the outputs j0 to j0 + L_out - 1, an (L_out, ...)
    stack bitwise those rows of the square call.

    A contiguous (L, rows, 128) stack goes to the kernel as it is; any
    other leaf is padded into a new f32 (L, rows, 128) stack, as JAX's
    ``kernels/ops.py:139-149``.
    """
    if w.ndim == 3:
        if step is None:
            raise ValueError(
                "got a (T, L, L) mixing-matrix stack but no step= — the "
                "time-varying graphs are step-indexed; pass the meta step "
                "(silently using step 0 would freeze the graph)")
        fn = _route(x, _nm.neighbor_mix_stepped_plain,
                    _nm.neighbor_mix_stepped_cuda, _nm.stepped_cost)
        mix = lambda x3, o: fn(x3, w, step, out=o,  # noqa: E731
                               window=window)
    else:
        fn = _route(x, _nm.neighbor_mix_plain, _nm.neighbor_mix_cuda,
                    _nm.cost)
        mix = lambda x3, o: fn(x3, w, out=o, window=window)  # noqa: E731
    if x.dim() == 3 and is_plane_stack(x):
        return mix(x, out)
    L = x.shape[0]
    n_out = _nm.window_of(window, L)[1]
    flat = x.to(torch.float32).reshape(L, -1)
    n = flat.shape[1]
    rows, pad = layout(n)
    x3 = F.pad(flat, (0, pad)).view(L, rows, LANES)
    mixed = mix(x3, x3 if window is None else None).reshape(
        n_out, -1)[:, :n].reshape((n_out,) + tuple(x.shape[1:])).to(x.dtype)
    return mixed if out is None else out.copy_(mixed)


def neighbor_mix_tree(tree, w, *, step=None, in_place=False, window=None,
                      out=None):
    """The gossip mix leaf by leaf over a stacked (L, ...) tree; with
    ``in_place`` every leaf receives its mixed values, with ``out`` (a
    tree of the window's shapes) the window's outputs land there."""
    kw = {} if window is None else {"window": window}
    if out is not None:
        return tree_map(lambda x, o: neighbor_mix(x, w, step=step, out=o,
                                                  **kw), tree, out)
    return tree_map(
        lambda x: neighbor_mix(x, w, step=step, out=x if in_place else None,
                               **kw),
        tree)


# ---------------------------------------------------------------------------
# learner SGD apply
# ---------------------------------------------------------------------------


def sgd_apply(w, g, lr, *, out=None):
    """(f32(w) - lr f32(g)).astype(w.dtype) on one array, into ``out``
    when given (``out=w`` updates in place). DTensors of one layout are
    updated through their local pieces (``out`` is then required)."""
    pieces = _local_pieces(w, g, out)
    if pieces is not None:
        if out is None:
            raise ValueError("sgd_apply on DTensors updates ``out``")
        sgd_apply(pieces[0], pieces[1], lr, out=pieces[2])
        return out
    fn = _route(w, _sgd.sgd_apply_plain, _sgd.sgd_apply_cuda, _sgd.cost)
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
    in one pass. Returns (w', v', learners (L, rows, 128) ``ldtype``).
    DTensors (the planes of one layout, the learner stack split one dim
    further) are updated in place through their local pieces."""
    pieces = _local_pieces(w, v, a, w_out, v_out, stacked=(learners_out,))
    if pieces is not None:
        if w_out is None or v_out is None or learners_out is None:
            raise ValueError("fused_momentum_broadcast on DTensors updates "
                             "w_out, v_out and learners_out in place")
        pw, pv, pa, pwo, pvo, plo = pieces
        fused_momentum_broadcast(pw, pv, pa, mu=mu, eta=eta,
                                 num_learners=plo.shape[0], ldtype=ldtype,
                                 nesterov=nesterov, w_out=pwo, v_out=pvo,
                                 learners_out=plo)
        return w_out, v_out, learners_out
    if not is_packed_plane(w):
        raise ValueError(f"not a packed (rows, 128) plane: {tuple(w.shape)}")
    fn = _route(w, _fm.fused_momentum_broadcast_plain,
                _fm.fused_momentum_broadcast_cuda, _fm.cost)
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
    fn = _route(x2, _q.quantize_plain, _q.quantize_cuda, _q.quantize_cost)
    q, s = fn(x2, dither(tuple(x2.shape)), qmax, b)
    return q, s, shape, n


def dequantize(q, scales, shape, n):
    fn = _route(q, _q.dequantize_plain, _q.dequantize_cuda,
                _q.dequantize_cost)
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
    fn = _route(w, _pu.pack_update_plain, _pu.pack_update_cuda,
                _pu.pack_update_cost)
    return fn(w, g, e, u, qmax, b, c_out=c_out, err_out=err_out)


def pack_compress(d, u, *, qmax=127, block=None, with_err=True, c_out=None,
                  err_out=None):
    """Stochastic-rounding quantize of an already-formed (L, rows, 128) f32
    displacement plane ``d`` (the gossip and masked hierarchical compress
    routes). Returns (c, err, scales (L, rows / b)); ``with_err=False``
    allocates and writes no err plane and returns err None."""
    b = _q.choose_block(d.shape[1], block)
    fn = _route(d, _pu.pack_compress_plain, _pu.pack_compress_cuda,
                _pu.pack_compress_cost)
    return fn(d, u, qmax, b, with_err=with_err, c_out=c_out,
              err_out=err_out)


# ---------------------------------------------------------------------------
# robust learner-stack reduction (repro_torch.robust)
# ---------------------------------------------------------------------------


median_trim = _rr.median_trim


def robust_reduce(x, *, trim=0, block=None):
    """Coordinate-wise trimmed mean over the leading (learner) axis of a
    stack: drop the ``trim`` largest and smallest values per coordinate,
    average the rest, in f32. ``trim=0`` is the plain mean (bitwise
    ``torch.mean`` on the CPU); ``trim=median_trim(L)`` the median.

    Any contiguous (L, ...) stack goes to the kernel as it is. ``block``
    keeps the JAX signature: there it picks the Pallas kernel's row tile,
    which the CUDA kernel has no counterpart of, so a tile choice is
    refused rather than ignored.
    """
    if block is not None:
        raise ValueError(f"robust_reduce takes no row tile (block={block}): "
                         "the CUDA kernel gives each thread whole columns")
    fn = _route(x, _rr.robust_reduce_plain, _rr.robust_reduce_cuda,
                _rr.cost)
    return fn(x, trim)


def robust_reduce_tree(tree, *, trim=0):
    """The robust reduction leaf by leaf over a stacked (L, ...) tree."""
    return tree_map(lambda x: robust_reduce(x, trim=trim), tree)


# ---------------------------------------------------------------------------
# flash attention (the model's use_pallas forward and the serving prefill)
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, sliding_window=0,
                    prefix_global=0):
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D) in q's dtype.

    The scale is 1/sqrt(D) of the unpadded head dim, as JAX's. GQA reads kv
    head h // n_rep inside the kernel (no repeated K/V). No gradient: the
    call runs inside ``FlashAttentionFn``, whose backward raises.
    """
    fn = _route(q, _fa.flash_attention_bshd_plain,
                _fa.flash_attention_bshd_cuda, _fa.cost)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def run(q, k, v):
        return fn(q, k, v, causal=causal, sliding_window=sliding_window,
                  prefix_global=prefix_global, scale=scale)

    return _fa.FlashAttentionFn.apply(run, q, k, v)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel entry. The neighbor-mix kernel
    counts each launch once, under ``neighbor_mix`` or, when it came
    through the stepped entry, under ``neighbor_mix_stepped``; flash
    attention under ``flash_attention`` (the bf16 Hopper kernel) or
    ``flash_attention_f32`` (the f32 Hopper kernel, 3xTF32)."""
    return {
        "fused_momentum_broadcast": _fm.LAUNCHES,
        "block_momentum": _bm.LAUNCHES,
        "sgd_apply": _sgd.LAUNCHES,
        "pack_update": _pu.LAUNCHES,
        "quantize": _q.QUANTIZE_LAUNCHES,
        "dequantize": _q.DEQUANTIZE_LAUNCHES,
        "pack_compress": _pu.COMPRESS_LAUNCHES,
        "neighbor_mix": _nm.LAUNCHES,
        "neighbor_mix_stepped": _nm.STEPPED_LAUNCHES,
        "robust_reduce": _rr.LAUNCHES,
        "flash_attention": _fa.LAUNCHES,
        "flash_attention_f32": _fa.F32_LAUNCHES,
    }


def reset_launch_counts() -> None:
    _fm.LAUNCHES = _bm.LAUNCHES = _sgd.LAUNCHES = _pu.LAUNCHES = 0
    _q.QUANTIZE_LAUNCHES = _q.DEQUANTIZE_LAUNCHES = 0
    _pu.COMPRESS_LAUNCHES = _nm.LAUNCHES = _nm.STEPPED_LAUNCHES = 0
    _rr.LAUNCHES = _fa.LAUNCHES = _fa.F32_LAUNCHES = 0
