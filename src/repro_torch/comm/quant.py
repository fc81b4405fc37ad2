"""QuantReducer: int8/fp8 displacement quantization with per-chunk scales.

Each learner's displacement leaf is flattened to the (rows, 128) wire
layout, split into chunk_rows x 128 chunks, and quantized against each
chunk's max-abs scale with unbiased stochastic rounding (the CUDA kernels
of ``kernels/quantize.py``, or their plain versions on the CPU). Wire
accounting: 1 byte per value (int8/fp8) + 4 bytes per chunk scale, vs. 4
bytes per value dense.

On the packed flat meta-plane the learner stack arrives as ONE
(L, rows, 128) plane, and the int8/int4 reduce goes through the fused
``pack_update`` kernel: displacement + EF-residual add + quantize in one
pass, with per-learner scale chunks. It writes the compressed
displacement over the dither and the new residual over the old one, so
the full-width meta step needs one (L, rows, 128) plane beyond its state
(the dither) and not three, and the f64 sum of one (rows, 128) plane. It averages C(delta) with the plain mean
and never reads the robust ``aggregate`` hook, as the JAX package's
``_reduce_packed`` does not (ROADMAP Queue 3): with int8 on the packed
plane a robust estimator is skipped. Wire bytes are modeled over the
plane's element count; ``core.meta.meta_step`` rescales every
comm_bytes* metric by the real-parameter fraction.

Dither. The JAX package draws the stochastic-rounding uniforms with
``jax.random`` keyed on (seed, leaf index, meta step), and PyTorch cannot
reproduce those bits. So the reducer takes a dither source: a callable
``(leaf_index, step, shape, device) -> f32 tensor in [0, 1)`` that
returns a NEW tensor (the packed path writes over it). The packed plane
is leaf 0 over the whole (L, rows, 128) shape; per-leaf paths number the
leaves in the order ``tree_leaves`` gives, which is JAX's ``tree_flatten``
order, over each leaf's padded (rows, 128) wire layout. The default
source draws from a ``torch.Generator`` on the plane's device seeded from
(seed, leaf index, step) and, for each learner j of an (L, rows, 128)
stack, j: one rank of a mesh draws its own learners' planes and no
other's (``sharding/placed.py``). Runs with it differ from the JAX
package's by their rounding noise, not by their math; the parity tests
pass JAX's own uniforms through ``interop.dither_from_numpy`` instead.

The mean of C(delta) over the learners is their sum in f64, divided by L
and rounded to f32 once. A sum of L f32 values is exact in f64 unless
their magnitudes span more than 2^(29 - log2 L), so it does not depend
on the order of the additions: a rank of a mesh that sums its learners
and all-reduces the partial sums gets one process's mean bitwise.

The compress-only route of the gossip and masked hierarchical
topologies (``topology.gossip.compress_stack``) hands the reducer a packed
displacement plane it formed itself: ``_compress_packed`` quantizes it
through the ``pack_compress`` kernel, with the dither drawn as
``_reduce_packed`` draws it (leaf 0, this step, the delta's shape), c
written over the dither and, under error feedback, err over the delta.
Without error feedback (``_compress``) no err plane exists at all.
"""
from __future__ import annotations

import torch

from repro_torch.comm.reducer import CompressedReducer, dense_bytes
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import QMAX
from repro_torch.utils.rng import seeded_generator
from repro_torch.utils.tree import tree_leaves, tree_map, tree_norm

VALUE_BYTES = {"int8": 1.0, "int4": 0.5, "fp8": 1.0}
SCALE_BYTES = 4.0


def seeded_dither(seed: int):
    """The default dither source: uniforms from a generator on the
    requested device, seeded from (seed, leaf index, step), and of each
    learner of a 3-D (L, rows, 128) stack from (seed, leaf index, step,
    learner). ``dither.learners(leaf, step, first, shape, device)`` draws
    the planes of learners ``first`` to ``first + shape[0] - 1`` alone."""

    def learners(leaf_index, step, first, shape, device):
        keys = (seed, int(leaf_index), int(step))
        if len(shape) != 3:
            return torch.rand(shape, generator=seeded_generator(device, *keys),
                              dtype=torch.float32, device=device)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for j in range(shape[0]):
            torch.rand(tuple(shape[1:]), out=out[j], generator=seeded_generator(
                device, *keys, int(first) + j))
        return out

    def dither(leaf_index, step, shape, device):
        return learners(leaf_index, step, 0, shape, device)

    dither.learners = learners
    return dither


class QuantReducer(CompressedReducer):
    def __init__(self, dtype: str = "int8", chunk_rows: int = 64,
                 seed: int = 0, dither=None):
        assert dtype in VALUE_BYTES, dtype
        self.dtype = dtype
        self.chunk_rows = chunk_rows
        self.dither = seeded_dither(seed) if dither is None else dither
        self.name = dtype

    def _is_packed(self, x) -> bool:
        return (isinstance(x, torch.Tensor) and x.dim() == 3
                and x.shape[-1] == 128 and self.dtype in QMAX)

    def reduce(self, learners, gp, residual, *, step):
        if self._is_packed(learners):
            return self._reduce_packed(learners, gp, residual, step)
        return super().reduce(learners, gp, residual, step=step)

    # the two steps a rank of a mesh takes on its pieces of the stack
    # (``sharding/placed.py::PieceQuant``)
    def _uniforms(self, step, shape, device):
        """The packed plane's dither (leaf 0, this step): a new tensor."""
        return self.dither(0, step, shape, device)

    def _learner_sum(self, c):
        """(the f64 sum of ``c`` over its learners, their count)."""
        return torch.sum(c, dim=0, dtype=torch.float64), c.shape[0]

    def _reduce_packed(self, learners, gp, residual, step):
        u = self._uniforms(step, tuple(learners.shape), learners.device)
        c, err, scales = kops.pack_update(
            learners, gp, residual, u, qmax=QMAX[self.dtype],
            block=self.chunk_rows, c_out=u, err_out=residual,
        )
        # gp + mean_j c_j, gp added into the mean's own buffer (addition
        # commutes bitwise)
        total, n = self._learner_sum(c)
        avg = total.div_(n).to(torch.float32).add_(gp.to(torch.float32))
        del total
        wire = (learners.numel() * VALUE_BYTES[self.dtype]
                + scales.numel() * SCALE_BYTES)
        db = dense_bytes(learners)
        metrics = {
            "comm_bytes": wire,
            "comm_bytes_dense": db,
            "comm_compression": db / wire,
            "comm_error_norm": tree_norm(err),
        }
        return avg, (err if residual is not None else None), metrics

    def _compress_packed(self, delta, step, with_err=True):
        """(c, err, wire) of the packed (L, rows, 128) f32 displacement
        plane in one ``pack_compress`` launch. c lands in the dither's
        buffer and err (None unless ``with_err``) in ``delta``'s: the
        caller's delta is consumed."""
        delta = delta.to(torch.float32)
        u = self._uniforms(step, tuple(delta.shape), delta.device)
        c, err, scales = kops.pack_compress(
            delta, u, qmax=QMAX[self.dtype], block=self.chunk_rows,
            with_err=with_err, c_out=u, err_out=delta if with_err else None,
        )
        wire = (delta.numel() * VALUE_BYTES[self.dtype]
                + scales.numel() * SCALE_BYTES)
        return c, err, wire

    def _compress_residual(self, delta, step):
        # the kernel forms err = delta - c in the same pass
        if self._is_packed(delta):
            return self._compress_packed(delta, step)
        return super()._compress_residual(delta, step)

    def leaf_dither(self, leaf_index, step, device):
        """The dither of one leaf: ``shape -> uniforms`` for the ops."""
        return lambda shape: self.dither(leaf_index, step, shape, device)

    def _compress(self, delta, step):
        if self._is_packed(delta):
            c, _err, wire = self._compress_packed(delta, step,
                                                  with_err=False)
            return c, wire
        out, wire = [], 0.0
        for i, leaf in enumerate(tree_leaves(delta)):
            dq, nchunks = kops.quant_dequant(
                leaf, self.leaf_dither(i, step, leaf.device),
                dtype=self.dtype, block=self.chunk_rows,
            )
            out.append(dq)
            wire += (leaf.numel() * VALUE_BYTES[self.dtype]
                     + nchunks * SCALE_BYTES)
        it = iter(out)
        return tree_map(lambda _: next(it), delta), wire
