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
(the dither) and not three. Wire bytes are modeled over the plane's
element count; ``core.meta.meta_step`` rescales every comm_bytes* metric
by the real-parameter fraction.

Dither. The JAX package draws the stochastic-rounding uniforms with
``jax.random`` keyed on (seed, leaf index, meta step), and PyTorch cannot
reproduce those bits. So the reducer takes a dither source: a callable
``(leaf_index, step, shape, device) -> f32 tensor in [0, 1)`` that
returns a NEW tensor (the packed path writes over it). The packed plane
is leaf 0 over the whole (L, rows, 128) shape; per-leaf paths number the
leaves in the order ``tree_leaves`` gives, which is JAX's ``tree_flatten``
order, over each leaf's padded (rows, 128) wire layout. The default
source draws from a ``torch.Generator`` on the plane's device seeded from
(seed, leaf index, step). Runs with it differ from the JAX package's by
their rounding noise, not by their math; the parity tests pass JAX's own
uniforms through ``interop.dither_from_numpy`` instead.

Not ported: ``_compress_packed``, the compress-only route of the gossip
and masked hierarchical topologies (it needs the ``pack_compress`` kernel,
ROADMAP Queue 2).
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
    requested device, seeded from (seed, leaf index, step)."""

    def dither(leaf_index, step, shape, device):
        gen = seeded_generator(device, seed, int(leaf_index), int(step))
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)

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

    def _reduce_packed(self, learners, gp, residual, step):
        u = self.dither(0, step, tuple(learners.shape), learners.device)
        c, err, scales = kops.pack_update(
            learners, gp, residual, u, qmax=QMAX[self.dtype],
            block=self.chunk_rows, c_out=u, err_out=residual,
        )
        # gp + mean_j c_j, summed into the mean's own buffer (addition
        # commutes bitwise; one (rows, 128) plane fewer at full width)
        avg = torch.mean(c, dim=0).add_(gp.to(torch.float32))
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

    def leaf_dither(self, leaf_index, step, device):
        """The dither of one leaf: ``shape -> uniforms`` for the ops."""
        return lambda shape: self.dither(leaf_index, step, shape, device)

    def _compress(self, delta, step):
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
