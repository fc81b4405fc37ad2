"""TopKReducer: magnitude sparsification of displacements, optionally
composed with int8 quantization of the survivors (the int8_topk scheme).

Per learner and per leaf the largest-|.| k_frac fraction of displacement
entries is kept and the rest zeroed; with error feedback the zeroed mass
returns as residual next round. Wire accounting per kept value: a 4-byte
index plus the value itself (4 bytes dense, 1 byte when int8-quantized).

``torch.topk`` stands in for ``lax.top_k`` (outside any Pallas kernel in
JAX too). Only the k-th largest magnitude is taken from it, and the kept
set is ``(|x| >= thresh) & (|x| > 0)``, which does not depend on how
either library orders ties. Masked-then-quantized values stay exactly
zero through the stochastic rounding (floor(0/s + u) = 0 for u < 1).

On the packed flat meta-plane the whole displacement arrives as one leaf,
so selection is whole-model-vector top-k, and int8_topk quantizes the
survivors as one (L * rows, 128) leaf, whose scale chunks may straddle
two learners, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.comm.quant import SCALE_BYTES, VALUE_BYTES, QuantReducer
from repro_torch.comm.reducer import CompressedReducer
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_leaves, tree_map

INDEX_BYTES = 4.0


class TopKReducer(CompressedReducer):
    def __init__(self, k_frac: float = 0.1, quant_dtype: str | None = None,
                 chunk_rows: int = 64, seed: int = 0, dither=None):
        assert 0.0 < k_frac <= 1.0, k_frac
        self.k_frac = k_frac
        self.quant = (
            QuantReducer(dtype=quant_dtype, chunk_rows=chunk_rows,
                         seed=seed, dither=dither)
            if quant_dtype else None
        )
        self.name = f"{quant_dtype}_topk" if quant_dtype else "topk"

    def _compress(self, delta, step):
        out, wire = [], 0.0
        for i, leaf in enumerate(tree_leaves(delta)):
            L = leaf.shape[0]
            flat = leaf.reshape(L, -1)
            n = flat.shape[1]
            k = max(1, int(round(self.k_frac * n)))
            ab = flat.abs()
            thresh = torch.topk(ab, k, dim=1).values[:, -1:]
            # `ab > 0` guards the all-ties-at-zero case: a mostly-zero leaf
            # has thresh == 0 and `>= thresh` alone would keep everything
            c = torch.where((ab >= thresh) & (ab > 0), flat,
                            torch.zeros((), dtype=flat.dtype,
                                        device=flat.device))
            c = c.reshape(leaf.shape)
            vb = VALUE_BYTES[self.quant.dtype] if self.quant else 4.0
            wire += L * k * (vb + INDEX_BYTES)
            if self.quant:
                c, nchunks = kops.quant_dequant(
                    c, self.quant.leaf_dither(i, step, c.device),
                    dtype=self.quant.dtype, block=self.quant.chunk_rows,
                )
                wire += nchunks * SCALE_BYTES
            out.append(c)
        it = iter(out)
        return tree_map(lambda _: next(it), delta), wire
