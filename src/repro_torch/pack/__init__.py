"""The packed flat meta-plane: the whole parameter tree as ONE lane-aligned
(rows, 128) buffer (the JAX package's DESIGN.md §9, same layout).

``PackSpec`` is the static layout, computed once from the parameter tree:

  * leaves are laid out in sorted-key order (JAX's dict flatten order);
  * every leaf occupies ``[offset, offset + size)`` of the flat vector,
    with ``offset`` a multiple of LANES=128;
  * the total is padded once to ``rows * 128`` with ``rows % 8 == 0``;
  * padding is ALWAYS ZERO: ``pack`` writes zeros there and every meta op
    keeps them (elementwise updates of 0 by 0), so norms and means over
    the plane equal their per-leaf values.

The layout depends only on leaf shapes and dtypes, so it can be computed
from tensors on ``torch.device("meta")`` — the full-width layout is
testable without allocating the model.

``unpack`` returns views into the buffer where the dtype matches: the
learner loop of ``repro_torch.core.meta`` runs the model on views of the
(L, rows, 128) learner plane and updates the plane in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

LANES = 128
SUBLANES = 8


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def dtype_name(dt: torch.dtype) -> str:
    """'float32' / 'bfloat16' — the names JAX's PackSpec records."""
    return str(dt).removeprefix("torch.")


def numpy_dtype(dt) -> np.dtype:
    """The numpy dtype that holds a torch dtype, a dtype name or a numpy
    dtype on the host: bfloat16, which numpy lacks, as raw 16-bit words
    ``V2``."""
    if isinstance(dt, torch.dtype):
        dt = dtype_name(dt)
    if isinstance(dt, str) and dt == "bfloat16":
        return np.dtype("V2")
    return np.dtype(dt)


@dataclass(frozen=True)
class PackSpec:
    """Static layout of one parameter tree in the flat meta-plane."""

    paths: tuple  # slash-joined key path per leaf
    shapes: tuple  # original leaf shapes
    dtypes: tuple  # original leaf dtype names
    offsets: tuple  # lane-aligned start offset of each leaf
    sizes: tuple  # element count of each leaf
    rows: int  # buffer rows; rows % 8 == 0
    dtype: str  # buffer dtype name

    @property
    def num_leaves(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        """Padded element count of the packed buffer."""
        return self.rows * LANES

    @property
    def pad_waste(self) -> int:
        return self.total - sum(self.sizes)

    def padding(self) -> list[tuple[int, int]]:
        """The [start, end) ranges of the flat plane that hold no leaf: the
        lane-alignment gaps and the tail pad."""
        ends = [o + n for o, n in zip(self.offsets, self.sizes)]
        starts = list(self.offsets[1:]) + [self.total]
        return [(e, s) for e, s in zip(ends, starts) if s > e]

    def zero_padding_(self, buf: torch.Tensor) -> torch.Tensor:
        """Zero the padding of a (..., rows, 128) plane or stack in place,
        as a repack would."""
        flat = buf.view(tuple(buf.shape[:-2]) + (self.total,))
        for lo, hi in self.padding():
            flat[..., lo:hi].zero_()
        return buf

    def plane_bytes(self, dtype=None) -> int:
        dt = _dtype(self.dtype if dtype is None else dtype)
        return self.total * dt.itemsize

    # ------------------------------------------------------------------
    def pack(self, tree, dtype=None, device=None) -> torch.Tensor:
        """tree -> new (rows, 128) buffer; gaps and tail pad are zero."""
        leaves = tree_leaves(tree)
        dt = _dtype(self.dtype if dtype is None else dtype)
        device = leaves[0].device if device is None else device
        buf = torch.zeros(self.total, dtype=dt, device=device)
        for leaf, off, size in zip(leaves, self.offsets, self.sizes):
            buf[off:off + size].copy_(leaf.reshape(-1))
        return buf.view(self.rows, LANES)

    def unpack(self, buf: torch.Tensor, dtype=None) -> dict:
        """(rows, 128) buffer -> tree.

        ``dtype=None`` restores each leaf's recorded dtype; ``dtype=...``
        casts every leaf to it. Where the leaf dtype equals the buffer's,
        the leaf is a VIEW of ``buf`` (writes go through to the plane).
        """
        flat = buf.reshape(-1)
        leaves = []
        for off, size, shape, dt in zip(self.offsets, self.sizes,
                                        self.shapes, self.dtypes):
            target = _dtype(dt if dtype is None else dtype)
            leaves.append(flat[off:off + size].view(shape).to(target))
        return tree_unflatten(self.paths, leaves)

    # -- stacked planes: a leading learner axis over the same layout --
    def pack_stacked(self, tree, dtype=None) -> torch.Tensor:
        """(lead, ...) leaves -> new (lead, rows, 128) buffer."""
        leaves = tree_leaves(tree)
        lead = leaves[0].shape[0]
        dt = _dtype(self.dtype if dtype is None else dtype)
        buf = torch.zeros((lead, self.total), dtype=dt,
                          device=leaves[0].device)
        for leaf, off, size in zip(leaves, self.offsets, self.sizes):
            buf[:, off:off + size].copy_(leaf.reshape(lead, -1))
        return buf.view(lead, self.rows, LANES)

    def unpack_stacked(self, buf: torch.Tensor, dtype=None) -> dict:
        """(lead, rows, 128) -> tree of (lead, ...) leaves (views where
        the dtype matches)."""
        lead = buf.shape[0]
        flat = buf.reshape(lead, -1)
        leaves = []
        for off, size, shape, dt in zip(self.offsets, self.sizes,
                                        self.shapes, self.dtypes):
            target = _dtype(dt if dtype is None else dtype)
            leaves.append(
                flat[:, off:off + size].view((lead,) + tuple(shape))
                .to(target)
            )
        return tree_unflatten(self.paths, leaves)

    def pack_numpy(self, leaves, dtype=None) -> np.ndarray:
        """Host-side pack of numpy leaves (the checkpoint's legacy per-leaf
        restore): the leaves may carry any shared leading stack axes
        (L / G / tau) before each recorded leaf shape. bfloat16, which
        numpy lacks, packs as raw 16-bit words (``np.dtype("V2")``, the
        dtype a bf16 leaf has in a JAX ``.npz``)."""
        dt = numpy_dtype(self.dtype if dtype is None else dtype)
        lead = tuple(leaves[0].shape[:leaves[0].ndim - len(self.shapes[0])])
        buf = np.zeros(lead + (self.total,), dt)
        # numpy assigns no void (V2) elements: copy their words as uint16
        raw = buf.view(np.uint16) if dt.kind == "V" else buf
        for arr, off, size, shape in zip(leaves, self.offsets, self.sizes,
                                         self.shapes):
            if tuple(arr.shape) != lead + tuple(shape):
                raise ValueError(f"leaf of shape {arr.shape}, expected "
                                 f"{lead + tuple(shape)}")
            if (arr.dtype.kind == "V") != (dt.kind == "V"):
                raise ValueError(f"cannot pack {arr.dtype} leaves into a "
                                 f"{dt} buffer")
            src = arr.view(np.uint16) if dt.kind == "V" else arr
            raw[..., off:off + size] = src.reshape(lead + (-1,))
        return buf.reshape(lead + (self.rows, LANES))

    # ------------------------------------------------------------------
    def layout_dict(self) -> dict:
        """JSON-able layout, key for key the JAX PackSpec's."""
        return {
            "paths": list(self.paths),
            "shapes": [list(s) for s in self.shapes],
            "dtypes": list(self.dtypes),
            "offsets": list(self.offsets),
            "sizes": list(self.sizes),
            "rows": self.rows,
            "dtype": self.dtype,
        }

    @classmethod
    def from_layout(cls, layout: dict) -> "PackSpec":
        """Inverse of ``layout_dict`` (e.g. a JAX spec's layout)."""
        return cls(
            paths=tuple(layout["paths"]),
            shapes=tuple(tuple(s) for s in layout["shapes"]),
            dtypes=tuple(layout["dtypes"]),
            offsets=tuple(layout["offsets"]),
            sizes=tuple(layout["sizes"]),
            rows=int(layout["rows"]),
            dtype=layout["dtype"],
        )


def make_pack_spec(tree, dtype=None) -> PackSpec:
    """Compute the lane-aligned flat layout of ``tree`` once (shapes and
    dtypes only; meta-device tensors do).

    ``dtype``: buffer dtype (default: the promoted type of all leaf
    dtypes — f32 for f32/bf16 trees, as ``jnp.result_type`` gives).
    """
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    sizes = tuple(int(x.numel()) for x in leaves)
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off = _align(off + n, LANES)
    rows = _align(_align(off, LANES) // LANES, SUBLANES)
    if dtype is None:
        dtype = reduce(torch.promote_types, [x.dtype for x in leaves])
    return PackSpec(
        paths=tuple(tree_paths(tree)), shapes=shapes,
        dtypes=tuple(dtype_name(x.dtype) for x in leaves),
        offsets=tuple(offsets), sizes=sizes, rows=max(rows, SUBLANES),
        dtype=dtype_name(_dtype(dtype)),
    )


def unpack_params(state):
    """Global params of a MetaState as the model tree (views): identity
    on per-leaf (packed=False) states, ``spec.unpack`` on packed ones."""
    if state.spec is None:
        return state.global_params
    return state.spec.unpack(state.global_params)
