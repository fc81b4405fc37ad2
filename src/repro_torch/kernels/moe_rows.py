"""The MoE layer's row movement between tokens and expert slots
(``models/moe.py``), forward and backward, as two gathers that are each
other's backward.

Replaces no TPU kernel: the JAX package's dispatch is an XLA gather and its
combine an XLA scatter-add. On the card ATen's backward of a gather is an
accumulating ``index_put``, which sorts the indices and adds each run of
equal ones serially; the dispatch table's empty cells all point at one zero
row and the dropped slots at one clamped row, so that backward ran about
100 times over its bytes (4.7 ms a call at DeepSeekMoE's widths). Both
maps are known in the forward:

* ``rows_by_table(src (T, d), table (N,))`` -> (N, d): ``src[table[i]]``,
  a zero row where ``table[i] == T``. The dispatch's forward (the (E, C)
  table of token ids, flattened), and the combine's backward.
* ``sum_by_slots(src (N, d), slots (T, k))`` -> (T, d): the sum of
  ``src[slots[t, j]]`` over the j whose slot is below N, in ascending j,
  accumulated in f32 (f64 for f64) from +0.0 and rounded once. The
  combine's forward (each token's table cells, ascending: expert order,
  the table's, dropped slots == N last), and the dispatch's backward.

``Dispatch`` and ``Combine`` pair them as ``torch.autograd.Function``s.

Bound by the card's memory rate: rows read and rows written, no arithmetic
beyond the adds. The CUDA kernels (``csrc/moe_kernels.cu``) are pure
gathers, one group of threads an output row, 16-byte chunks a thread: no
sort, no atomics, the same bits every run. They take rows of whole 16-byte
chunks from 16-byte aligned tensors (every MoE config's width: d a multiple
of 8), and raise on anything else. CPU tensors take the plain
versions (``index_select`` past a zero row; a masked gather-sum in
ascending j); ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernels to them bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import KernelCost, nbytes
from repro_torch.kernels.planes import check_cuda, stream_of

# kernel launches; each ``*_cuda`` adds one to its own per launch
ROWS_LAUNCHES = 0
SUMS_LAUNCHES = 0


def rows_by_table_cost(src, table) -> KernelCost:
    """The table read, each source row at most once, the output written."""
    T, d = src.shape
    N = table.shape[0]
    return KernelCost("moe_rows_by_table",
                      nbytes(table) + (min(T, N) + N) * d * src.element_size(),
                      0)


def sum_by_slots_cost(src, slots) -> KernelCost:
    """The slots read, each source row at most once (at most T k of them),
    the output written; k adds a value."""
    N, d = src.shape
    T, k = slots.shape
    return KernelCost("moe_sum_by_slots",
                      nbytes(slots)
                      + (min(N, T * k) + T) * d * src.element_size(),
                      T * k * d)


def rows_by_table_plain(src, table):
    """(T, d), (N,) -> (N, d): ``src``'s rows past a zero row, gathered."""
    return torch.cat([src, src.new_zeros((1, src.shape[1]))]).index_select(
        0, table)


def sum_by_slots_plain(src, slots):
    """(N, d), (T, k) -> (T, d): the kept slots' rows summed in ascending j
    in f32 (f64 for f64) from +0.0, rounded once to ``src``'s dtype."""
    N, d = src.shape
    T, k = slots.shape
    acc_dtype = torch.float64 if src.dtype == torch.float64 else torch.float32
    rows = src.index_select(0, slots.clamp(max=N - 1).reshape(-1)).view(
        T, k, d)
    kept = (slots < N)[..., None]
    acc = torch.zeros((T, d), dtype=acc_dtype, device=src.device)
    for j in range(k):
        acc = acc + torch.where(kept[:, j], rows[:, j].to(acc_dtype), 0)
    return acc.to(src.dtype)


def _check(src, index, index_dim):
    """Raise unless the kernels take ``src`` (a contiguous, 16-byte aligned
    2-d f32 or bf16 CUDA tensor whose rows are whole 16-byte chunks) and
    ``index`` (a contiguous ``index_dim``-d int64 tensor on its device)."""
    check_cuda("src", src)
    check_cuda("index", index, device=src.device, allowed=(torch.int64,))
    if src.dim() != 2 or index.dim() != index_dim:
        raise ValueError(f"src {tuple(src.shape)}, index "
                         f"{tuple(index.shape)}: expected 2-d and "
                         f"{index_dim}-d")
    if src.shape[1] * src.element_size() % 16:
        raise ValueError(f"src: rows of {src.shape[1]} {src.dtype} values "
                         f"are not whole 16-byte chunks")


def rows_by_table_cuda(src, table):
    """The kernel on a contiguous (T, d) f32 or bf16 CUDA ``src`` and an
    (N,) int64 ``table`` with values in [0, T] -> a new (N, d) tensor."""
    global ROWS_LAUNCHES
    _check(src, table, 1)
    T, d = src.shape
    N = table.shape[0]
    out = torch.empty((N, d), dtype=src.dtype, device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        lib.call("repro_moe_rows_by_table", src.data_ptr(), table.data_ptr(),
                 out.data_ptr(), N, T, d * src.element_size(), stream_of(src))
    ROWS_LAUNCHES += 1
    return out


def sum_by_slots_cuda(src, slots):
    """The kernel on a contiguous (N, d) f32 or bf16 CUDA ``src`` and (T, k)
    int64 ``slots``, each row ascending in [0, N] -> a new (T, d) tensor."""
    global SUMS_LAUNCHES
    _check(src, slots, 2)
    N, d = src.shape
    T, k = slots.shape
    if k < 1:
        raise ValueError(f"slots: shape {tuple(slots.shape)} has no slot")
    out = torch.empty((T, d), dtype=src.dtype, device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        lib.call("repro_moe_sum_by_slots", src.data_ptr(), slots.data_ptr(),
                 out.data_ptr(), T, k, N, d, int(src.dtype == torch.bfloat16),
                 stream_of(src))
    SUMS_LAUNCHES += 1
    return out


class Dispatch(torch.autograd.Function):
    """Token rows into the flattened (E C, d) table: ``rows(xt, table)``
    forward, ``sums(g, slots)`` backward (``rows``, ``sums``: the routed
    kernels of ``kernels/ops.py``)."""

    @staticmethod
    def forward(ctx, rows, sums, xt, table, slots):
        ctx.sums = sums
        ctx.save_for_backward(slots)
        return rows(xt, table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return None, None, ctx.sums(g.contiguous(), slots), None, None


class Combine(torch.autograd.Function):
    """The (E C, d) table's rows summed into tokens: ``sums(y, slots)``
    forward, ``rows(g, table)`` backward."""

    @staticmethod
    def forward(ctx, rows, sums, y, slots, table):
        ctx.rows = rows
        ctx.save_for_backward(table)
        return sums(y, slots)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return None, None, ctx.rows(g.contiguous(), table), None, None
