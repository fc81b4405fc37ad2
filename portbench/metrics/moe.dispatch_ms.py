"""Device milliseconds, in the profiled meta step, of the operations that
move the MoE layer's rows between tokens and expert slots and back: ATen's
accumulating index backward (``indexing_backward_kernel``: the backward of
the dispatch and combine gathers where ATen runs them), or the port's
gather kernels (``rows_by_table_kernel``, ``sum_by_slots_kernel`` of
``csrc/moe_kernels.cu``)."""

NAMES = ("indexing_backward_kernel", "rows_by_table_kernel",
         "sum_by_slots_kernel")


def read(ctx):
    ops = [op for op in (ctx.trace.ops if ctx.trace else ())
           if any(n in op.name for n in NAMES)]
    return sum(op.dur_ns for op in ops) * 1e-6 if ops else None
