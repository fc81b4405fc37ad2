"""The matmul kernels' share of all device operation time in the profiled
meta step, in %. A matmul kernel is one whose name holds one of
``CLASSES`` (cuBLAS and CUTLASS GEMM, batched GEMM and GEMV kernels on
sm_90)."""

CLASSES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def read(ctx):
    if not ctx.trace or not ctx.trace.ops:
        return None
    total = sum(op.dur_ns for op in ctx.trace.ops)
    mm = sum(op.dur_ns for op in ctx.trace.ops
             if any(c in op.name.lower() for c in CLASSES))
    return 100.0 * mm / total if total else None
