"""``sgd_apply``'s share of its roofline in the profiled meta step, in %:
the least time of a call (its bytes, each input read and each output
written once, over the HBM rate) over the mean device time of its calls
(kernel ``sgd_kernel``)."""

from benchlib import yardstick


def read(ctx):
    ops = [op for op in (ctx.trace.ops if ctx.trace else ())
           if "sgd_kernel" in op.name]
    if not ops:
        return None
    mean_s = sum(op.dur_ns for op in ops) * 1e-9 / len(ops)
    bound_s = (yardstick.sgd_apply_bytes(ctx.plane_bytes)
               / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound_s / mean_s
