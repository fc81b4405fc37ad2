"""``fused_momentum_broadcast``'s share of its roofline in the profiled
meta step, in %: the least time of a call (w, v and the mean read; w', v'
and the L f32 learner planes written; over the HBM rate) over the mean
device time of its calls (kernel ``momentum_kernel``)."""

from benchlib import yardstick


def read(ctx):
    ops = [op for op in (ctx.trace.ops if ctx.trace else ())
           if "momentum_kernel" in op.name]
    if not ops:
        return None
    mean_s = sum(op.dur_ns for op in ops) * 1e-9 / len(ops)
    nbytes = yardstick.fused_momentum_broadcast_bytes(
        ctx.plane_bytes, ctx.traffic["learners"])
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / mean_s
