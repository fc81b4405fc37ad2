"""Device milliseconds of the operations launched under the meta step's
``obs.meta_mix`` range (the mean over learners and the fused block
momentum and broadcast) in the profiled meta step."""


def read(ctx):
    ops = ctx.trace.ops_in("obs.meta_mix") if ctx.trace else []
    return sum(op.dur_ns for op in ops) * 1e-6 if ops else None
