"""Device milliseconds of the operations launched under the meta step's
``obs.local_phase`` range in the profiled meta step."""


def read(ctx):
    ops = ctx.trace.ops_in("obs.local_phase") if ctx.trace else []
    return sum(op.dur_ns for op in ops) * 1e-6 if ops else None
