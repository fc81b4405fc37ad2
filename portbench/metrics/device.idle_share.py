"""1 - the union of device busy intervals of the profiled meta step over
the unprofiled window's seconds a meta step, in %."""


def read(ctx):
    if not ctx.trace or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / (ctx.window_s / ctx.steps))
