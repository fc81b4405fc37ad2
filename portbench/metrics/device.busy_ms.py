"""Milliseconds in which an operation ran on the device in the profiled
meta step (the union of device busy intervals): the card's own time a
step, steadier than the window's host-clock rate where the host sets the
pace."""


def read(ctx):
    return ctx.trace.busy_s * 1e3 if ctx.trace and ctx.trace.busy_s else None
