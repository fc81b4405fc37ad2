"""Seconds from the start of the process to the window's start: imports,
the CUDA context, the kernel library (built on a checkout's first run,
loaded from ``build/repro_torch/`` after), weights, state and the
warm-up meta steps (host clock)."""


def read(ctx):
    return ctx.setup_s
