"""Mean device milliseconds a meta step of the local steps' forward
passes over the window: the Trainer's ``obs.forward.device`` spans, each
the time between two CUDA events around the gradient zeroing and the
loss (``repro_torch/obs/trace.py``), idle time inside included."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or ()
             if name == "obs.forward.device"]
    return 1e3 * sum(spans) / ctx.steps if spans else None
