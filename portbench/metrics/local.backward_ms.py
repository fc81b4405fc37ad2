"""Mean device milliseconds a meta step of the local steps' backward
passes over the window: the Trainer's ``obs.backward.device`` spans, each
the time between two CUDA events around ``loss.backward()``, the remat
recompute included (``repro_torch/obs/trace.py``), idle time inside
included."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or ()
             if name == "obs.backward.device"]
    return 1e3 * sum(spans) / ctx.steps if spans else None
