"""Mean device milliseconds a meta step of the local steps' updates over
the window: the Trainer's ``obs.update.device`` spans, each the time
between two CUDA events around the gradient's norm and the SGD apply
(``repro_torch/obs/trace.py``), idle time inside included."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or ()
             if name == "obs.update.device"]
    return 1e3 * sum(spans) / ctx.steps if spans else None
