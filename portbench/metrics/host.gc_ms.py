"""Mean host milliseconds a meta step that Python's collector ran over the
window: the Trainer's ``obs.gc`` spans, one a collection, from the
``gc.callbacks`` hook its Tracer installs (``repro_torch/obs/trace.py``).
Read it beside ``device.idle_share``: a pause stalls the launch queue."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or () if name == "obs.gc"]
    return 1e3 * sum(spans) / ctx.steps if spans else None
