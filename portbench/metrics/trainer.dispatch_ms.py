"""Mean host milliseconds a meta step inside the Trainer's
``obs.dispatch`` span over the window (the Trainer's own Tracer): the time
the host takes to enqueue the local phase and the mix. Where the launch
queue fills, it includes the wait; read it beside ``device.idle_share``."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or () if name == "obs.dispatch"]
    return 1e3 * sum(spans) / len(spans) if spans else None
