"""Mean host milliseconds a meta step that the Trainer waits for its data
over the window: the ``obs.data`` spans around ``batch_fn``
(``repro_torch/core/trainer.py``)."""


def read(ctx):
    spans = [dur for name, _t0, dur in ctx.spans or () if name == "obs.data"]
    return 1e3 * sum(spans) / ctx.steps if spans else None
