"""Tokens of all learners' local steps in the window (n x L x K x B x S)
over the window's seconds, from the start of ``trainer.run(n)`` to the
synchronize after it (host clock)."""


def read(ctx):
    return ctx.tokens / ctx.window_s
