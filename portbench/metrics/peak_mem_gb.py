"""``torch.cuda.max_memory_allocated()`` from before the Trainer is built
to the end of the window, in GB (1e9 bytes); read before the reference
allocates anything."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
