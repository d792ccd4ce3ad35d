"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over the window
(the peak is reset when the window opens), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
