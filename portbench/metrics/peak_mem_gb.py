"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over set-up and
window, in GB (10⁹ bytes)."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
