"""``cc_iter_ms``: the window's milliseconds over the CC iterations of the
solves in it (each solve's iterations are the length of its energy
history)."""


def read(ctx):
    w = ctx["window"]
    n = w["counts"].get("cc_iters", 0)
    return w["seconds"] * 1e3 / n if n else None
