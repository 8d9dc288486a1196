"""``davidson_iter_ms``: the window's milliseconds over the Davidson
iterations of the EOM solves in it."""


def read(ctx):
    w = ctx["window"]
    n = w["counts"].get("davidson_iters", 0)
    return w["seconds"] * 1e3 / n if n else None
