"""``cc_iters``: CC iterations per converged solve of the window (a
count)."""


def read(ctx):
    w = ctx["window"]
    n = w["counts"].get("cc_iters", 0)
    return n / w["units"] if n else None
