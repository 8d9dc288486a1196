"""``solve_ms``: the window's milliseconds over the units it completed (a
unit of a solve cell is one converged solve), on the host clock whose work
ends in ``torch.cuda.synchronize()``."""


def read(ctx):
    w = ctx["window"]
    return w["seconds"] * 1e3 / w["units"] if w["units"] else None
