"""``device_idle.solve``: 100·(1 − busy/window) of the profiled session of
a solve cell: busy is the union of the kernel, memcpy and memset intervals
(``tools/profile_torch.py``'s arithmetic), the window the session's host
wall clock."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
