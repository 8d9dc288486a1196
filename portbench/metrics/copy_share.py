"""``copy_share``: the elementwise and copy kernels' share of the device's
busy time in the profiled session, in %: a kernel is of that kind when its
lower-cased name holds "elementwise", "copy" or "catarray" and none of the
names of the port's own kernels, a GEMM, a GEMV or a reduction (the
categories of ``tools/profile_torch.py``, copied); memcpy and memset
events are not kernels."""

OWN = ("block_ladder", "pair_sym", "davidson_residual", "ovvv_gather",
       "ccsd_jacobi", "ccsd_mix", "jacobi_insert", "mix_energy", "gemm",
       "gemv", "reduce")
COPY = ("elementwise", "copy", "catarray")


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    us = 0.0
    for cat, name, durs in tr["ops"]:
        low = name.lower()
        if (cat == "kernel" and not any(k in low for k in OWN)
                and any(k in low for k in COPY)):
            us += sum(durs)
    return 100.0 * us / 1e6 / tr["busy_s"]
