"""``k1_roofline``: kernel K1 (``csrc/block_ladder.cu``, the momentum-sector
ladder) as a share of its least time, in %: the K1 calls of the profiled
session, each counted from its problem, over the device time of K1's
kernels in the session.

The least time of one call on an operand of n columns is the larger of

* its bytes over 3.35 TB/s (HBM3): the operand (nv², n) read once, the
  output (n_bra², n) written once, and the nonzero V sectors read once at
  their true sizes (no bucket padding): Σ_K n_bra(K)·n_ket(K) elements,
  for every pair momentum K of the ket pairs (c, d virtual), the bra pairs
  (a, b) virtual or, for the all-bra plan, over all orbitals;
* its operations over the rate of its units: 2·n flops a sector element,
  at 67 TFLOP/s (FP64 on the tensor cores; FP32 on the CUDA cores alike).

Peaks: NVIDIA's H100 SXM5 data sheet.  A frozen copy: it imports nothing
of the program.  The calls are K1's entry, ``CALLS``, which the harness
wraps in the profiled session: ``record`` takes a call's shapes (no host
read of a device value) and the harness adds the problem it ran on.
"""

import numpy as np

HBM_BYTES_S = 3.35e12
FLOPS_S = 67e12
CALLS = "pymes_tpu_torch.kernels.block_ladder:block_ladder_kernel_cd"


def record(pack, Tt, n_out, nv):
    return {"n_out": int(n_out), "n": int(Tt.shape[1]), "nv": int(nv),
            "elem": Tt.element_size()}


def sector_elements(k_int, no, all_bra):
    """Σ_K n_bra(K)·n_ket(K) of the plane-wave basis ``k_int`` (n_p, 3)."""
    k = np.asarray(k_int, dtype=np.int64)
    span = 4 * int(np.abs(k).max()) + 1

    def codes(a):
        s = (a[:, None, :] + a[None, :, :]).reshape(-1, 3) + span // 2
        return (s[:, 0] * span + s[:, 1]) * span + s[:, 2]

    ket = codes(k[no:])
    bra = codes(k if all_bra else k[no:])
    keys, n_ket = np.unique(ket, return_counts=True)
    bkeys, n_bra = np.unique(bra, return_counts=True)
    pos = np.searchsorted(bkeys, keys)
    return int(np.sum(n_ket * n_bra[pos]))


def least_seconds(call, problem):
    k_int, no = problem["k_int"], problem["no"]
    n_p = len(k_int)
    nv, n, elem = n_p - no, call["n"], call["elem"]
    all_bra = call["n_out"] == n_p * n_p
    sec = sector_elements(k_int, no, all_bra)
    nbytes = elem * (nv * nv * n + call["n_out"] * n + sec)
    return max(nbytes / HBM_BYTES_S, 2.0 * n * sec / FLOPS_S)


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("calls", {}).get(CALLS)
    if not tr or not calls:
        return None
    durs = [d for cat, name, ds in tr["ops"] if cat == "kernel"
            and ("block_ladder_kernel" in name
                 or "block_ladder_f32_kernel" in name) for d in ds]
    if len(durs) != len(calls):
        raise RuntimeError(f"{len(calls)} K1 calls but {len(durs)} K1 "
                           "kernels in the trace")
    cache = {}
    least = 0.0
    for c in calls:
        key = (c["problem"], c["n_out"], c["n"], c["elem"])
        if key not in cache:
            cache[key] = least_seconds(c, ctx["problems"][c["problem"]])
        least += cache[key]
    return 100.0 * least / (sum(durs) / 1e6)
