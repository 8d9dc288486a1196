"""Roofline accounting for the hot CC contractions on the NVIDIA H100.

Counterpart of ``pymes_tpu/util/roofline.py``: the f64-effective FLOPs of
the block ladder (the plan's actual padded sector GEMMs, not the dense nv⁴
equivalent) and of one CCD doubles residual, and :func:`report`, which
turns a measured time into achieved TFLOP/s and a share of the card's FP64
tensor-core peak.  Not carried: the Ozaki raw-MXU counts and the TPU peaks
(the H100 runs f64 GEMMs natively).

The least time of a kernel call, :func:`bound`, is the larger of its bytes
(each input read once, each output written once) over the HBM rate and its
operations over the card's rate for the kernel's units and type: the
FP64 tensor-core (DMMA) rate for K1 and K9, which run on the tensor cores,
the FP64 CUDA-core FMA rate for the others, and the FP32 CUDA-core rate for
the f32 instantiations of K1, K4, K5 and K8 (K7 sums an f32 basis in f64:
its operations stay at the FP64 FMA rate).  The ``*_bound`` helpers count
those bytes (``elem`` bytes an element of the kernel's type) and
operations for the port's kernels at the shapes their callers give them.

Peaks of one H100 SXM5 (NVIDIA's H100 Tensor Core GPU data sheet, dense,
at the 700 W power limit): 3.35 TB/s HBM3, 67 TFLOP/s FP64 on the tensor
cores (DMMA), 34 TFLOP/s FP64 FMA and 67 TFLOP/s FP32 on the CUDA cores.
"""

HBM_BYTES_S = 3.35e12          # HBM3, NVIDIA H100 SXM5 data sheet
FP64_TENSOR_FLOPS_S = 67e12    # FP64 Tensor Core, same data sheet
FP64_FMA_FLOPS_S = 34e12       # FP64 on the CUDA cores, same data sheet
FP32_FMA_FLOPS_S = 67e12       # FP32 on the CUDA cores, same data sheet


def block_ladder_gemm_dims(plan):
    """(nS, mB, mK) of every bucketed sector-GEMM batch in the plan."""
    return [(int(g.blocks.shape[0]), int(g.blocks.shape[1]),
             int(g.blocks.shape[2])) for g in plan.groups]


def block_ladder_flops(plan, no2):
    """f64-effective FLOPs of one block-ladder apply on (…, no2)
    amplitudes: the padded sector GEMMs actually dispatched,
    ``Σ_buckets 2·nS·mB·mK·no2``."""
    return sum(2 * nS * mB * mK * no2
               for nS, mB, mK in block_ladder_gemm_dims(plan))


def dense_ladder_flops(no, nv):
    """f64-effective FLOPs of the dense vvvv ladder: 2·nv⁴·no²."""
    return 2 * nv ** 4 * no ** 2


def ccd_iteration_flops(no, nv, ladder_flops=None, is_dcd=False):
    """f64-effective FLOPs of one CCD/DCD doubles-residual evaluation, term
    by term (``pymes_tpu/util/roofline.py:59``).  ``ladder_flops``: the
    actual pp-ladder count (e.g. :func:`block_ladder_flops`); defaults to
    the dense 2·nv⁴·no².  Returns a dict of term → FLOPs plus
    ``"TOTAL"``."""
    t = {}
    if ladder_flops is None:
        ladder_flops = dense_ladder_flops(no, nv)
    t["pp ladder (vvvv)"] = ladder_flops
    t["hh ladder apply (klij,klab)"] = 2 * no ** 4 * nv ** 2
    t["X_ac build+apply"] = 2 * nv ** 3 * no ** 2 * 2
    t["X_ki build+apply"] = 2 * no ** 3 * nv ** 2 * 2
    n_ring = 3  # kaic, kbic, acik·kbcj
    if not is_dcd:
        t["hh I_klij build (klcd,ijcd)"] = 2 * no ** 4 * nv ** 2
        n_ring += 7  # X_alcj(+apply), X_cbkj(+apply), X_alci(+2 applies)
    else:
        n_ring += 2  # X_cbkj + its apply survive in DCD
    t[f"ring-class terms ({n_ring}x no3nv3)"] = n_ring * 2 * no**3 * nv**3
    t["TOTAL"] = sum(t.values())
    return t


def achieved_tflops(flops, seconds):
    """The rate, in TFLOP/s, of ``flops`` operations in ``seconds``."""
    return flops / seconds / 1e12


def report(tag, seconds, eff_flops):
    """One formatted roofline line: achieved f64 TFLOP/s and its share of
    the H100's FP64 tensor-core peak."""
    eff = achieved_tflops(eff_flops, seconds)
    return (f"{tag}: {seconds * 1e3:.3f} ms, {eff:.3f} f64 TFLOP/s = "
            f"{100 * eff * 1e12 / FP64_TENSOR_FLOPS_S:.2f}% of the H100 "
            "FP64 tensor-core peak")


def bound(nbytes, flops, flops_s=FP64_TENSOR_FLOPS_S):
    """(bound_ms, bound_by): the least time of a call that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    f64 operations, at the HBM rate and ``flops_s``: the FP64 tensor-core
    rate, or ``FP64_FMA_FLOPS_S`` for a kernel on the CUDA cores."""
    t_b, t_f = nbytes / HBM_BYTES_S, flops / flops_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def ladder_bound(plan, n, elem=8, flops_s=FP64_TENSOR_FLOPS_S):
    """K1 on one plan at operand width n: the cd-major operand (nv², n)
    read, the output (rows, n) written, the blocks and index arrays read
    once; 2 flops a block element a column (the f64 kernel on the tensor
    cores; the f32 one: ``elem=4``, ``flops_s=FP32_FMA_FLOPS_S``)."""
    pk = plan.packed
    blocks = pk.blocks.numel()
    idx = pk.perm.numel() + pk.bra_of_row.numel()
    return bound(elem * (plan.nv ** 2 * n + pk.n_rows * n + blocks)
                 + 4 * idx, 2 * blocks * n, flops_s)


def krylov_bounds(La, m, n, elem=8):
    """K7 at La lanes, m valid rows, rows of n elements of ``elem`` bytes
    (8: f64 basis, 4: f32): the projection's bound (each input read once),
    its three-pass floor (CGS2 must read the m rows and w three times, and
    write w1 and row m) and the fused combine's bound (the m rows and x0
    read, x and r written), in ms; the sums are f64 FMAs for either
    type."""
    return {"bound": bound(elem * (La * m * n + 2 * La * n), 8 * La * m * n,
                           FP64_FMA_FLOPS_S),
            "floor_ms": elem * (3 * La * m * n + 3 * La * n + 2 * La * n)
            / HBM_BYTES_S * 1e3,
            "combine": bound(elem * (La * m * n + 3 * La * n),
                             4 * La * m * n, FP64_FMA_FLOPS_S)}


def gather_bound(plan, nv, ncol, elem=8):
    """K4 on one OVVV plan at ``ncol`` columns: S (int32), W and the
    (nv, ncol) T1 read once, the (ncol, n) output written; one multiply an
    element (``elem=4``: the f32 gather, at the FP32 rate)."""
    n = plan.S.numel()
    return bound(4 * n + elem * (plan.W.numel() + nv * ncol + ncol * n),
                 ncol * n, FP64_FMA_FLOPS_S if elem == 8
                 else FP32_FMA_FLOPS_S)


def diag_bound(plan, nv, no, elem=8):
    """K4's fused trace on one plan: S, W and T1 (nv, no) read once, the
    nv² trace written; a multiply and an add per (p, q, r) entry
    (``elem=4``: the f32 trace, at the FP32 rate)."""
    n = plan.S.numel()
    return bound(4 * n + elem * (plan.W.numel() + nv * no + nv * nv),
                 2 * n, FP64_FMA_FLOPS_S if elem == 8 else FP32_FMA_FLOPS_S)


def ring_bound(ring):
    """K9 (tensor cores) at one ring step (M, N, K): the (N, K) V panel
    and T (M, K) read, R (M, N) read and written; 2·M·N·K flops."""
    M, N, K = ring["M"], ring["N"], ring["K"]
    return bound(8 * (N * K + M * K + 2 * M * N), 2 * M * N * K)


def scatter_bound(nnz, kept, sizes):
    """K10 on a list of ``nnz`` entries of which ``kept`` land in the
    blocks of ``sizes`` elements: the packed indices (4 int16, 8 bytes an
    entry) all read, the values of the kept entries read, and the blocks
    written once (zero fill and stores together); no floating-point
    operations."""
    return bound(8 * nnz + 8 * kept + 8 * sum(sizes), 0)
