"""Hand-written Hopper kernels of the port, each beside its plain twin.

* :mod:`.block_ladder` — K1, the momentum-sector ladder GEMM on the f64
  tensor cores, and its planners (CUDA C++,
  ``pymes_tpu_torch/csrc/block_ladder.cu``; every ``csrc/*.cu`` is built by
  :mod:`._build`).
* :mod:`.ccd_tail` — K2/K3, the per-iteration Jacobi + DIIS + energy passes
  over T2 (CUDA C++, ``pymes_tpu_torch/csrc/cc_tail.cu``, the K2′/K3′
  kernels without a T1 segment).
* :mod:`.ovvv_gather` — K4, the momentum gather of T1 that replaces the
  ovvv blocks of the matrix-free CCSD dressing and the EOM sigmas, and its
  diagonal entry, the fused G_vv trace of the dressing (CUDA C++,
  ``pymes_tpu_torch/csrc/ovvv_gather.cu``).
* :mod:`.ccsd_tail` — K2′/K3′, the Jacobi + DIIS + energy passes over the
  CCSD carry [T1 | T2], and their launch plan (CUDA C++,
  ``pymes_tpu_torch/csrc/cc_tail.cu``).
* :mod:`.pair_sym` — K5, the P(ab,ij) pair symmetrisation ``Y + X + P(X)``
  of the CCD/CCSD residual and the EOM doubles sigma (CUDA C++,
  ``pymes_tpu_torch/csrc/pair_sym.cu``).
* :mod:`.davidson` — K6, the preconditioned Davidson residual pass of the
  EOM solver (Triton).
* :mod:`.arnoldi` — K7, the CGS2 Arnoldi projection and the fused
  two-output Krylov combine of the lane-batched GMRES (CUDA C++,
  ``pymes_tpu_torch/csrc/arnoldi.cu``).
* :mod:`.shifted` — K8, the shifted-operator assembly, diagonal
  preconditioner and honest residual of the FEAST/RT contour solves
  (Triton).
* :mod:`.ring_step` — K9, one step of the ring-accumulated ladder over a
  device mesh: the held T shard against a c-panel of the local V block,
  accumulated into R in place (CUDA C++ on the f64 tensor cores,
  ``pymes_tpu_torch/csrc/ring_step.cu``).
* :mod:`.block_scatter` — K10, the set-up scatter of a sparse integral
  list into the named o/v blocks (or the dense tensor), each entry sorted
  into its block on the card in one launch (CUDA C++,
  ``pymes_tpu_torch/csrc/block_scatter.cu``).

A wrapper given a CUDA tensor (K10: a CUDA device) launches its kernel
(or raises); given a CPU tensor it runs the twin.  Each launch of a
kernel adds one to its entry in :data:`LAUNCHES`, so a run can show that
the main path went through it.

Every kernel but K9 and K10 also takes float32 operands, for the f32
phases of the port's precision modes: K1, K4 (its gather), K5, K7 and K8
for the f32 Krylov solves of the FEAST/RT mixed-precision engine
(``ls_precision="mixed"``); K6 for the f32 seed phase of the
mixed-precision Davidson (``EOM_CCSD.precision="mixed"``, with K1, K4 and
K5 in its sigma); K2/K3 for the f32 bulk of the mixed-precision CCD and
K2′/K3′ and K4's fused trace for that of the mixed-precision CCSD
(``solve(mixed_precision=True)``, with K1, K4 and K5).  Each has an f32
kernel on the card (K1's, K4's gather and K7's designed for f32 on their
own, the others instantiations of the f64 source) and an f32 twin,
refuses a mix of types
(:func:`type_suffix`) and counts its f32 launches under its name +
``"_f32"``.
"""

import torch

LAUNCHES = {"block_ladder": 0, "ccd_jacobi_diis": 0, "ccd_mix_energy": 0,
            "ovvv_gather": 0, "ovvv_gather_diag": 0, "ccsd_jacobi_diis": 0,
            "ccsd_mix_energy": 0, "pair_symmetrize": 0,
            "davidson_residual": 0, "arnoldi_cgs2": 0, "shifted_precond": 0,
            "ring_step": 0, "block_ladder_f32": 0, "ovvv_gather_f32": 0,
            "pair_symmetrize_f32": 0, "arnoldi_cgs2_f32": 0,
            "shifted_precond_f32": 0, "davidson_residual_f32": 0,
            "ccd_jacobi_diis_f32": 0, "ccd_mix_energy_f32": 0,
            "ccsd_jacobi_diis_f32": 0, "ccsd_mix_energy_f32": 0,
            "ovvv_gather_diag_f32": 0, "block_scatter": 0}

# the element types of the kernels with an f32 instantiation, and the
# suffix of each type's library entries and LAUNCHES names
SUFFIX = {torch.float64: "", torch.float32: "_f32"}


def type_suffix(what, *tensors):
    """The :data:`SUFFIX` of ``tensors``, which must share one of its
    types: a kernel takes float64 or float32, never a mix."""
    types = {t.dtype for t in tensors}
    if len(types) != 1 or next(iter(types)) not in SUFFIX:
        raise TypeError(f"{what} takes float64 or float32 tensors of one "
                        f"type, not {sorted(map(str, types))}")
    return SUFFIX[types.pop()]


def tl_type(dtype):
    """The Triton element type of a :data:`SUFFIX` type, for the Triton
    kernels whose element type is a constexpr (Triton is imported here, at
    a launch: the package imports where there is no Triton)."""
    import triton.language as tl

    return {torch.float64: tl.float64, torch.float32: tl.float32}[dtype]


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_device(t):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or twin for device {t.device}")
