"""FLOP accounting for the hot CC iterations (roofline bookkeeping).

Counterpart of ``pymes_tpu/util/flops.py``: the f64-effective FLOPs (the
2MNK a dgemm does) of one occupied-leading CCD iteration and of one
matrix-free T1-dressed CCSD iteration, term by term, with the ladder
counted from a plan's padded sector GEMMs.  Not carried: the Ozaki raw-MXU
factor and the TPU peaks.  :func:`achieved_tflops` turns a count and a
measured time into a rate (it and the ladder's count are
:mod:`pymes_tpu_torch.util.roofline`'s, which holds the H100's peaks).
"""

from pymes_tpu_torch.util import roofline
from pymes_tpu_torch.util.roofline import achieved_tflops  # noqa: F401


def block_ladder_flops(plan, no):
    """f64-effective FLOPs of one BlockLadder application on (no², nv²)
    amplitudes: Σ_groups 2·nS·mB·mK·no² (bucket padding included)."""
    return roofline.block_ladder_flops(plan, no * no)


def ccd_ij_iteration_flops(no, nv, plan=None):
    """f64-effective FLOPs of one occupied-leading CCD iteration
    (``doubles_residual_ij`` term by term).  ``plan`` (a BlockLadder)
    supplies the ladder cost; None counts the dense 2·no²·nv⁴
    contraction."""
    o2, o3, o4 = no ** 2, no ** 3, no ** 4
    v2, v3 = nv ** 2, nv ** 3
    f = 0
    f += 2 * o4 * v2            # I_klij T2 renormalisation
    f += 2 * o4 * v2            # klij,klab->ijab
    if plan is not None:
        f += block_ladder_flops(plan, no)
    else:
        f += 2 * o2 * nv ** 4   # dense pp ladder
    f += 2 * 2 * o3 * v3        # X_ljac + its contraction
    f += 2 * 2 * o3 * v3        # quadratic ring X_kjcb + contraction
    f += 2 * o2 * v3 + 2 * o3 * v2   # X_ac, X_ki dressings
    f += 2 * o2 * v3 + 2 * o3 * v2   # Ex: ac,ijcb + ki,kjab
    f += 3 * 2 * o3 * v3        # Ex ring terms (ikac/ikbc/tilde)
    f += 3 * 2 * o3 * v3        # non-DCD X_lica + 2 contractions
    return f


def ccsd_ij_iteration_flops(no, nv, plan_all=None):
    """f64-effective FLOPs of one matrix-free T1-dressed CCSD iteration:
    the CCD residual (with the all-bra ladder W) + the dressing and
    singles terms that scale beyond O(no²nv²) (the ovvv gathers counted as
    their multiply volume)."""
    o2, o3 = no ** 2, no ** 3
    v2, v3 = nv ** 2, nv ** 3
    f = ccd_ij_iteration_flops(no, nv, plan=None) - 2 * o2 * nv ** 4
    if plan_all is not None:
        f += block_ladder_flops(plan_all, no)   # all-bra W
    f += 10 * 2 * no * nv * o2 * v2
    f += 2 * 2 * o3 * v3 // nv + 4 * 2 * o2 * v2 * no * nv
    return f
