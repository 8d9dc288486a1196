"""K5: the P(ab,ij) pair symmetrisation, in CUDA C++.

Replaces the tail of B2, the ``R + Ex + Exᵀ`` of
``pymes_tpu/solver/ccd.py:232-350`` (``doubles_residual_ij``), which is also
the ``d + P(d)`` of the EOM doubles sigma
(``pymes_tpu/solver/eom_ccsd.py:351-352``):

    out[n, p, q, r, s] = Y[n, p, q, r, s] + X[n, p, q, r, s] + X[n, q, p, s, r]

over an optional leading batch axis n, with Y optional.  It serves both
layouts: ijab (p, q occupied, r, s virtual; the CCD/CCSD residual) and abij
(p, q virtual, r, s occupied; the EOM sigma).

The kernel (``pymes_tpu_torch/csrc/pair_sym.cu``, built with nvcc for
sm_90a at first use) is bound by memory bandwidth; a unit of work owns the
pair of chunks (p, q) and (q, p) and reads each element of X once (its
source says how).  The sum is taken in the twin's order, (Y + X) + Xᵀ, so
kernel and twin agree bit for bit.  It takes float64, or float32 for the
f32 sigma of the FEAST/RT mixed-precision engine (an f32 instantiation of
the same kernels).
"""

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

# the tiled program (R > 16) numbers the pairs p <= q on the grid's y axis
MAX_TILED_PAIRS = 65535


def pair_symmetrize_twin(X, Y=None):
    """Plain twin: ``Y + X + P(X)`` with P swapping the two pairs of the
    last four axes (p↔q and r↔s)."""
    Xp = X.transpose(-4, -3).transpose(-2, -1)
    return X + Xp if Y is None else Y + X + Xp


def pair_symmetrize(X, Y=None, twin=False):
    """``out[..., p,q,r,s] = Y + X[..., p,q,r,s] + X[..., q,p,s,r]`` (Y
    optional): K5 on a CUDA tensor, the twin on a CPU tensor or with
    ``twin=True``.  ``X`` is (P, P, R, R) or (n, P, P, R, R), float64 or
    float32, and ``Y`` of the same type."""
    if twin or not kernels.check_device(X):
        return pair_symmetrize_twin(X, Y)
    sfx = kernels.type_suffix("the pair symmetrisation",
                              *((X,) if Y is None else (X, Y)))
    if X.dim() not in (4, 5):
        raise ValueError(f"X of shape {tuple(X.shape)}: want (P,P,R,R) or "
                         "(n,P,P,R,R)")
    P, P2, R, R2 = X.shape[-4:]
    if P != P2 or R != R2:
        raise ValueError(f"X of shape {tuple(X.shape)} is not pair-square")
    if Y is not None and (Y.shape != X.shape or Y.device != X.device):
        raise ValueError("Y must have X's shape and device")
    nb = X.shape[0] if X.dim() == 5 else 1
    if nb > 65535 or (R > 16 and P * (P + 1) // 2 > MAX_TILED_PAIRS):
        raise ValueError(f"X of shape {tuple(X.shape)}: too many pairs for "
                         "the kernel's grid")
    X = X.contiguous()
    Y = Y.contiguous() if Y is not None else None
    out = torch.empty_like(X)
    rc = _build.launch(X.device, getattr(_build.library(),
                                         "pymes_pair_sym" + sfx),
                       X.data_ptr(), None if Y is None else Y.data_ptr(),
                       out.data_ptr(), nb, P, R)
    if rc != 0:
        raise RuntimeError(f"pair_sym launch failed: cudaError {rc}")
    kernels.LAUNCHES["pair_symmetrize" + sfx] += 1
    return out
