"""Static structure factor / pair-correlation diagnostics from CC
amplitudes.

Counterpart of ``pymes_tpu/util/structure_factor.py``: given the
plane-wave basis, the converged doubles amplitudes and the occupied set,

* the momentum-space transition structure factor S(q): the spin-adapted
  pair density Σ_bj (2 T_abij − T_abji) of each (a, i), accumulated per
  distinct transfer q = k_a − k_i, and
* its spherically averaged Fourier transform, the real-space
  pair-correlation correction g(r).

The pair reductions over T2 run in torch on T2's device; the transfer map
(``np.unique`` over the integer momenta) is built on the host and the
scatter onto it is one ``index_add_`` on the same device.  The functions
return numpy arrays, as the JAX ones do.
"""

import numpy as np
import torch

from pymes_tpu_torch.config import DTYPE
from pymes_tpu_torch.log import print_logging_info


def transition_structure_factor(ueg_model, t_T_abij, t_T_ai=None):
    """S(q) on the discrete momentum-transfer grid.

    ``t_T_abij`` (nv, nv, no, no) and ``t_T_ai`` (nv, no; adds the T1⊗T1
    disconnected part) are tensors (or arrays, taken to the CPU).  Returns
    (q_vecs, S_q): the unique transfer vectors (n_q, 3) in physical units
    and the structure-factor values, numpy."""
    T = torch.as_tensor(t_T_abij, dtype=DTYPE)
    no = T.shape[-1]
    if t_T_ai is not None:
        t1 = torch.as_tensor(t_T_ai, dtype=DTYPE, device=T.device)
        T = T + torch.einsum("ai,bj->abij", t1, t1)
    # spin-adapted pair weight per (a, i): Σ_bj 2 T_abij − T_abji
    w_ai = 2.0 * T.sum(dim=(1, 3)) - T.sum(dim=(1, 2))

    k_int = ueg_model.basis.k_int
    d_int = k_int[no:, None, :] - k_int[None, :no, :]        # (a, i, 3)
    uniq, inverse = np.unique(d_int.reshape(-1, 3), axis=0,
                              return_inverse=True)
    inv = torch.as_tensor(inverse.reshape(-1), device=T.device)
    S_q = torch.zeros(len(uniq), dtype=DTYPE, device=T.device)
    S_q.index_add_(0, inv, w_ai.reshape(-1))
    q_vecs = uniq * 2.0 * np.pi / ueg_model.L
    return q_vecs, S_q.cpu().numpy()


def calcRealSpaceStructureFactor(r_grid, ueg_model, t_T_abij, t_T_ai=None):
    """Pair-correlation correction g(r) on a radial grid: the spherically
    averaged Fourier transform Σ_q S(q)·sinc(|q| r) / Ω."""
    q_vecs, S_q = transition_structure_factor(ueg_model, t_T_abij, t_T_ai)
    q_norm = np.linalg.norm(q_vecs, axis=1)
    r = np.asarray(r_grid, dtype=float)
    qr = np.outer(r, q_norm)
    # spherical average of e^{iq·r}: sinc(qr) = sin(qr)/(qr), sinc(0)=1
    sinc = np.where(qr > 1e-12, np.sin(qr) / np.where(qr > 1e-12, qr, 1.0),
                    1.0)
    g_r = sinc @ S_q / ueg_model.Omega
    print_logging_info("Computed g(r) on %d radial points from %d transfer "
                       "vectors" % (len(r), len(q_norm)), level=2)
    return g_r


def calcReciprocalSpaceStructureFactor(ueg_model, t_T_abij, t_T_ai=None):
    """(|q|, S(q)) sorted by |q|."""
    q_vecs, S_q = transition_structure_factor(ueg_model, t_T_abij, t_T_ai)
    q_norm = np.linalg.norm(q_vecs, axis=1)
    order = np.argsort(q_norm)
    return q_norm[order], S_q[order]
