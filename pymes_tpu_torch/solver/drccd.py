"""Direct-ring CCD (drCCD), the RPA-like ring-only channel, in the
occupied-leading layout.

Counterpart of ``pymes_tpu/solver/drccd.py``: only the direct ring
diagrams enter the residual and the energy has no exchange part (the drCCD
total energy equals dRPA).  The JAX package carries T2 and the residual as
``[a,b,i,j]``; the port's CCD loop is ``ijab`` only, so here both are
``[i,j,a,b]`` (the integral blocks keep their names' slot order) and the
tests hold each function to the JAX one, transposed.  The residual is
plain ``torch.einsum`` (cuBLAS DGEMM on the card); :func:`ccd_solve
<pymes_tpu_torch.solver.ccd.ccd_solve>` runs it with ``is_dr_ccd`` and
keeps its K2/K3 tail.
"""

import torch


def residual(t_epsilon_i, t_epsilon_a, t_T_ijab, t_V_abij, t_V_iabj,
             t_V_ijab, t_V_aijb=None):
    """drCCD residual ``R[i,j,a,b]``: V_abij + Fock + left/right rings +
    quadratic ring (``pymes_tpu/solver/drccd.py:15-46`` with T and R
    transposed to ``[i,j,a,b]``).

    The left ring needs ``V_aijb``.  Without ``t_V_aijb`` it is derived from
    ``t_V_iabj`` by the particle-exchange identity ``<ak|ic> = <ka|ci>``,
    ``V_aijb[a,k,i,c] = V_iabj[k,a,c,i]``, which holds for any vertex with
    ``V_pqrs = V_qpsr`` (the non-hermitian TC UEG class included); a vertex
    that breaks it needs ``t_V_aijb`` (:func:`get_residual`)."""
    es = torch.einsum
    T = t_T_ijab
    if t_V_aijb is None:
        # particle-exchange transpose: V_aijb[a,k,i,c] = V_iabj[k,a,c,i]
        t_V_aijb = t_V_iabj.permute(1, 0, 3, 2)
    ea, ei = t_epsilon_a, t_epsilon_i
    R = t_V_abij.permute(2, 3, 0, 1)
    # Fock terms with the diagonal f_ab, f_ij of the orbital energies: the
    # JAX package's f[a,d] T[d,b,i,j] − f[i,k] T[a,b,k,j] and their
    # (ab)(ij) images f[b,d] T[d,a,j,i] − f[j,k] T[b,a,k,i]
    Tx = T.permute(1, 0, 3, 2)                       # T[j,i,b,a]
    R = R + (ea[None, None, :, None] - ei[:, None, None, None]) * T
    R = R + (ea[None, None, None, :] - ei[None, :, None, None]) * Tx
    # left and right ring couplings
    R = R + 2.0 * es("akic,kjcb->ijab", t_V_aijb, T)
    R = R + 2.0 * es("kbcj,ikac->ijab", t_V_iabj, T)
    X = es("ikac,klcd->ilad", T, t_V_ijab)
    R = R + 4.0 * es("ilad,ljdb->ijab", X, T)
    return R


def get_residual(tEpsilon_i, tEpsilon_a, tT_ijab, tV_abij, tV_aijb, tV_iabj,
                 tV_ijab):
    """Reference-signature wrapper (``drccd.get_residual``): uses the
    caller's ``aijb`` block as given, exact for any vertex."""
    return residual(tEpsilon_i, tEpsilon_a, tT_ijab, tV_abij, tV_iabj,
                    tV_ijab, t_V_aijb=tV_aijb)


def getEnergy(tT_ijab, tV_ijab):
    """[direct, exchange] drCCD energy: 2 Σ T_ijab V_ijab and 0."""
    e_dir = 2.0 * torch.sum(tT_ijab * tV_ijab)
    return [e_dir, 0.0]
