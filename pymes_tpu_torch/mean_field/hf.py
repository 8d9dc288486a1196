"""Hartree-Fock helpers (energy, Fock build, UEG orbital energies).

Counterparts of ``pymes_tpu/mean_field/hf.py:13-46`` on torch tensors; the
result lies on the device of the integrals.
"""

import torch


def calc_hf_e(no: int, e_core, t_h_pq, t_V_pqrs):
    """Closed-shell HF total energy:
    2Σ_i h_ii + Σ_ij (2<ij|ij> − <ij|ji>) + E_core."""
    h_oo = t_h_pq[:no, :no]
    V_oooo = t_V_pqrs[:no, :no, :no, :no]
    e = 2.0 * torch.einsum("ii->", h_oo)
    e = e + 2.0 * torch.einsum("jiji->", V_oooo)
    e = e - 1.0 * torch.einsum("ijji->", V_oooo)
    return e + e_core


def construct_hf_matrix(no: int, t_h_pq, t_V_pqrs):
    """Fock matrix F_pq = h_pq + Σ_i (2<pi|qi> − <pi|iq>)."""
    f = t_h_pq
    f = f + 2.0 * torch.einsum("piqi->pq", t_V_pqrs[:, :no, :, :no])
    f = f - 1.0 * torch.einsum("piiq->pq", t_V_pqrs[:, :no, :no, :])
    return f


def calcOccupiedOrbE(kinetic_G, t_V_ijkl, no):
    """UEG occupied orbital energies: kinetic + Σ_j (2<ij|ij> − <ij|ji>)."""
    e = torch.as_tensor(kinetic_G, dtype=t_V_ijkl.dtype,
                        device=t_V_ijkl.device)[:no]
    e = e + 2.0 * torch.einsum("ijij->i", t_V_ijkl)
    e = e - 1.0 * torch.einsum("ijji->i", t_V_ijkl)
    return e


def calcVirtualOrbE(kinetic_G, t_V_aibj, t_V_aijb, no, nv):
    """UEG virtual orbital energies: kinetic + Σ_i (2<ai|ai> − <ai|ia>)."""
    e = torch.as_tensor(kinetic_G, dtype=t_V_aibj.dtype,
                        device=t_V_aibj.device)[no:]
    e = e + 2.0 * torch.einsum("aiai->a", t_V_aibj)
    e = e - 1.0 * torch.einsum("aiia->a", t_V_aijb)
    return e
