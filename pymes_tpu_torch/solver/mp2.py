"""MP2 — second-order Møller-Plesset perturbation theory.

Counterpart of ``pymes_tpu/solver/mp2.py``: non-Hermitian-safe (``V_ijab``
and ``V_abij`` are independent inputs).  The doubles amplitudes double as
the initial guess of the CC solvers.  :func:`solve_blocked` streams chunks of
the first virtual axis in a Python loop (the JAX package's ``lax.map``).
"""

import torch


def _denominator(eps_i, eps_a_rows, eps_a):
    return (eps_i[None, None, :, None] + eps_i[None, None, None, :]
            - eps_a_rows[:, None, None, None] - eps_a[None, :, None, None])


def solve(t_epsilon_i, t_epsilon_a, t_V_ijab, t_V_abij, level_shift=0.0,
          **kwargs):
    """MP2 energy and amplitudes: T_abij = V_abij / (D_abij + shift).

    Returns ``[e_mp2, T_abij]`` like the reference."""
    t_T_abij = t_V_abij / (_denominator(t_epsilon_i, t_epsilon_a,
                                        t_epsilon_a) + level_shift)
    e_dir = 2.0 * torch.einsum("abij,ijab->", t_T_abij, t_V_ijab)
    e_exc = -1.0 * torch.einsum("abij,jiab->", t_T_abij, t_V_ijab)
    return [e_dir + e_exc, t_T_abij]


def solve_blocked(t_epsilon_i, t_epsilon_a, t_V_ijab, t_V_abij,
                  level_shift=0.0, nv_part_size=None, **kwargs):
    """Memory-bounded MP2 energy over chunks of the first virtual axis;
    returns the energy only (the amplitudes are never whole)."""
    nv = t_epsilon_a.shape[0]
    if nv_part_size is None:
        nv_part_size = nv
    e = torch.zeros((), dtype=t_V_abij.dtype, device=t_V_abij.device)
    for lo in range(0, nv, int(nv_part_size)):
        hi = min(lo + int(nv_part_size), nv)
        D = _denominator(t_epsilon_i, t_epsilon_a[lo:hi], t_epsilon_a)
        T = t_V_abij[lo:hi] / (D + level_shift)
        Vij = t_V_ijab[:, :, lo:hi]
        e = e + 2.0 * torch.einsum("abij,ijab->", T, Vij)
        e = e - 1.0 * torch.einsum("abij,jiab->", T, Vij)
    return e
