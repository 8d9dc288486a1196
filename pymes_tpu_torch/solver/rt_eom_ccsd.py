"""Real-time EOM-CCSD dynamics via the Cauchy-integral (CIF) propagator.

Counterpart of ``pymes_tpu/solver/rt_eom_ccsd.py``: one time step
propagates the linear-ansatz coefficients with
``exp(iH̄dt)·u = ∮ e^Z (Z − iH̄dt)⁻¹ u dZ``, evaluated by Gauss-Legendre
quadrature on the circle ``Z_e = (i·e_c + e_r e^{iθ_e})·dt``, θ = −πx;
each node is a shifted solve with operator ``Z x − i·dt·H̄x`` and
right-hand side ``e^{Z_e}·u``, and the quadrature sum is normalised.  The
node solves are the lanes of the FEAST machinery
(:class:`pymes_tpu_torch.solver.feast_eom_ccsd.FEAST_EOM_CCSD`) in its RT
variant: K8 assembles M(Z x − i·dt·H̄x) with M = 1/(Z + 0.01 − i·dt·diag).
``ls_precision="mixed"`` (through ``**kwargs`` or as an attribute) runs
the node solves in the FEAST machinery's mixed engine, f32 Krylov inside
f64 iterative refinement, as the JAX package's default RT does
(``rt_eom_ccsd.py:74-80``); the f32 copy of the operator is made once and
kept across the steps of one operator.
"""

import time

import numpy as np
import torch

from pymes_tpu_torch.log import print_logging_info, print_title
from pymes_tpu_torch.solver.feast_eom_ccsd import (
    FEAST_EOM_CCSD, get_gauss_legendre_quadrature, normalize_amps)


class RT_EOM_CCSD(FEAST_EOM_CCSD):
    """One CIF real-time propagation step per ``solve`` call on ``device``
    (reference API: ``rt_eom_ccsd.py:28``)."""

    def __init__(self, no, device, e_c=0.0, e_r=1.0, dt=0.1, tol=1e-12,
                 max_iter=100, n_quad=8, **kwargs):
        super().__init__(no, device, e_c=e_c, e_r=e_r, max_iter=max_iter,
                         tol=tol, n_quad=n_quad, **kwargs)
        self.dt = dt
        self.u_singles = None
        self.u_doubles = None

    def solve(self, t_fock_dressed_pq, dict_t_V_dressed, t_T_abij, dt=0.1,
              u_singles=None, u_doubles=None):
        """Propagate (u1, u2) by one step ``dt``; returns the normalised new
        coefficients (complex numpy)."""
        print_title("RT-EOM-CCSD Solver")
        time_init = time.time()
        if u_singles is None or u_doubles is None:
            raise RuntimeError("No initial state specified!")
        no = self.no
        op = self._operator(t_fock_dressed_pq, dict_t_V_dressed, t_T_abij)
        self._budget = self._krylov_budgets()
        self._new_stats()
        nv = op[2].shape[0]
        n1 = nv * no

        x, w = get_gauss_legendre_quadrature(self.n_quad)
        theta = -np.pi * x
        z = (self.e_c * 1j + self.e_r * np.exp(1j * theta)) * dt
        # +w/2: the θ = −πx parametrisation walks the contour clockwise;
        # the positive-orientation residue sum makes one step exactly
        # e^{+iH̄dt}·u (rt_eom_ccsd.py:61-65)
        node_w = w / 2 * (self.e_r * dt * np.exp(1j * theta))

        b = np.concatenate([np.ravel(u_singles), np.ravel(u_doubles)])
        b = b.astype(complex)
        N = b.shape[0]
        dev = self.device
        br, bi = (torch.as_tensor(p, device=dev) for p in (b.real, b.imag))
        ph = np.exp(z)
        pr = torch.as_tensor(ph.real, device=dev)[:, None]
        pim = torch.as_tensor(ph.imag, device=dev)[:, None]
        # per-node right-hand sides e^{z_e}·b (_broadcast_rhs, :301)
        B = torch.cat([pr * br[None] - pim * bi[None],
                       pr * bi[None] + pim * br[None]], dim=1)
        X, rel = self._solve_lanes(
            op, B, torch.as_tensor(z.real, device=dev),
            torch.as_tensor(z.imag, device=dev), rt=True, dt=dt)
        self._warn_unconverged(rel)
        Qr = torch.zeros(N, dtype=torch.float64, device=dev)
        Qi = torch.zeros_like(Qr)
        for e in range(len(z)):
            wr, wi = float(node_w[e].real), float(node_w[e].imag)
            xr, xi = X[e, :N], X[e, N:]
            Qr = Qr + (wr * xr - wi * xi)
            Qi = Qi + (wr * xi + wi * xr)
        Q = Qr.cpu().numpy() + 1j * Qi.cpu().numpy()

        q1, q2 = normalize_amps(Q[:n1].reshape(nv, no),
                                Q[n1:].reshape(nv, nv, no, no))
        self.u_singles = [q1]
        self.u_doubles = [q2]
        print_logging_info(
            f"RT-EOM-CCSD finished in {time.time() - time_init:.2f} "
            "seconds.", level=0)
        return q1, q2
