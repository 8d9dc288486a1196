"""Generic FEAST eigensolver kernel over packed vectors (host numpy/scipy).

Counterpart of ``pymes_tpu/solver/feast_kernel.py``, carried as the port's
own copy so that the port never imports the JAX package.  It is a free
function over an arbitrary ``matvec`` (one packed vector → H·v) and a
preconditioner diagonal, so the same kernel serves

* the port's EOM-CCSD sigma on the card, through the packed-vector
  operator :class:`pymes_tpu_torch.solver.eom_ccsd.PackedSigma` (one
  batched sigma per matvec: a complex vector is its (Re, Im) pair of rows),
* PySCF EOM matvecs when pyscf is importable
  (:mod:`pymes_tpu_torch.solver.feast_eom_rccsd`),
* dense test Hamiltonians.

Features carried over from the reference: window from (emin, emax) or
(e_c, e_r); Gauss-Legendre half-contour; shifted solves with GCROT(m,k)
(scipy, matrix-free) optionally fanned out over quadrature nodes with
joblib; QR of the filtered subspace; projected (non-Hermitian) eigenproblem;
eigenvalue filtering to the window; adaptive radius
``e_r ← sort(|e_c − λ|)[::-1][n_aux] · e_brd``.

joblib's worker processes cannot share a CUDA context, so ``n_jobs != 1``
serves host matvecs only (and needs joblib, which is imported in that
branch alone).  The fan-out of contour nodes over cards is
``FEAST_EOM_CCSD(node_mesh=...)``
(:mod:`pymes_tpu_torch.solver.feast_eom_ccsd`).
"""

import numpy as np
from scipy.linalg import eig
from scipy.sparse.linalg import LinearOperator, gcrotmk

from pymes_tpu_torch.log import print_logging_info, print_title


def _qr_rows(vecs):
    q, _ = np.linalg.qr(np.asarray(vecs).T)
    return [q[:, i] for i in range(q.shape[1])]


def _shifted_solve_gcrotmk(matvec, size, ze, b, diag, ls_max_iter=100,
                           ls_conv_tol=1e-4, phase=None, is_rt=False,
                           dt=None):
    """Solve (z − H)x = phase·b (or (z − i·dt·H)x for RT) matrix-free."""
    rhs = np.asarray(b, dtype=complex)
    if phase is not None:
        rhs = rhs * phase

    if is_rt and dt is not None:
        def mv(x):
            return ze * x - 1j * dt * np.asarray(matvec(x))
    else:
        def mv(x):
            return ze * x - np.asarray(matvec(x))

    A = LinearOperator((size, size), matvec=mv, dtype=complex)
    M_diag = 1.0 / (ze - np.asarray(diag) + 0.01)
    M = LinearOperator((size, size), matvec=lambda x: M_diag * x,
                       dtype=complex)
    x, info = gcrotmk(A, rhs, M=M, maxiter=ls_max_iter, atol=0.0,
                      rtol=ls_conv_tol)
    if info != 0:  # a silently non-converged node corrupts the projector
        import warnings
        rel = np.linalg.norm(mv(x) - rhs) / max(np.linalg.norm(rhs), 1e-300)
        warnings.warn(
            f"FEAST gcrotmk node z={ze:.6g} did not converge in "
            f"{ls_max_iter} iterations (rel. residual {rel:.2e}, "
            f"rtol {ls_conv_tol}) — raise ls_max_iter", stacklevel=2)
    return x


def feast(matvec, diag, size=None, nroots=1, e_r=None, e_c=None, e_brd=1,
          emin=None, emax=None, ngl_pts=8, n_aux=0, guess=None,
          max_cycle=50, conv_tol=1e-7, ls_max_iter=100, ls_conv_tol=1e-4,
          n_jobs=1, seed=None, verbose=True):
    """Run FEAST; returns ``(eigvals, valid_u_vecs)`` like the reference
    kernel (all Ritz values, eigenvectors filtered to the window)."""
    if size is None:
        size = len(np.asarray(diag).ravel())
    diag = np.asarray(diag).ravel()

    user_guess = False
    if emin is not None and emax is not None:
        e_r = (emax - emin) / 2
        e_c = emax - e_r
    elif e_c is not None:
        user_guess = True
    else:
        raise ValueError("e_c or (emin, emax) must be specified.")
    if e_r is None:
        e_r = 1.0

    rng = np.random.default_rng(seed)
    if guess is None:
        u_vec = [0.5 - rng.random(size) for _ in range(nroots + n_aux)]
        u_vec = [g / np.linalg.norm(g) for g in u_vec]
    else:
        u_vec = [np.asarray(g, dtype=float) for g in guess]
        user_guess = True

    x, w = np.polynomial.legendre.leggauss(ngl_pts)
    theta = -np.pi / 2 * (x - 1)

    if verbose:
        print_title("FEAST kernel")
        print_logging_info(f"window: e_c = {e_c}, e_r = {e_r}, "
                           f"nodes = {ngl_pts}, trials = {len(u_vec)}",
                           level=1)

    def contour_filter(u_, z):
        """Q_l = −Σ_e w_e/2 Re[e_r e^{iθ_e}(z_e − H)⁻¹ u_l]."""
        def node(e_i):
            out = []
            for u in u_:
                q = _shifted_solve_gcrotmk(matvec, size, z[e_i], u, diag,
                                           ls_max_iter, ls_conv_tol)
                out.append(-w[e_i] / 2 * np.real(
                    e_r * np.exp(1j * theta[e_i]) * q))
            return out

        if n_jobs != 1:
            from joblib import Parallel, delayed
            per_node = Parallel(n_jobs=n_jobs)(
                delayed(node)(e_i) for e_i in range(len(z)))
        else:
            per_node = [node(e_i) for e_i in range(len(z))]
        Q = [np.zeros(size) for _ in u_]
        for contrib in per_node:
            for l in range(len(u_)):
                Q[l] += contrib[l]
        return Q

    eigvals = np.array([])
    valid_eigvals = np.array([])
    valid_inds = np.array([], dtype=int)
    sort_inds = np.array([], dtype=int)
    e_norm_prev = 1e10
    for it in range(max_cycle):
        z = e_c + e_r * np.exp(1j * theta)
        Q = contour_filter(u_vec, z)
        Q = _qr_rows(Q)

        m = len(Q)
        Hu = [np.asarray(matvec(q)) for q in Q]
        H_proj = np.zeros((m, m), dtype=complex)
        for i in range(m):
            for j in range(m):
                H_proj[j, i] = np.dot(np.conj(Q[j]), Hu[i])
        eigvals, eigvecs = eig(H_proj)
        order = np.argsort(eigvals.real)
        eigvals = eigvals[order]
        eigvecs = eigvecs[:, order]

        valid_inds = np.where((eigvals.real > e_c - e_r)
                              & (eigvals.real < e_c + e_r))[0]
        valid_eigvals = eigvals[valid_inds].real
        sort_inds = np.argsort(valid_eigvals)
        valid_eigvals = valid_eigvals[sort_inds]
        e_norm = np.linalg.norm(valid_eigvals)

        if len(valid_eigvals) == 0 and not user_guess:
            print_logging_info("No valid eigenvalues found in the energy "
                               "window.", level=1)
            return np.array([]), []

        # rotate trials into the Ritz vectors
        u_vec = [np.real(np.asarray(Q).T @ eigvecs[:, l])
                 for l in range(m)]

        # adaptive radius: shrink the contour onto the found cluster
        if n_aux < len(eigvals):
            e_r = np.sort(np.abs(e_c - eigvals))[::-1][n_aux].real * e_brd

        if verbose:
            print_logging_info(
                f"cycle {it}: #eig-in-window = {len(valid_eigvals)}, "
                f"|eig| = {e_norm:.10f}, e_r = {e_r:.6f}", level=1)
        if np.abs(e_norm - e_norm_prev) < conv_tol:
            break
        e_norm_prev = e_norm

    valid_u = [u_vec[valid_inds[i]] for i in sort_inds]
    return eigvals, valid_u


def rt_step(matvec, diag, u_vec, dt=0.1, e_c=0.0, e_r=1.0, ngl_pts=16,
            ls_max_iter=100, ls_conv_tol=1e-4, size=None):
    """One CIF real-time step over a generic matvec: the packed-vector
    counterpart of :meth:`RT_EOM_CCSD.solve` and the backend-agnostic
    rebuild of ``pymes/solver/rt_eom_rccsd.py:20``.

    Returns the (unnormalised) propagated complex vector
    ``∮ e^Z (Z − i·dt·H)⁻¹ u dZ`` on the quadrature contour
    ``Z_e = (i·e_c + e_r e^{iθ_e})·dt``.
    """
    if size is None:
        size = len(np.asarray(diag).ravel())
    diag = np.asarray(diag).ravel()
    x, w = np.polynomial.legendre.leggauss(ngl_pts)
    theta = -np.pi * x
    z = (e_c * 1j + e_r * np.exp(1j * theta)) * dt

    Q = np.zeros(size, dtype=complex)
    for e_i in range(len(z)):
        q = _shifted_solve_gcrotmk(matvec, size, z[e_i], u_vec, diag,
                                   ls_max_iter, ls_conv_tol,
                                   phase=np.exp(z[e_i]), is_rt=True, dt=dt)
        # +w/2: positive contour orientation (see rt_eom_ccsd.solve)
        Q += w[e_i] / 2 * (e_r * dt * np.exp(1j * theta[e_i]) * q)
    return Q
