"""PySCF-bridged FEAST / CIF-RT EOM-CCSD adapters.

Counterpart of ``pymes_tpu/solver/feast_eom_rccsd.py`` (capability parity
with ``pymes/solver/feast_eom_rccsd.py:215`` and
``pymes/solver/rt_eom_rccsd.py:101``): thin classes binding the generic
:mod:`pymes_tpu_torch.solver.feast_kernel` to PySCF's ``EOMEE`` singlet
matvec (packed vector size nov + nov(nov+1)/2).  PySCF is an optional
dependency, so the classes raise a clear ImportError at construction
without it.  Both are host code over whatever ``eom`` they are given; on
the card they are driven with :class:`pymes_tpu_torch.solver.eom_ccsd.
PackedSigma`, which has PySCF's EOM interface shape over the port's
sigma.  The default ``n_jobs=-1`` of ``FEAST_EOMEESinglet.kernel`` fans the
contour nodes out with joblib (host matvecs only); pass ``n_jobs=1`` for a
card-backed ``eom`` or where joblib is absent.
"""

import numpy as np

from pymes_tpu_torch.solver import feast_kernel

try:
    from pyscf.cc import eom_rccsd as _pyscf_eom
except ImportError:  # pragma: no cover - pyscf is optional
    _pyscf_eom = None


def _require_pyscf():
    if _pyscf_eom is None:
        raise ImportError(
            "pymes_tpu_torch.solver.feast_eom_rccsd requires pyscf "
            "(optional dependency, not installed); the generic FEAST "
            "kernel in pymes_tpu_torch.solver.feast_kernel works without "
            "it, and eom= takes any object with PySCF's EOM interface "
            "(e.g. eom_ccsd.PackedSigma).")


class FEAST_EOMEESinglet:
    """FEAST over PySCF's singlet EOM-CCSD matvec (reference API).

    ``eom`` injects any object with the PySCF EOM interface shape
    (``vector_size/get_diag/make_imds/matvec``): a mock, or the port's
    sigma on the card (:class:`~pymes_tpu_torch.solver.eom_ccsd.
    PackedSigma`).
    """

    def __init__(self, cc=None, eom=None):
        if eom is None:
            _require_pyscf()
            eom = _pyscf_eom.EOMEESinglet(cc)
        self._eom = eom
        self.ls_max_iter = 100
        self.ls_conv_tol = 1e-4
        self.max_cycle = 50
        self.conv_tol = 1e-7

    def vector_size(self):
        return self._eom.vector_size()

    def get_diag(self):
        return self._eom.get_diag()[0]

    def kernel(self, nroots=1, e_c=None, e_r=None, e_brd=1, emin=None,
               emax=None, ngl_pts=8, n_aux=0, guess=None, n_jobs=-1,
               **kwargs):
        imds = self._eom.make_imds()
        diag = self.get_diag()

        def matvec(x):
            return self._eom.matvec(x, imds)

        return feast_kernel.feast(
            matvec, diag, size=self.vector_size(), nroots=nroots, e_c=e_c,
            e_r=e_r, e_brd=e_brd, emin=emin, emax=emax, ngl_pts=ngl_pts,
            n_aux=n_aux, guess=guess, max_cycle=self.max_cycle,
            conv_tol=self.conv_tol, ls_max_iter=self.ls_max_iter,
            ls_conv_tol=self.ls_conv_tol, n_jobs=n_jobs)


class CIFRT_EOMEESinglet:
    """CIF real-time propagation over PySCF's singlet matvec
    (reference API: ``rt_eom_rccsd.py:101``)."""

    def __init__(self, cc=None, eom=None):
        if eom is None:
            _require_pyscf()
            eom = _pyscf_eom.EOMEESinglet(cc)
        self._eom = eom
        self.ls_max_iter = 100
        self.ls_conv_tol = 1e-4

    def vector_size(self):
        return self._eom.vector_size()

    def kernel(self, dt=0.1, e_c=None, e_r=None, ngl_pts=16, guess=None,
               **kwargs):
        imds = self._eom.make_imds()
        diag = self._eom.get_diag()[0]

        def matvec(x):
            return self._eom.matvec(x, imds)

        if guess is None:
            rng = np.random.default_rng()
            g = rng.random(self.vector_size()) - 0.5
            guess = [g / np.linalg.norm(g)]
        return feast_kernel.rt_step(
            matvec, diag, guess[0], dt=dt, e_c=e_c, e_r=e_r,
            ngl_pts=ngl_pts, ls_max_iter=self.ls_max_iter,
            ls_conv_tol=self.ls_conv_tol)
