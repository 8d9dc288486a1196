"""The port's generic FEAST kernel (``pymes_tpu_torch/solver/feast_kernel.py``)
and its PySCF-shaped adapters (``solver/feast_eom_rccsd.py``) against the
JAX package's (``pymes_tpu/solver/feast_kernel.py``,
``feast_eom_rccsd.py``), f64 on the CPU:

* the three dense cases of ``tests/test_feast_kernel.py`` with the same
  matvec and seed: eigenvalues and the RT vector within 1e-12 of the JAX
  package's (both are the same host numpy/scipy algorithm; the bound
  leaves room for a BLAS that sums in another order), and the JAX tests'
  tolerances against the exact answers;
* ``n_jobs=2`` (joblib) equal to ``n_jobs=1``;
* H₂/STO-6G: ``feast`` over the port's packed sigma
  (:class:`pymes_tpu_torch.solver.eom_ccsd.PackedSigma`, one batched sigma
  per matvec) within 1e-9 of the JAX generic run over its own sigma with
  the same seed (two sigma implementations: rounding differs at 1e-16 and
  the GCROT solves at ``ls_conv_tol``), both within 1e-6 of the Davidson
  root;
* the packed sigma's rows equal the JAX sigma of the same vector (1e-12
  relative), a complex vector costs one sigma of its (Re, Im) pair;
* the mock adapters of ``tests/test_untested_corners.py`` (1e-7, 1e-6)
  and the pyscf gate.
"""

import os

import numpy as np
import pytest
import scipy.linalg

import jax.numpy as jnp
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.solver import eom_ccsd as jeom
from pymes_tpu.solver import feast_eom_rccsd as jadapt
from pymes_tpu.solver import feast_kernel as jfk
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu_torch import interop
from pymes_tpu_torch.solver import eom_ccsd as teom
from pymes_tpu_torch.solver import feast_eom_rccsd as tadapt
from pymes_tpu_torch.solver import feast_kernel as tfk

DATA = os.path.join(os.path.dirname(__file__), "data")


def _dense_nonsym():
    rng = np.random.default_rng(3)
    dim = 20
    ham = np.diag(np.arange(dim) * 0.3)
    ham += rng.random((dim, dim)) - 0.5
    ham = (ham + ham.T) / 2
    t = np.eye(dim) + rng.random((dim, dim)) * 0.01
    return np.linalg.inv(t) @ ham @ t


def test_feast_dense_matches_jax():
    ham = _dense_nonsym()
    e_all = np.sort(np.linalg.eigvals(ham).real)
    e_c, e_r = 3.15, 0.25
    in_window = e_all[(e_all > e_c - e_r) & (e_all < e_c + e_r)]
    assert len(in_window) == 1
    kw = dict(nroots=2, e_c=e_c, e_r=e_r, max_cycle=50, conv_tol=1e-12,
              seed=4, verbose=False)
    ej, uj = jfk.feast(lambda x: ham @ x, np.diag(ham), **kw)
    et, ut = tfk.feast(lambda x: ham @ x, np.diag(ham), **kw)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-12)
    assert len(ut) == len(uj)
    for a, b in zip(ut, uj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # the JAX test's tolerances against the exact answer
    assert np.min(np.abs(et.real - in_window[0])) < 1e-8
    if len(ut):
        v = ut[0] / np.linalg.norm(ut[0])
        lam = v @ ham @ v
        assert np.linalg.norm(ham @ v - lam * v) < 1e-5


def test_feast_window_from_bounds_matches_jax():
    rng = np.random.default_rng(5)
    dim = 12
    ham = np.diag(np.linspace(0, 5.5, dim)) + 0.01 * rng.random((dim, dim))
    e_all = np.sort(np.linalg.eigvals(ham).real)
    emin, emax = 1.8, 2.8
    in_window = e_all[(e_all > emin) & (e_all < emax)]
    kw = dict(nroots=len(in_window) + 1, emin=emin, emax=emax, max_cycle=60,
              conv_tol=1e-12, seed=0, verbose=False)
    ej, _ = jfk.feast(lambda x: ham @ x, np.diag(ham), **kw)
    et, _ = tfk.feast(lambda x: ham @ x, np.diag(ham), **kw)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-12)
    got = np.sort(et.real[(et.real > emin) & (et.real < emax)])
    assert len(got) >= len(in_window)
    for e in in_window:
        assert np.min(np.abs(got - e)) < 1e-7


def test_rt_step_dense_matches_jax():
    dim = 10
    ham = np.diag(np.linspace(0.0, 2.0, dim))
    rng = np.random.default_rng(2)
    u0 = rng.random(dim) - 0.5
    u0 /= np.linalg.norm(u0)
    dt = 0.1
    kw = dict(dt=dt, e_c=1.0, e_r=1.5, ngl_pts=64, ls_conv_tol=1e-12)
    gj = jfk.rt_step(lambda x: ham @ x, np.diag(ham), u0, **kw)
    gt = tfk.rt_step(lambda x: ham @ x, np.diag(ham), u0, **kw)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12)
    want = scipy.linalg.expm(1j * ham * dt) @ u0
    got = gt / np.linalg.norm(gt)
    want /= np.linalg.norm(want)
    phase = np.vdot(got, want)
    phase /= abs(phase)
    assert np.linalg.norm(got * phase - want) < 1e-7


def test_feast_n_jobs_equals_serial():
    """joblib's fan-out over contour nodes (host matvecs) returns the
    serial result."""
    pytest.importorskip("joblib")
    ham = _dense_nonsym()
    kw = dict(nroots=2, e_c=3.15, e_r=0.25, max_cycle=4, conv_tol=1e-12,
              ngl_pts=4, seed=4, verbose=False)
    e1, u1 = tfk.feast(lambda x: ham @ x, np.diag(ham), n_jobs=1, **kw)
    e2, u2 = tfk.feast(lambda x: ham @ x, np.diag(ham), n_jobs=2, **kw)
    np.testing.assert_allclose(e2, e1, rtol=0, atol=1e-12)
    for a, b in zip(u2, u1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _h2():
    """H₂/STO-6G through the JAX package: CCSD, the T1-dressed Fock and V
    (numpy), T2, and the Davidson root."""
    n_elec, _, _, _, h, V = jfcidump.read(os.path.join(DATA,
                                                       "FCIDUMP.H2.sto6g"))
    no = n_elec // 2
    fock = jhf.construct_hf_matrix(no, h, V)
    cc = jccsd.CCSD(no)
    res = cc.solve(fock, V, delta_e=1e-12, max_iter=100)
    dV = jpart(no, V)
    fd = np.asarray(cc.get_T1_dressed_fock(fock, res["t1"], dV))
    Vd = {k: np.asarray(v) for k, v in
          cc.get_T1_dressed_V(res["t1"], dV).items()}
    t2 = np.asarray(res["t2"])
    e_dav = float(np.real(jeom.EOM_CCSD(no, n_excit=1).solve(fd, Vd,
                                                             t2)[0]))
    return no, fd, Vd, t2, e_dav


def _jax_matvec(fd, Vd, T2, no):
    """The inline matvec of ``tests/test_feast_kernel.py:104-116``."""
    nv = T2.shape[0]
    n1 = nv * no

    def matvec(x):
        u1 = jnp.asarray(x[:n1].reshape(nv, no))
        u2 = jnp.asarray(x[n1:].reshape(nv, nv, no, no))
        w1 = jeom.sigma_singles(fd, Vd, u1, u2, T2)
        w2 = jeom.sigma_doubles(fd, Vd, u1, u2, T2)
        return np.concatenate([np.asarray(w1).ravel(),
                               np.asarray(w2).ravel()])

    diag = np.concatenate([
        np.asarray(jeom.get_diag_singles(fd, Vd, T2)).ravel(),
        np.asarray(jeom.get_diag_doubles(fd, Vd, T2)).ravel()])
    return matvec, diag


def _counted(no):
    class Counted(teom.EOM_CCSD):
        n_sigma = 0

        def _batched_sigma(self, *a):
            self.n_sigma += 1
            return super()._batched_sigma(*a)

    return Counted(no, device="cpu", n_excit=1)


def test_packed_sigma_matches_jax_sigma():
    no, fd, Vd, t2, _ = _h2()
    mv_j, diag_j = _jax_matvec(fd, Vd, t2, no)
    solver = _counted(no)
    op = teom.PackedSigma(solver, fd, interop.eom_operator_from_numpy(
        Vd, "cpu"), t2)
    np.testing.assert_allclose(op.diag, diag_j, rtol=1e-12, atol=0)
    assert op.vector_size() == diag_j.shape[0]
    assert op.get_diag()[0] is op.diag
    x = np.random.default_rng(8).standard_normal(op.vector_size())
    y = np.random.default_rng(9).standard_normal(op.vector_size())
    want = mv_j(x)
    np.testing.assert_allclose(op.matvec(x), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert solver.n_sigma == 1
    got = op.matvec(x + 1j * y, op.make_imds())
    assert solver.n_sigma == 2       # (Re, Im) in one sigma
    want = want + 1j * mv_j(y)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_feast_over_packed_sigma_matches_jax_generic_run():
    """``test_feast_kernel_over_native_sigma`` on both packages."""
    no, fd, Vd, t2, e_dav = _h2()
    kw = dict(nroots=2, e_c=e_dav, e_r=0.2, max_cycle=40, conv_tol=1e-10,
              ls_max_iter=100, seed=3, verbose=False)
    mv_j, diag_j = _jax_matvec(fd, Vd, t2, no)
    ej, _ = jfk.feast(mv_j, diag_j, **kw)
    op = teom.PackedSigma(_counted(no), fd, interop.eom_operator_from_numpy(
        Vd, "cpu"), t2)
    et, _ = tfk.feast(op.matvec, op.diag, **kw)
    assert et.shape == ej.shape
    np.testing.assert_allclose(np.sort_complex(et), np.sort_complex(ej),
                               rtol=0, atol=1e-9)
    for e in (ej, et):
        assert np.min(np.abs(e.real - e_dav)) < 1e-6


class _MockPyscfEOM:
    """The PySCF EOM interface shape over a dense matrix
    (``tests/test_untested_corners.py:39-57``)."""

    def __init__(self, ham):
        self.ham = ham

    def vector_size(self):
        return self.ham.shape[0]

    def get_diag(self):
        return (self.ham.diagonal().copy(), None)

    def make_imds(self):
        return "imds"

    def matvec(self, x, imds=None):
        assert imds == "imds"
        return self.ham @ x


def test_feast_adapter_against_mock():
    rng = np.random.default_rng(5)
    dim = 24
    ham = np.diag(np.arange(dim) * 0.4)
    ham += 0.03 * (rng.random((dim, dim)) - 0.5)
    ham = (ham + ham.T) / 2
    target = np.sort(np.linalg.eigvals(ham).real)[4]
    solver = tadapt.FEAST_EOMEESinglet(eom=_MockPyscfEOM(ham))
    assert (solver.ls_max_iter, solver.ls_conv_tol, solver.max_cycle,
            solver.conv_tol) == (100, 1e-4, 50, 1e-7)
    assert solver.vector_size() == dim
    eigvals, _ = solver.kernel(nroots=1, e_c=target, e_r=0.15, ngl_pts=8,
                               n_jobs=1)
    assert np.min(np.abs(np.real(eigvals) - target)) < 1e-7
    ref = jadapt.FEAST_EOMEESinglet(eom=_MockPyscfEOM(ham))
    ej, _ = ref.kernel(nroots=1, e_c=target, e_r=0.15, ngl_pts=8, n_jobs=1)
    assert eigvals.shape == ej.shape


def test_cifrt_adapter_against_mock():
    rng = np.random.default_rng(6)
    dim = 12
    ham = np.diag(np.linspace(0.0, 1.5, dim))
    ham += 0.02 * (lambda a: (a + a.T) / 2)(rng.random((dim, dim)) - 0.5)
    u0 = rng.random(dim) - 0.5
    u0 /= np.linalg.norm(u0)
    dt = 0.1
    solver = tadapt.CIFRT_EOMEESinglet(eom=_MockPyscfEOM(ham))
    assert (solver.ls_max_iter, solver.ls_conv_tol) == (100, 1e-4)
    solver.ls_conv_tol = 1e-12
    got = np.asarray(solver.kernel(dt=dt, e_c=0.75, e_r=1.0, ngl_pts=64,
                                   guess=[u0.astype(complex)]))
    got /= np.linalg.norm(got)
    want = scipy.linalg.expm(1j * ham * dt) @ u0
    want /= np.linalg.norm(want)
    phase = np.vdot(got, want)
    phase /= np.abs(phase)
    assert np.linalg.norm(got * phase - want) < 1e-6


def test_pyscf_adapter_gated():
    for cls in (tadapt.FEAST_EOMEESinglet, tadapt.CIFRT_EOMEESinglet):
        with pytest.raises(ImportError):
            cls(None)
