"""The port's CIF real-time EOM-CCSD (``pymes_tpu_torch/solver/
rt_eom_ccsd.py``) against exact propagation and the JAX package, f64 on
the CPU (the kernels' twins):

* a Hermitian model Hamiltonian through the ``_batched_sigma`` hook: one
  step equals ``expm(iH·dt)·u`` (normalised, up to a global phase) within
  1e-7 at 64 quadrature nodes;
* five steps keep unit norm and |c(t)| ≤ 1;
* H₂/STO-6G from the Davidson eigenvector: the port's (q1, q2) after each
  of 3 steps within 1e-10 of the JAX package's (its f64 Krylov path, the
  same restart and tolerance).
"""

import os

import numpy as np
import scipy.linalg
import torch

from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.solver import eom_ccsd as jeom
from pymes_tpu.solver import rt_eom_ccsd as jrt
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.solver import rt_eom_ccsd as trt

DATA = os.path.join(os.path.dirname(__file__), "data")


class _MatrixRT(trt.RT_EOM_CCSD):
    """The port's RT step on a dense model H̄ through the EOM hooks."""

    def __init__(self, no, ham, **kw):
        super().__init__(no, "cpu", **kw)
        self.ham = ham

    def _batched_sigma(self, f, dict_t_V, U1, U2, T2):
        m, nv = U1.shape[0], U1.shape[1]
        W = torch.cat([U1.reshape(m, -1), U2.reshape(m, -1)], 1).numpy() \
            @ self.ham.T
        return (W[:, :nv * self.no].reshape(m, nv, self.no),
                W[:, nv * self.no:].reshape(m, nv, nv, self.no, self.no))

    def get_diag_singles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[: nv * self.no].reshape(nv, self.no)

    def get_diag_doubles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[nv * self.no:].reshape(nv, nv, self.no,
                                                          self.no)


def _model(seed, coupling):
    rng = np.random.default_rng(seed)
    no, nv = 1, 3
    dim = nv * no + (nv * no) ** 2
    ham = np.diag(np.linspace(0.0, 2.0, dim))
    ham += coupling * (lambda a: (a + a.T) / 2)(rng.random((dim, dim)) - 0.5)
    u0 = rng.random(dim) - 0.5
    u0 /= np.linalg.norm(u0)
    op = (np.zeros((no + nv, no + nv)),
          tpart(no, torch.zeros((no + nv,) * 4, dtype=torch.float64)),
          np.zeros((nv, nv, no, no)))
    return ham, u0, no, nv, op


def test_rt_model_hamiltonian_matches_expm():
    ham, u0, no, nv, op = _model(11, 0.05)
    dt = 0.1
    s = _MatrixRT(no, ham, e_c=1.0, e_r=1.5, n_quad=64, ls_conv_tol=1e-13)
    q1, q2 = s.solve(*op, dt=dt, u_singles=u0[: nv * no].reshape(nv, no),
                     u_doubles=u0[nv * no:].reshape(nv, nv, no, no))
    got = np.concatenate([q1.ravel(), q2.ravel()])
    want = scipy.linalg.expm(1j * ham * dt) @ u0
    want /= np.linalg.norm(want)
    phase = np.vdot(got, want)
    phase /= np.abs(phase)
    assert np.linalg.norm(got * phase - want) < 1e-7
    assert s.ls_stats["calls"] > 0 and s.ls_stats["chunks"] == 1


def test_rt_five_steps_norm_and_autocorrelation():
    ham, u0, no, nv, op = _model(13, 0.0)
    dt = 0.2
    u1 = u0[: nv * no].reshape(nv, no).astype(complex)
    u2 = u0[nv * no:].reshape(nv, nv, no, no).astype(complex)
    s = _MatrixRT(no, ham, e_c=1.0, e_r=1.5, n_quad=64, ls_conv_tol=1e-12)
    for _ in range(5):
        u1, u2 = s.solve(*op, dt=dt, u_singles=u1, u_doubles=u2)
        norm = np.vdot(u1, u1).real + np.vdot(u2, u2).real
        assert abs(norm - 1.0) < 1e-10
        c_t = np.tensordot(u0[: nv * no].reshape(nv, no), u1, axes=2) \
            + np.tensordot(u0[nv * no:].reshape(nv, nv, no, no), u2, axes=4)
        assert abs(c_t) <= 1.0 + 1e-10


def test_rt_h2_steps_match_jax():
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
    dav = jeom.EOM_CCSD(no, n_excit=1)
    omega = float(np.real(dav.solve(fd, Vd, t2)[0]))
    u1 = np.asarray(dav.u_singles[0]).astype(complex)
    u2 = np.asarray(dav.u_doubles[0]).astype(complex)

    kw = dict(e_c=omega, e_r=0.5, n_quad=32, ls_conv_tol=1e-12)
    js = jrt.RT_EOM_CCSD(no, **kw)
    js.ls_precision = "f64"
    js.ls_backend = "inhouse"
    js.max_nodes_per_dispatch = None
    ts = trt.RT_EOM_CCSD(no, "cpu", **kw)
    for s in (js, ts):
        s.ls_restart = 20
        s.ls_max_iter = 100
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    dt = 0.1
    qj, qt = (u1, u2), (u1, u2)
    c_prev = 1.0
    for _ in range(3):
        qj = js.solve(fd, Vd, t2, dt=dt, u_singles=qj[0], u_doubles=qj[1])
        qt = ts.solve(fd, Vt, t2, dt=dt, u_singles=qt[0], u_doubles=qt[1])
        for a, b in zip(qt, qj):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10)
        c_t = np.tensordot(u1, qt[0], axes=2) + np.tensordot(u2, qt[1],
                                                             axes=4)
        # the CIF contour is exp(+iH̄t): each step advances by e^{iω dt}
        assert abs(c_t / c_prev - np.exp(1j * omega * dt)) < 1e-8
        c_prev = c_t
