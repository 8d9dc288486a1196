"""The port's FEAST-EOM-CCSD (``pymes_tpu_torch/solver/feast_eom_ccsd.py``)
against the JAX package's f64 Krylov path (``ls_precision="f64"``,
``ls_backend="inhouse"``, ``max_nodes_per_dispatch=None``) and exact
answers, f64 on the CPU (the kernels' twins):

* H₂/STO-6G: the window roots after a fixed 3 iterations, same seed and
  explicit restart, within 1e-8 of the JAX package's;
* a fake non-symmetric Hamiltonian through the ``_batched_sigma`` hook:
  the window eigenvalue of ``np.linalg.eigvals`` within 1e-8;
* the "replace" update with m_eff < m: the port keeps exactly the Ritz
  vectors, the JAX package a stale slot (its fault at
  ``feast_eom_ccsd.py:951-958``);
* UEG nP=19 no-ovvv operator: one shifted solve (FEAST and RT operator)
  within 1e-10 of JAX ``_shifted_solve`` and the honest residual equal to
  ``_residual_nodes``; no-ovvv FEAST equal to dense FEAST after 2
  iterations within 1e-8;
* the node fan-out ``node_mesh`` on ``["cpu"] * P`` (P = 2, 4 divide the
  8 nodes, P = 3 does not and replicates): H₂ FEAST (the settings of
  ``tests/test_feast_rt.py:302-326``) and three H₂ RT steps within 1e-10
  of the port's unsharded run and of the JAX package's f64 node-mesh run
  on a mesh of P virtual devices, in the same iterations, each device
  solving its share of the lanes in one chunk.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.solver import eom_ccsd as jeom
from pymes_tpu.parallel import mesh as jmesh
from pymes_tpu.solver import feast_eom_ccsd as jfeast
from pymes_tpu.solver import rt_eom_ccsd as jrt
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.ops import gmres as tgmres
from pymes_tpu_torch.parallel import mesh as tmesh
from pymes_tpu_torch.solver import eom_ccsd as teom
from pymes_tpu_torch.solver import feast_eom_ccsd as tfeast
from pymes_tpu_torch.solver import rt_eom_ccsd as trt

DATA = os.path.join(os.path.dirname(__file__), "data")
NO = 7
MF_DROP = ("abcd", "iabc", "abic", "aibc", "abci")


def _h2_dressed():
    """H₂/STO-6G through the JAX package: CCSD, the T1-dressed Fock and V,
    T2, and the Davidson root (numpy)."""
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
    e_dav = float(np.real(jeom.EOM_CCSD(no, n_excit=1).solve(fd, Vd, t2)[0]))
    return no, fd, Vd, t2, e_dav


def _jax_feast(no, **kw):
    s = jfeast.FEAST_EOM_CCSD(no, **kw)
    s.ls_precision = "f64"
    s.ls_backend = "inhouse"
    s.max_nodes_per_dispatch = None
    return s


def test_h2_window_same_roots_as_jax():
    no, fd, Vd, t2, e_dav = _h2_dressed()
    kw = dict(e_c=e_dav, e_r=0.2, n_trial=2, max_iter=3, tol=-1.0, seed=1,
              ls_conv_tol=1e-10)
    js = _jax_feast(no, **kw)
    ts = tfeast.FEAST_EOM_CCSD(no, "cpu", **kw)
    for s in (js, ts):
        s.ls_restart = 20
        s.ls_max_iter = 50
    ej = np.sort_complex(np.asarray(js.solve(fd, Vd, t2)))
    et = np.sort_complex(ts.solve(fd, interop.eom_operator_from_numpy(
        Vd, "cpu"), t2))
    assert ts.n_iterations == len(js.iter_walls) == 3
    assert et.shape == ej.shape
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-8)
    assert np.min(np.abs(et.real - e_dav)) < 1e-8
    assert np.max(ts.last_ls_residuals) < 1e-9


@pytest.mark.parametrize("backend", ["opt", "jacobi"])
def test_h2_window_other_backends(backend):
    """"opt" (the in-house GMRES under the reference's name) and "jacobi"
    (lane-batched Richardson) find the H₂ window root, as the JAX
    package's backends do (tests/test_feast_rt.py)."""
    no, fd, Vd, t2, e_dav = _h2_dressed()
    s = tfeast.FEAST_EOM_CCSD(no, "cpu", e_c=e_dav, e_r=0.2, n_trial=2,
                              max_iter=50, tol=1e-10, seed=1)
    s.ls_backend = backend
    s.ls_max_iter = 50
    ev = s.solve(fd, interop.eom_operator_from_numpy(Vd, "cpu"), t2)
    assert np.min(np.abs(np.real(ev) - e_dav)) < 1e-5


def test_h2_krylov_budget_changes_batching_not_roots():
    """A Krylov budget of one lane per chunk gives the roots of the
    default single chunk."""
    no, fd, Vd, t2, e_dav = _h2_dressed()
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    out = {}
    for budget in (None, 1.0):
        s = tfeast.FEAST_EOM_CCSD(no, "cpu", e_c=e_dav, e_r=0.2, n_trial=2,
                                  max_iter=8, tol=1e-10, seed=1)
        s.ls_max_iter = 50
        s.krylov_mem_budget_bytes = budget
        out[budget] = (np.sort_complex(s.solve(fd, Vt, t2)),
                       s.ls_stats["chunks"])
    assert out[1.0][1] > out[None][1]
    np.testing.assert_allclose(out[1.0][0], out[None][0], rtol=0,
                               atol=1e-12)


def test_explicit_device_required():
    from pymes_tpu_torch.solver import rt_eom_ccsd
    with pytest.raises(ValueError):
        tfeast.FEAST_EOM_CCSD(1, None)
    if not torch.cuda.is_available():
        for cls in (tfeast.FEAST_EOM_CCSD, rt_eom_ccsd.RT_EOM_CCSD):
            with pytest.raises(RuntimeError):
                cls(1, "cuda")


def _fake_nonsym_ham(rng, dim):
    ham = np.diag(np.arange(dim) * 0.3)
    ham += rng.random((dim, dim)) - 0.5
    ham = (ham + ham.T) / 2
    t = np.eye(dim) + rng.random((dim, dim)) * 0.01
    return np.linalg.inv(t) @ ham @ t


def _apply(ham, no, U1, U2):
    m, nv = U1.shape[0], U1.shape[1]
    U = np.concatenate([np.reshape(U1, (m, -1)), np.reshape(U2, (m, -1))],
                       axis=1)
    W = U @ ham.T
    return (W[:, :nv * no].reshape(m, nv, no),
            W[:, nv * no:].reshape(m, nv, nv, no, no))


class _MatrixFEAST(tfeast.FEAST_EOM_CCSD):
    """The port's FEAST on a dense fake H̄ through the EOM hooks."""

    def __init__(self, no, ham, **kw):
        super().__init__(no, "cpu", **kw)
        self.ham = ham

    def _batched_sigma(self, f, dict_t_V, U1, U2, T2):
        return _apply(self.ham, self.no, U1.numpy(), U2.numpy())

    def get_diag_singles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[: nv * self.no].reshape(nv, self.no)

    def get_diag_doubles(self, f, dict_t_V, T2):
        nv = T2.shape[0]
        return self.ham.diagonal()[nv * self.no:].reshape(nv, nv, self.no,
                                                          self.no)


class _JaxMatrixFEAST(jfeast.FEAST_EOM_CCSD):
    """The JAX package's fake-Hamiltonian harness (tests/test_feast_rt.py):
    exact node solves, dense projected H."""

    def __init__(self, no, ham, **kw):
        super().__init__(no, **kw)
        self.ham = ham

    def _solve_node(self, f, dict_t_V, T2, b, ze, diag_vec, nv,
                    is_rt=False, dt=0.0, phase=None):
        return np.linalg.solve(ze * np.eye(self.ham.shape[0]) - self.ham, b)

    def _apply_H(self, f, dict_t_V, u1, u2, T2):
        w1, w2 = _apply(self.ham, self.no, u1[None], u2[None])
        return w1[0], w2[0]


def _zero_operator(no, nv, jax=False):
    V = (jpart(no, np.zeros((no + nv,) * 4)) if jax else
         tpart(no, torch.zeros((no + nv,) * 4, dtype=torch.float64)))
    return np.zeros((no + nv, no + nv)), V, np.zeros((nv, nv, no, no))


def test_fake_nonsymmetric_hamiltonian_window():
    """The window [2.9, 3.4] of a random non-symmetric H̄ holds one
    eigenvalue; FEAST through the port's GMRES finds it to 1e-8."""
    rng = np.random.default_rng(3)
    no, nv = 1, 4
    ham = _fake_nonsym_ham(rng, nv * no + (nv * no) ** 2)
    e_all = np.sort(np.linalg.eigvals(ham).real)
    e_c, e_r = 3.15, 0.25
    inside = e_all[(e_all > e_c - e_r) & (e_all < e_c + e_r)]
    assert len(inside) == 1
    s = _MatrixFEAST(no, ham, e_c=e_c, e_r=e_r, n_trial=2, max_iter=100,
                     tol=1e-12, seed=5, ls_conv_tol=1e-11)
    ev = s.solve(*_zero_operator(no, nv))
    assert np.min(np.abs(np.real(ev) - inside[0])) < 1e-8
    assert s.ls_stats["calls"] > 0


def test_replace_keeps_no_stale_trial_slot():
    """With the SVD truncation at m_eff = 1 < m = 2, the JAX package's
    "replace" step rewrites slot 0 only and carries the stale QR'd trial
    of slot 1 into the next filter pass; the port's trial set is exactly
    the one Ritz vector, the same as the JAX slot 0."""
    rng = np.random.default_rng(3)
    no, nv = 1, 4
    ham = _fake_nonsym_ham(rng, nv * no + (nv * no) ** 2)
    kw = dict(e_c=3.15, e_r=0.25, n_trial=2, max_iter=1, tol=1e-12, seed=5,
              n_excit=2, ls_conv_tol=1e-11)
    out = {}
    for name, cls in (("jax", _JaxMatrixFEAST), ("torch", _MatrixFEAST)):
        s = cls(no, ham, **kw)
        s.svd_drop_tol = 0.5
        ev = s.solve(*_zero_operator(no, nv, jax=name == "jax"))
        out[name] = (ev, [np.concatenate([np.ravel(a), np.ravel(b)])
                          for a, b in zip(s.u_singles, s.u_doubles)])
    (ej, uj), (et, ut) = out["jax"], out["torch"]
    assert len(ej) == len(et) == 1
    np.testing.assert_allclose(et, ej, atol=1e-9)
    assert len(uj) == 2 and len(ut) == 1
    sign = np.sign(uj[0] @ ut[0])
    np.testing.assert_allclose(sign * ut[0], uj[0], atol=1e-9)
    # the JAX slot 1 is a stale trial, far from the Ritz vector's span
    assert abs(uj[1] @ uj[0]) / np.linalg.norm(uj[1]) < 0.5


# ---- UEG nP=19: the no-ovvv operator ---------------------------------------

@pytest.fixture(scope="module")
def ueg19():
    """UEG 14e, rs=1.0, cutoff 2 (nP=19): seeded T2, the bare dense blocks
    and the no-ovvv operator (all-bra plan + OVVV plans) of the JAX
    package, as numpy."""
    u = jueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    nv = u.n_spatial - NO
    fock = np.asarray(jhf.construct_hf_matrix(
        NO, np.diag(u.kinetic_energies()), V))
    rng = np.random.default_rng(8)
    T2 = rng.standard_normal((nv, nv, NO, NO)) * 0.02
    T2 = 0.5 * (T2 + T2.transpose(1, 0, 3, 2))
    dense = {k: np.asarray(v) for k, v in jpart(NO, jnp.asarray(V)).items()}
    mf = {k: v for k, v in dense.items() if k not in MF_DROP}
    mf.update(abcd=None, abcd_ladder=jladder.build_block_ladder(u, bra="all"),
              _ovvv_plans=jladder.build_ovvv_plans(u))
    return dict(fock=fock, T2=T2, dense=dense, mf=mf, nv=nv)


@pytest.mark.parametrize("rt", [False, True])
def test_ueg19_shifted_solve_and_residual_match_jax(ueg19, rt):
    """(z − H̄)x = b (and the RT operator) on the no-ovvv operator: x
    within 1e-10 of JAX ``_shifted_solve``, the honest residual equal to
    ``_residual_nodes`` on the same x."""
    f, T2, nv = ueg19["fock"], ueg19["T2"], ueg19["nv"]
    N = nv * NO + nv * nv * NO * NO
    b = np.random.default_rng(4).standard_normal(N)
    b /= np.linalg.norm(b)
    z, dt = (0.3 + 0.4j, 0.0) if not rt else (0.05 + 0.1j, 0.1)
    kw = dict(ls_max_iter=20, restart=30, ls_conv_tol=1e-11)

    Vj = ueg19["mf"]
    fj, Tj = jnp.asarray(f), jnp.asarray(T2)
    hbar = jeom.build_hbar(fj, Vj, Tj, contract_mode="xla")
    diag = jnp.asarray(np.concatenate([
        np.ravel(jeom.get_diag_singles(fj, Vj, Tj)),
        np.ravel(jeom.get_diag_doubles(fj, Vj, Tj))]))
    zp = (jnp.asarray(z.real), jnp.asarray(z.imag))
    (xr, xi), _ = jfeast._shifted_solve(
        fj, Vj, Tj, (jnp.asarray(b), jnp.zeros(N)), zp, diag, NO, nv,
        is_rt=rt, dt=dt, hbar=hbar, contract_mode="xla",
        linear_solver="inhouse", **kw)
    xj = np.concatenate([np.asarray(xr), np.asarray(xi)])

    s = tfeast.FEAST_EOM_CCSD(NO, "cpu")
    op = s._operator(f, interop.eom_operator_from_numpy(Vj, "cpu"), T2)
    node = tfeast._NodeOps(s, op, torch.tensor([z.real], dtype=torch.float64),
                           torch.tensor([z.imag], dtype=torch.float64), rt,
                           dt)
    B = torch.zeros((1, 2 * N), dtype=torch.float64)
    B[0, :N] = torch.as_tensor(b)
    x, _, info = tgmres.gmres_lanes(node.apply, B, node.precond,
                                    tol=kw["ls_conv_tol"],
                                    restart=kw["restart"],
                                    max_outer=kw["ls_max_iter"])
    np.testing.assert_allclose(x[0].numpy(), xj, rtol=0, atol=1e-10)
    assert np.abs(xj).max() > 0.01 and info["steps"][0] > 30

    r, res, bn = node.residual(x, torch.arange(1), B)
    x_t = x[0].numpy()
    rel_j, rr, ri = jfeast._residual_nodes(
        fj, Vj, Tj, (jnp.asarray(x_t[None, :N]), jnp.asarray(x_t[None, N:])),
        (jnp.asarray(b[None]), jnp.zeros((1, N))),
        (zp[0][None], zp[1][None]), diag, NO, nv, is_rt=rt, dt=dt, hbar=hbar,
        contract_mode="xla")
    rel_t = float(res[0] / bn[0])
    assert rel_t < 1e-10
    assert abs(rel_t - float(rel_j[0])) <= 1e-12
    np.testing.assert_allclose(
        r[0].numpy(), np.concatenate([np.asarray(rr[0]), np.asarray(ri[0])]),
        rtol=0, atol=1e-13)


def test_ueg19_no_ovvv_feast_equals_dense(ueg19):
    """The same window, seed and backend through the dense blocks and the
    no-ovvv operator: the same roots after 2 iterations (the two sigmas
    agree to rounding, so the trajectories do)."""
    f, T2 = ueg19["fock"], ueg19["T2"]
    ops = {"dense": interop.eom_operator_from_numpy(ueg19["dense"], "cpu"),
           "no_ovvv": interop.eom_operator_from_numpy(ueg19["mf"], "cpu")}
    dav = teom.EOM_CCSD(NO, "cpu", n_excit=1)
    e0 = float(dav.solve(f, ops["no_ovvv"], T2)[0])
    roots = {}
    for name, V in ops.items():
        s = tfeast.FEAST_EOM_CCSD(NO, "cpu", e_c=e0, e_r=0.3, n_trial=2,
                                  max_iter=2, tol=-1.0, seed=3,
                                  ls_conv_tol=1e-8)
        s.ls_restart = 40
        s.ls_max_iter = 4
        roots[name] = np.sort_complex(s.solve(f, V, T2))
        assert s.n_iterations == 2
    np.testing.assert_allclose(roots["no_ovvv"], roots["dense"], rtol=0,
                               atol=1e-8)


# ---- the node fan-out over a device mesh -----------------------------------

def _f64(s):
    """The JAX package's f64 Krylov path, the one its node mesh shards."""
    s.ls_precision = "f64"
    s.ls_backend = "inhouse"
    s.max_nodes_per_dispatch = None
    return s


def _lanes_per_chunk(s):
    return [len(np.atleast_1d(a)) for a in s.ls_stats["steps"]]


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_h2_node_mesh_feast_matches_unsharded_and_jax(n_dev):
    no, fd, Vd, t2, e_dav = _h2_dressed()
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    kw = dict(e_c=e_dav, e_r=0.2, n_trial=2, max_iter=50, tol=1e-10, seed=1)
    out = {}
    for mesh in (None, tmesh.make_mesh(n_dev, "cpu",
                                       devices=["cpu"] * n_dev)):
        s = tfeast.FEAST_EOM_CCSD(no, "cpu", node_mesh=mesh, **kw)
        s.ls_max_iter = 50
        out[mesh is None] = (np.sort_complex(s.solve(fd, Vt, t2)), s)
    (ref, s0), (got, s) = out[True], out[False]
    assert s.node_axis == "a" and s.n_iterations == s0.n_iterations
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    # one chunk a device and iteration: its share of the 8 x 2 lanes, or
    # all of them on every replica where 8 nodes do not divide the mesh
    share = 16 // n_dev if 8 % n_dev == 0 else 16
    assert _lanes_per_chunk(s) == [share] * (n_dev * s.n_iterations)

    js = _f64(jfeast.FEAST_EOM_CCSD(
        no, node_mesh=jmesh.make_mesh(n_dev, axis_names=("a",)), **kw))
    js.ls_max_iter = 50
    ej = np.sort_complex(np.asarray(js.solve(fd, Vd, t2)))
    assert len(js.iter_walls) == s.n_iterations
    np.testing.assert_allclose(got, ej, rtol=0, atol=1e-10)
    assert np.min(np.abs(got.real - e_dav)) < 1e-10


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_h2_node_mesh_rt_matches_unsharded_and_jax(n_dev):
    """RT_EOM_CCSD takes node_mesh through **kwargs, as the JAX package's
    subclass does; three steps from the Davidson vector."""
    no, fd, Vd, t2, _ = _h2_dressed()
    dav = jeom.EOM_CCSD(no, n_excit=1)
    omega = float(np.real(dav.solve(fd, Vd, t2)[0]))
    u = (np.asarray(dav.u_singles[0]).astype(complex),
         np.asarray(dav.u_doubles[0]).astype(complex))
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    kw = dict(e_c=omega, e_r=0.5, n_quad=32, ls_conv_tol=1e-12)
    solvers = {
        "ref": trt.RT_EOM_CCSD(no, "cpu", **kw),
        "mesh": trt.RT_EOM_CCSD(no, "cpu", node_mesh=tmesh.make_mesh(
            n_dev, "cpu", devices=["cpu"] * n_dev), **kw),
        "jax": _f64(jrt.RT_EOM_CCSD(no, node_mesh=jmesh.make_mesh(
            n_dev, axis_names=("a",)), **kw))}
    q = {k: u for k in solvers}
    for _ in range(3):
        for k, s in solvers.items():
            s.ls_restart = 20
            s.ls_max_iter = 100
            q[k] = s.solve(fd, Vd if k == "jax" else Vt, t2, dt=0.1,
                           u_singles=q[k][0], u_doubles=q[k][1])
        for k in ("ref", "jax"):
            for a, b in zip(q["mesh"], q[k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=1e-10)
        share = 32 // n_dev if 32 % n_dev == 0 else 32
        assert _lanes_per_chunk(solvers["mesh"]) == [share] * n_dev


def test_node_mesh_needs_its_axis():
    no, fd, Vd, t2, e_dav = _h2_dressed()
    s = tfeast.FEAST_EOM_CCSD(no, "cpu", e_c=e_dav, e_r=0.2, n_trial=2,
                              max_iter=2, node_mesh=tmesh.make_mesh(
                                  2, "cpu", axis_names=("n",),
                                  devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="node_axis"):
        s.solve(fd, interop.eom_operator_from_numpy(Vd, "cpu"), t2)
    s.node_axis = "n"
    ev = s.solve(fd, interop.eom_operator_from_numpy(Vd, "cpu"), t2)
    assert len(ev)
