"""drCCD and the DCD wrapper in the port, on the CPU.

drCCD: the dRPA plasmon identity ``E_c = ½(Σ ω_RPA − tr A)`` to 1e-7 and the
Riccati residual of the amplitudes to 1e-6 (``tests/test_drccd.py``), the
port's ``[i,j,a,b]`` residual against the JAX package's ``[a,b,i,j]`` one,
transposed, to 1e-12 (derived and explicit ``aijb``, a non-hermitian
vertex), and the solve's per-iteration energies against the JAX package's
abij loop to 1e-10.  DCD: ``DCD(no, device)`` is ``CCD(no, device,
is_dcd=True)``.
"""

import numpy as np
import pytest
import torch
from scipy.linalg import eigvalsh, sqrtm

import jax.numpy as jnp
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import drccd as jdrccd
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.parallel import mesh
from pymes_tpu_torch.solver import ccd, dcd, drccd

NO = 7


def _ueg(cutoff=2, rs=1.0):
    u = ueg.UEG(14, NO, NO, rs)
    u.init_single_basis(cutoff)
    V = u.eval_2b_integrals()
    kin = u.kinetic_energies()
    nv = u.n_spatial - NO
    Vt = torch.as_tensor(V)
    eps_i = hf.calcOccupiedOrbE(kin, Vt[:NO, :NO, :NO, :NO], NO)
    eps_a = hf.calcVirtualOrbE(kin, Vt[NO:, :NO, NO:, :NO],
                               Vt[NO:, :NO, :NO, NO:], NO, nv)
    fock = hf.construct_hf_matrix(NO, torch.diag(torch.as_tensor(kin)), Vt)
    return u, V, fock, eps_i.numpy(), eps_a.numpy()


def _rpa_matrices(V, eps_i, eps_a, no, nv):
    aijb = V[no:, :no, :no, no:]
    abij = V[no:, no:, :no, :no]
    de = (eps_a[:, None] - eps_i[None, :]).ravel()
    A = 2.0 * aijb.transpose(0, 2, 3, 1).reshape(nv * no, nv * no)
    A[np.arange(nv * no), np.arange(nv * no)] += de
    B = 2.0 * abij.transpose(0, 2, 1, 3).reshape(nv * no, nv * no)
    return A, B


def test_drccd_equals_drpa_plasmon():
    u, V, fock, eps_i, eps_a = _ueg()
    nv = u.n_spatial - NO
    A, B = _rpa_matrices(V, eps_i, eps_a, NO, nv)
    S = sqrtm(A - B)
    omega = np.sqrt(np.abs(eigvalsh(S @ (A + B) @ S)))
    e_plasmon = 0.5 * (omega.sum() - np.trace(A))

    res = ccd.CCD(NO, "cpu", is_dr_ccd=True).solve(
        fock, torch.as_tensor(V), level_shift=-0.5, max_iter=200,
        delta_e=1e-10)
    assert abs(res["ccd e"] - e_plasmon) < 1e-7
    # amplitudes solve the Riccati equation B + A(2T) + (2T)A + (2T)B(2T)
    Tm = 2.0 * res["t2 amp"].numpy().transpose(0, 2, 1, 3).reshape(
        nv * NO, nv * NO)
    resid = B + A @ Tm + Tm @ A + Tm @ B @ Tm
    assert np.linalg.norm(resid) < 1e-6


def _random_vertex(seed=7, no=3, nv=5):
    rng = np.random.default_rng(seed)
    n = no + nv
    M = rng.standard_normal((n, n, n, n))
    V = M + M.transpose(1, 0, 3, 2)   # particle-symmetric, non-hermitian
    assert np.abs(V - V.transpose(2, 3, 0, 1)).max() > 0.1
    o, v = slice(None, no), slice(no, None)
    blocks = {"abij": V[v, v, o, o], "iabj": V[o, v, v, o],
              "aijb": V[v, o, o, v], "ijab": V[o, o, v, v]}
    return (rng.standard_normal(no), rng.standard_normal(nv) + 3.0,
            rng.standard_normal((nv, nv, no, no)) * 0.05, blocks, rng)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_residual_matches_jax_transposed():
    """Non-hermitian, particle-symmetric vertex: derived and explicit
    ``aijb`` give the JAX abij residual, transposed, to 1e-12; an explicit
    ``aijb`` that breaks the symmetry is used as given."""
    eps_i, eps_a, T, b, rng = _random_vertex()
    Tij = _t(T.transpose(2, 3, 0, 1))
    want = np.asarray(jdrccd.residual(eps_i, eps_a, T, b["abij"],
                                      b["iabj"], b["ijab"]))
    got = drccd.residual(_t(eps_i), _t(eps_a), Tij, _t(b["abij"]),
                         _t(b["iabj"]), _t(b["ijab"])).numpy()
    scale = np.abs(want).max()
    assert np.abs(got.transpose(2, 3, 0, 1) - want).max() <= 1e-12 * scale
    explicit = drccd.get_residual(_t(eps_i), _t(eps_a), Tij, _t(b["abij"]),
                                  _t(b["aijb"]), _t(b["iabj"]),
                                  _t(b["ijab"])).numpy()
    assert np.abs(explicit - got).max() <= 1e-12 * scale

    broken = b["aijb"] + rng.standard_normal(b["aijb"].shape)
    want_b = np.asarray(jdrccd.get_residual(eps_i, eps_a, T, b["abij"],
                                            broken, b["iabj"], b["ijab"]))
    got_b = drccd.get_residual(_t(eps_i), _t(eps_a), Tij, _t(b["abij"]),
                               _t(broken), _t(b["iabj"]),
                               _t(b["ijab"])).numpy()
    assert np.abs(got_b.transpose(2, 3, 0, 1) - want_b).max() \
        <= 1e-12 * np.abs(want_b).max()
    assert np.abs(got_b - explicit).max() > 1e-6


def test_energy_matches_jax():
    _, _, T, b, _ = _random_vertex(seed=11)
    want = jdrccd.getEnergy(T, b["ijab"])
    got = drccd.getEnergy(_t(T.transpose(2, 3, 0, 1)), _t(b["ijab"]))
    assert abs(float(got[0]) - float(want[0])) <= 1e-13 * abs(
        float(want[0]))
    assert got[1] == 0.0 == want[1]


def test_drccd_solve_matches_jax_per_iteration():
    """nP=19 drCCD with DIIS: the port's ijab loop (K2/K3 twins on the
    CPU) against the JAX package's abij loop, energy by energy."""
    _, V, fock, _, _ = _ueg()
    kw = dict(level_shift=-1.0, max_iter=60, delta_e=1e-10)
    res = ccd.CCD(NO, "cpu", is_dr_ccd=True).solve(fock, torch.as_tensor(V),
                                                   **kw)
    ref = jccd.CCD(NO, is_dr_ccd=True).solve(
        jnp.asarray(fock.numpy()), jnp.asarray(V), contract_mode="xla", **kw)
    want = np.asarray(ref["e history"])
    assert len(res["e history"]) == len(want) < 60
    assert np.abs(res["e history"] - want).max() <= 1e-10
    assert np.abs(res["t2 amp"].numpy() - np.asarray(ref["t2 amp"])).max() \
        <= 1e-10


def test_drccd_takes_no_ladder_and_no_ring():
    u, V, fock, _, _ = _ueg()
    Vt = torch.as_tensor(V)
    blocks = ccd.blocks_from_full(NO, Vt)._replace(abcd=None)
    T0 = torch.zeros_like(Vt[NO:, NO:, :NO, :NO])
    # the dense abcd is not needed ...
    out = ccd.ccd_solve(fock, blocks, NO, T0, level_shift=-1.0,
                        max_iter=3, is_dr_ccd=True)
    assert np.isfinite(float(out[0]))
    # ... and a ladder plan or a ring mesh with it raises
    plan = ueg_ladder.build_block_ladder(u, "cpu")
    with pytest.raises(ValueError):
        ccd.ccd_solve(fock, blocks._replace(ladder=plan), NO, T0,
                      is_dr_ccd=True)
    m = mesh.make_mesh(2, "cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        ccd.ccd_solve(fock, blocks._replace(abcd=Vt[NO:, NO:, NO:, NO:]),
                      NO, T0, is_dr_ccd=True, ring_mesh=m)
    # without drCCD the guard for a ladder stays
    with pytest.raises(ValueError):
        ccd.ccd_solve(fock, blocks, NO, T0)


def test_dcd_wrapper_is_ccd_with_is_dcd():
    _, V, fock, _, _ = _ueg()
    s = dcd.DCD(NO, "cpu", is_dcd=False, is_diis=True)
    assert s.is_dcd and isinstance(s, ccd.CCD) and s.no == NO
    assert s.device == torch.device("cpu")
    Vt = torch.as_tensor(V)
    a = s.solve(fock, Vt, level_shift=-1.0)
    b = ccd.CCD(NO, "cpu", is_dcd=True).solve(fock, Vt, level_shift=-1.0)
    assert a["ccd e"] == b["ccd e"]
    assert np.array_equal(a["e history"], b["e history"])
    assert torch.equal(a["t2 amp"], b["t2 amp"])
    c = ccd.CCD(NO, "cpu").solve(fock, Vt, level_shift=-1.0)
    assert abs(a["ccd e"] - c["ccd e"]) > 1e-6
