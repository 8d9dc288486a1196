"""The transcorrelated UEG in the port, held to the JAX package on the CPU.

Host copies (integrals of every class and correlator, the 3-body tensor and
its contractions, ``sumNablaUSquare``, ``calcGamma``) must give the JAX
package's arrays exactly (``array_equal``: the copies run the same numpy
arithmetic in the same order).  The TC oracles of ``tests/test_ueg.py``
hold through the port (TC-HF / 3-body / MP2 to 1e-8, the effective-2-body
CCD/DCD to 1e-10).  The TC ladder and OVVV plans equal the JAX plans leaf
for leaf and the dense blocks under the twin to 1e-12·max; the TC
matrix-free CCD/DCD and CCSD solves track the JAX package per iteration to
1e-10 (relative where the raw TC Hamiltonian diverges).

Where a test only compares the two packages, both models get the same
small k′ grid (``kPrime``, cutoff 6 instead of 30) for the Σ∇u·∇u
convolution, so the sweep over classes and correlators and the solves stay
fast; the oracle tests keep the default grid.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu_torch import interop
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccd, ccsd, mp2

NO = 7
REL = 1e-12
CLASSES = ("is_rpa_approx", "is_only_2b", "is_only_hermi_2b",
           "is_only_non_hermi_2b", "is_effect_2b", "is_exchange_1",
           "is_exchange_2", "is_exchange_3")
CORRELATORS = ("trunc", "gaskell", "yukawa", "stg", "smooth", "coulomb",
               "yukawa_coulomb", "gaskell_modified")
SHIFTS = ((0.0, 0.0, 0.0), (0.1, 0.25, 0.5))
TRANSFER_ONLY = ({}, {"is_rpa_approx": True}, {"is_only_hermi_2b": True})
NON_HERMITIAN = ({"is_only_2b": True}, {"is_only_non_hermi_2b": True})


def _small_grid():
    g = np.arange(-6, 7)
    gi, gj, gk = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([gi.ravel(), gj.ravel(), gk.ravel()], axis=-1)


def _pair(nel=14, rs=1.0, cutoff=2, shift=SHIFTS[0], k_cutoff=1.0,
          small_grid=True):
    """The same UEG in both packages: (JAX model, port model)."""
    out = []
    for mod in (jueg, tueg):
        u = mod.UEG(nel, nel // 2, nel // 2, rs)
        u.init_single_basis(cutoff, shift)
        u.gamma = None
        u.k_cutoff = k_cutoff
        if small_grid:
            u.kPrime = _small_grid()
        out.append(u)
    return out


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# --- host copies ----------------------------------------------------------

@pytest.mark.parametrize("shift", SHIFTS, ids=["gamma", "twist"])
@pytest.mark.parametrize("corr", CORRELATORS)
@pytest.mark.parametrize("cls", CLASSES)
def test_eval_2b_integrals_identical(cls, corr, shift):
    uj, ut = _pair(shift=shift)
    idx_j, vals_j = uj.eval_2b_integrals(correlator=getattr(uj, corr),
                                         sp=2, **{cls: True})
    idx_t, vals_t = ut.eval_2b_integrals(correlator=getattr(ut, corr),
                                         sp=2, **{cls: True})
    assert np.array_equal(idx_j, idx_t)
    assert np.array_equal(vals_j, vals_t)
    assert np.abs(vals_t).max() > 0
    assert ut.correlator.__name__ == corr
    assert (ut.k_cutoff, ut.gamma) == (uj.k_cutoff, uj.gamma)
    Vj = uj.eval_2b_integrals(correlator=getattr(uj, corr), **{cls: True})
    Vt = ut.eval_2b_integrals(correlator=getattr(ut, corr), **{cls: True})
    assert np.array_equal(Vj, Vt)


@pytest.mark.parametrize("corr", [None, "gaskell", "yukawa"])
def test_eval_3b_integrals_identical(corr):
    uj, ut = _pair(nel=2, rs=0.5, cutoff=1.0)
    Lj = uj.eval_3b_integrals(correlator=corr and getattr(uj, corr))
    Lt = ut.eval_3b_integrals(correlator=corr and getattr(ut, corr))
    assert np.array_equal(Lj, Lt) and np.abs(Lt).max() > 0
    # without a correlator the model defaults to (and keeps) trunc
    assert ut.correlator.__name__ == (corr or "trunc")
    assert np.array_equal(uj.contract3BodyIntegralsTo2Body(Lj),
                          ut.contract3BodyIntegralsTo2Body(Lt))


@pytest.mark.parametrize("shift", SHIFTS, ids=["gamma", "twist"])
@pytest.mark.parametrize("corr", CORRELATORS)
def test_3body_contractions_identical(corr, shift):
    uj, ut = _pair(shift=shift)
    uj.correlator, ut.correlator = getattr(uj, corr), getattr(ut, corr)
    assert np.array_equal(uj.double_contractions_in_3_body(),
                          ut.double_contractions_in_3_body())
    assert uj.triple_contractions_in_3_body() \
        == ut.triple_contractions_in_3_body()
    rng = np.random.default_rng(3)
    for p, k in rng.standard_normal((3, 2, 3)):
        assert uj.contract_exchange_3_body(p, k) \
            == ut.contract_exchange_3_body(p, k)
        assert uj.contractP_KWithQ(p, k) == ut.contractP_KWithQ(p, k)


def test_sum_nabla_u_square_identical():
    """The scalar ``sumNablaUSquare`` and the vectorised convolution, on the
    default k′ grid (which both cache on the model)."""
    uj, ut = _pair(small_grid=False)
    uj.correlator, ut.correlator = uj.gaskell, ut.gaskell
    for k in ((0.0, 0.0, 0.0), (1.0, 0.5, -0.25), (2.0, 0.0, 1.0)):
        assert uj.sumNablaUSquare(k) == ut.sumNablaUSquare(k)
    assert np.array_equal(uj.kPrime, ut.kPrime)
    assert ut.kPrime.shape == (61 ** 3, 3)
    d = ut.basis.k_int[None, :5] - ut.basis.k_int[:5, None]
    dk = ut.basis.kp[None, :5] - ut.basis.kp[:5, None]
    assert np.array_equal(uj._sum_nabla_u_squared(d, dk),
                          ut._sum_nabla_u_squared(d, dk))


def test_calc_gamma_matches_jax_and_ftod(tmp_path, monkeypatch):
    """Γ^p_q(G) = sqrt(4π/G²/Ω) at G = k_p − k_q (``tests/test_misc2.py:41``)
    through the port, equal to the JAX package's, and through the JAX
    package's FTOD writer and reader."""
    from pymes_tpu.util import cc4s_interface

    uj, ut = jueg.UEG(2, 1, 1, 1.0), tueg.UEG(2, 1, 1, 1.0)
    uj.init_single_basis(1)
    ut.init_single_basis(1)
    nP = ut.n_spatial
    gamma = ut.calcGamma(ut.basis_fns, nP)
    assert gamma.shape == (nP, nP, nP)
    assert np.array_equal(gamma, uj.calcGamma(uj.basis_fns, nP))
    g0 = ut.basis.lookup(np.zeros((1, 3), dtype=int))[0]
    assert np.all(gamma[np.arange(nP), np.arange(nP), g0] == 0.0)
    k = ut.basis.k_int
    p, q = 0, next(q for q in range(nP)
                   if ut.basis.lookup((k[0] - k[q]).reshape(1, 3))[0] >= 0
                   and not np.array_equal(k[0], k[q]))
    g = ut.basis.lookup((k[p] - k[q]).reshape(1, 3))[0]
    G2 = ut.basis.kp[g] @ ut.basis.kp[g]
    assert np.isclose(gamma[p, q, g], np.sqrt(4 * np.pi / G2 / ut.Omega))
    # an earlier test may leave the cwd deleted
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.chdir(tmp_path)
    cc4s_interface.dump_ftod(gamma, "FTOD")
    _, dims, data = cc4s_interface.read_cc4s_tensor("FTOD.dat")
    assert dims == list(gamma.shape)
    assert np.allclose(data.reshape(gamma.shape), gamma)


# --- TC oracles through the port ------------------------------------------

def _tc_hf_mp2(shift):
    """TC-HF, the 3-body shift and TC-MP2 of ``tests/test_ueg.py:43-67`` on
    the port."""
    nel, rs = 14, 1.0
    k_f = 1.0 / 2 * (3 * nel / np.pi) ** (1.0 / 3)
    u = tueg.UEG(nel, NO, NO, rs)
    u.init_single_basis((k_f * 1.2) ** 2, shift)
    u.gamma = None
    u.k_cutoff = 1.0
    h = torch.diag(torch.as_tensor(u.kinetic_energies()))
    V = torch.as_tensor(u.eval_2b_integrals(correlator=u.gaskell,
                                            is_only_2b=True))
    fock = hf.construct_hf_matrix(NO, h, V)
    hf_e = float(hf.calc_hf_e(NO, 0.0, h, V))
    contr_2b = torch.as_tensor(u.double_contractions_in_3_body())
    contr_3b = u.triple_contractions_in_3_body()
    eps = fock.diagonal() + contr_2b
    V = V + torch.as_tensor(u.eval_2b_integrals(correlator=u.gaskell,
                                                is_rpa_approx=True))
    mp2_e, _ = mp2.solve(eps[:NO], eps[NO:], V[:NO, :NO, NO:, NO:],
                         V[NO:, NO:, :NO, :NO])
    return hf_e, contr_3b, float(mp2_e)


@pytest.mark.parametrize("shift,want", [
    (SHIFTS[0], (7.59923631, 1.33429356, 0.89665277)),
    (SHIFTS[1], (10.43225777093217, 1.1470242894883573, 0.234320519158))],
    ids=["gamma", "twist"])
def test_tc_hf_3body_mp2_oracles(shift, want):
    got = _tc_hf_mp2(shift)
    assert np.abs(np.subtract(got, want)).max() < 1e-8


def test_3body_single_contraction_identities():
    """``tests/test_ueg.py:132`` on the port: the numeric single
    contractions of L equal ½ × the closed-form classes."""
    rs = 0.5
    u = tueg.UEG(2, 1, 1, rs)
    u.init_single_basis(1.0)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / rs
    no = 1
    L = u.eval_3b_integrals(correlator=u.trunc, sp=0)
    pairs = (
        (2 * np.einsum("opqrsq->oprs", L[:, :, :no, :, :, :no]),
         "is_rpa_approx"),
        (-2 * np.einsum("opqrso->qprs", L[:no, :, :, :, :, :no]),
         "is_exchange_1"),
        (-2 * np.einsum("opqqst->opts", L[:, :, :no, :no, :, :]),
         "is_exchange_2"),
        (-2 * np.einsum("opqpst->oqst", L[:, :no, :, :no, :, :]),
         "is_exchange_3"))
    for num, cls in pairs:
        an = u.eval_2b_integrals(correlator=u.trunc, sp=0, **{cls: True})
        assert np.abs(an).max() > 0
        assert np.linalg.norm(num - 0.5 * an) < 1e-10, cls


def test_tc_effective_2body_ccd_dcd_oracles():
    """``tests/test_ueg.py:103-129`` on the port: effective 2-body
    integrals (trunc), the double contractions on the Fock diagonal, CCD
    then DCD warm-started."""
    rs = 0.5
    u = tueg.UEG(14, NO, NO, rs)
    u.init_single_basis(2)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / rs
    V = torch.as_tensor(u.eval_2b_integrals(correlator=u.trunc,
                                            is_effect_2b=True, sp=0))
    kin = torch.as_tensor(u.kinetic_energies())
    fock = hf.construct_hf_matrix(NO, torch.diag(kin), V)
    fock = fock + torch.diag(torch.as_tensor(
        u.double_contractions_in_3_body()))
    assert abs(u.triple_contractions_in_3_body()
               - 0.002887307509129971) < 1e-12
    res = ccd.CCD(NO, device="cpu").solve(fock, V, level_shift=-1.0,
                                          max_iter=80)
    assert abs(res["ccd e"] - (-7.725879708981945e-06)) < 1e-10
    res_dcd = ccd.CCD(NO, device="cpu", is_dcd=True).solve(
        fock, V, level_shift=-1.0, max_iter=80, amps=res["t2 amp"])
    assert abs(res_dcd["ccd e"] - (-7.725880035329113e-06)) < 1e-10


# --- TC plans -------------------------------------------------------------

def _plans_equal(pj, pt):
    assert (pt.n_bra, pt.nv, pt.w0) == (pj.n_bra, pj.nv, pj.w0)
    assert len(pt.groups) == len(pj.groups)
    for gj, gt in zip(pj.groups, pt.groups):
        assert np.array_equal(np.asarray(gj.blocks), gt.blocks.numpy())
        assert np.array_equal(np.asarray(gj.perm_ket), gt.perm_ket.numpy())
    assert np.array_equal(np.asarray(pj.inv_bra), pt.inv_bra.numpy())


@pytest.mark.parametrize("shift", SHIFTS, ids=["gamma", "twist"])
@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("flags", TRANSFER_ONLY[1:] + NON_HERMITIAN,
                         ids=lambda f: next(iter(f)))
def test_tc_block_ladder_identical_and_exact(flags, bra, shift):
    """The TC plans (both bra ranges, hermitian and non-hermitian, Γ and
    twist) equal the JAX plans leaf for leaf, carry over through
    ``interop`` bit for bit, and equal the dense block under the twin.  The
    all-bra non-hermitian plan is the one whose blocks are not
    transpose-symmetric, so it shows a transposed block.  No correlator
    cutoff (``k_cutoff=None``): a cutoff on a shell of transfers puts the
    plan's integer transfers and the dense path's twisted momentum
    differences on the two sides of it, in both packages alike."""
    uj, ut = _pair(shift=shift, k_cutoff=None)
    pj = jladder.build_block_ladder(uj, correlator=uj.yukawa, bra=bra,
                                    preslice=None, **flags)
    pt = tladder.build_block_ladder(ut, device="cpu", correlator=ut.yukawa,
                                    bra=bra, **flags)
    _plans_equal(pj, pt)
    p_int = interop.block_ladder_from_numpy(pj, "cpu")
    for a, b in zip(p_int.groups, pt.groups):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert p_int.w0 == pt.w0
    V = ut.eval_2b_integrals(correlator=ut.yukawa, **flags)
    lo = 0 if bra == "all" else NO
    block = V[lo:, lo:, NO:, NO:]
    nv = ut.n_spatial - NO
    T = np.random.default_rng(7).standard_normal((NO, NO, nv, nv))
    R = tladder.ladder_apply_ij(pt, torch.as_tensor(T))
    _close(R.numpy(), np.einsum("ijcd,pqcd->ijpq", T, block))
    Tab = T.transpose(2, 3, 0, 1)
    _close(tladder.ladder_apply(pt, torch.as_tensor(Tab)).numpy(),
           np.einsum("pqcd,cdij->pqij", block, Tab))
    if bra == "all" and flags in NON_HERMITIAN:
        # the all-bra block is not the transpose of its ket-side image: a
        # plan whose sector blocks were transposed would fail above
        assert np.abs(block - V[NO:, NO:, :, :].transpose(
            2, 3, 0, 1)).max() > 1e-8


@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_sharded_tc_plan_matches_whole(bra):
    """``shard_block_ladder`` takes a non-hermitian TC plan as it is: the
    sharded apply over a 4-device mesh (the CPU listed 4 times) equals the
    whole plan's."""
    from pymes_tpu_torch.parallel import mesh

    _, ut = _pair(shift=SHIFTS[1], k_cutoff=None)
    kw = dict(correlator=ut.yukawa, bra=bra, is_only_2b=True)
    whole = tladder.build_block_ladder(ut, device="cpu", **kw)
    sharded = tladder.shard_block_ladder(
        tladder.build_block_ladder(ut, device="cpu", pad_sectors=4, **kw),
        mesh.make_mesh(4, device="cpu", devices=["cpu"] * 4))
    nv = ut.n_spatial - NO
    T = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (NO, NO, nv, nv)))
    want = tladder.ladder_apply_ij(whole, T)
    _close(tladder.ladder_apply_ij(sharded, T).numpy(), want.numpy())


@pytest.mark.parametrize("flags", TRANSFER_ONLY, ids=lambda f: next(
    iter(f), "coulomb"))
def test_tc_ovvv_plans_identical(flags):
    uj, ut = _pair(shift=SHIFTS[1])
    corr = "gaskell" if flags else None
    pj = jladder.build_ovvv_plans(uj, corr and getattr(uj, corr), **flags)
    pt = tladder.build_ovvv_plans(ut, device="cpu",
                                  correlator=corr and getattr(ut, corr),
                                  **flags)
    p_int = interop.ovvv_plans_from_numpy(pj, "cpu")
    for pat in ("vvo", "ovv", "vov"):
        assert np.array_equal(np.asarray(pj[pat].S), pt[pat].S.numpy())
        assert np.array_equal(np.asarray(pj[pat].W), pt[pat].W.numpy())
        assert torch.equal(p_int[pat].W, pt[pat].W)
        assert torch.equal(p_int[pat].S, pt[pat].S)
    if "is_only_hermi_2b" in flags:   # its weights set the model's
        assert ut.correlator.__name__ == uj.correlator.__name__ == corr


@pytest.mark.parametrize("flags", NON_HERMITIAN, ids=lambda f: next(iter(f)))
def test_non_hermitian_ovvv_plan_raises_as_in_jax(flags):
    uj, ut = _pair()
    with pytest.raises(NotImplementedError):
        jladder.build_ovvv_t1_plan(uj, "vvo", uj.gaskell, **flags)
    with pytest.raises(NotImplementedError):
        tladder.build_ovvv_t1_plan(ut, "vvo", device="cpu",
                                   correlator=ut.gaskell, **flags)
    with pytest.raises(NotImplementedError):
        tladder.build_ovvv_plans(ut, device="cpu", correlator=ut.gaskell,
                                 **flags)


# --- TC solves ------------------------------------------------------------

def test_tc_ccd_matrix_free_trajectory_matches_dense_and_jax():
    """``tests/test_ueg_ladder.py:331``: yukawa ``is_only_2b`` CCD at
    cutoff 3 (unbound, so a fixed 6-iteration budget without DIIS); the
    port's non-hermitian plan tracks the port's dense-abcd solve and the
    JAX package per iteration to 1e-10 relative."""
    nel, rs, cutoff = 14, 1.0, 3
    uj, ut = (m.UEG(nel, NO, NO, rs) for m in (jueg, tueg))
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    V = ut.eval_2b_integrals(correlator=ut.yukawa, is_only_2b=True)
    kin = ut.kinetic_energies()
    Vt = torch.as_tensor(V)
    fock = hf.construct_hf_matrix(NO, torch.diag(torch.as_tensor(kin)), Vt)
    kw = dict(level_shift=-3.0, max_iter=6, delta_e=1e-30)
    dense = ccd.CCD(NO, device="cpu", is_diis=False).solve(fock, Vt, **kw)
    blocks = ccd.blocks_from_full(NO, Vt)._replace(
        abcd=None, ladder=tladder.build_block_ladder(
            ut, device="cpu", correlator=ut.yukawa, is_only_2b=True))
    mf = ccd.CCD(NO, device="cpu", is_diis=False).solve(fock, blocks, **kw)
    jb = jccd.blocks_from_full(NO, jnp.asarray(V))._replace(
        abcd=None, ladder=jladder.build_block_ladder(
            uj, correlator=uj.yukawa, preslice=None, is_only_2b=True))
    ref = jccd.CCD(NO, is_diis=False).solve(
        jnp.asarray(fock.numpy()), jb, contract_mode="xla", **kw)
    want = np.asarray(ref["e history"])
    scale = max(1.0, np.abs(want).max())
    assert len(want) == len(mf["e history"]) == len(dense["e history"]) == 7
    assert np.all(np.isfinite(want))
    assert np.abs(mf["e history"] - dense["e history"]).max() \
        <= 1e-10 * scale
    assert np.abs(mf["e history"] - want).max() <= 1e-10 * scale
    t_ref = np.asarray(ref["t2 amp"])
    assert np.abs(mf["t2 amp"].numpy() - t_ref).max() \
        <= 1e-10 * max(1.0, np.abs(t_ref).max())


def _tc_blocks(u, flags, mod_ueg, device=None):
    NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
            "ijak", "iajk")
    idx, vals = u.eval_2b_integrals(correlator=u.gaskell, sp=2, **flags)
    n_p = u.n_spatial
    if device is None:
        d = mod_ueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED)
        kin = jnp.asarray(u.kinetic_energies())
        eps = jnp.concatenate([
            jhf.calcOccupiedOrbE(kin, d["klij"], NO),
            jhf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)])
        return d, np.asarray(eps)
    d = mod_ueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED,
                                 device=device)
    kin = u.kinetic_energies()
    eps = torch.cat([hf.calcOccupiedOrbE(kin, d["klij"], NO),
                     hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO,
                                        n_p - NO)])
    return d, eps.numpy()


@pytest.mark.parametrize("is_dcd", [False, True], ids=["ccd", "dcd"])
def test_tc_gaskell_ccd_dcd_non_hermitian_plan_matches_jax(is_dcd):
    """The chip's TC CCD configuration (gaskell, ``is_only_2b``, rs 0.5,
    ``k_cutoff`` as ``tests/test_ueg.py:114``) at nP=19: converged CCD and
    DCD on the virtual non-hermitian plan, per iteration within 1e-10 of
    the JAX package's."""
    rs, flags = 0.5, {"is_only_2b": True}
    uj, ut = _pair(rs=rs)
    for u in (uj, ut):
        u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / rs
    dt, eps = _tc_blocks(ut, flags, tueg, "cpu")
    dj, eps_j = _tc_blocks(uj, flags, jueg)
    assert np.array_equal(eps, eps_j)
    fock = np.diag(eps)
    pt = tladder.build_block_ladder(ut, device="cpu", correlator=ut.gaskell,
                                    **flags)
    pj = jladder.build_block_ladder(uj, correlator=uj.gaskell,
                                    preslice=None, **flags)
    names = ("klij", "ijab", "abij", "iajb", "iabj")
    bt = ccd.CCDBlocks(**{k: dt[k] for k in names}, abcd=None, ladder=pt)
    bj = jccd.CCDBlocks(**{k: dj[k] for k in names}, abcd=None, ladder=pj)
    kw = dict(level_shift=-1.0, max_iter=60)
    res = ccd.CCD(NO, device="cpu", is_dcd=is_dcd).solve(fock, bt, **kw)
    ref = jccd.CCD(NO, is_dcd=is_dcd).solve(jnp.asarray(fock), bj,
                                            contract_mode="xla", **kw)
    want = np.asarray(ref["e history"])
    assert len(res["e history"]) == len(want) < 60
    assert np.abs(res["e history"] - want).max() <= 1e-10


def test_hermitian_tc_matrix_free_ccsd_matches_jax():
    """Hermitian-TC (gaskell, ``is_only_hermi_2b``) matrix-free CCSD at
    nP=19 with the seeded non-canonical Fock (T1 ≠ 0): the all-bra TC plan
    and the TC OVVV plans, per iteration within 1e-10 of the JAX
    package."""
    rs, flags = 0.5, {"is_only_hermi_2b": True}
    uj, ut = _pair(rs=rs)
    for u in (uj, ut):
        u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / rs
    dt, eps = _tc_blocks(ut, flags, tueg, "cpu")
    dj, _ = _tc_blocks(uj, flags, jueg)
    n_p = ut.n_spatial
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    fock = np.diag(eps) + noise + noise.T
    dt["_ovvv_plans"] = tladder.build_ovvv_plans(ut, device="cpu",
                                                 correlator=ut.gaskell,
                                                 **flags)
    dj["_ovvv_plans"] = jladder.build_ovvv_plans(uj, uj.gaskell, **flags)
    kw = dict(level_shift=-1.0, max_iter=100, delta_e=1e-10)
    res = ccsd.CCSD(NO, device="cpu").solve(
        torch.as_tensor(fock), dt, ladder=tladder.build_block_ladder(
            ut, device="cpu", correlator=ut.gaskell, bra="all", **flags), **kw)
    ref = jccsd.CCSD(NO).solve(
        jnp.asarray(fock), dj, ladder=jladder.build_block_ladder(
            uj, correlator=uj.gaskell, bra="all", preslice=None, **flags),
        contract_mode="xla", **kw)
    want = np.asarray(ref["e history"])
    assert float(res["t1"].abs().max()) > 1e-4
    assert len(res["e history"]) == len(want) < 100
    assert np.abs(res["e history"] - want).max() <= 1e-10
