"""The port's irreducible twists (``util/kpoints.py``) and structure factor
(``util/structure_factor.py``) against the JAX package's: ``gen_ir_ks``
on the 2³, 3³ and 4³ meshes, the plane-wave basis order and the occupied
set at every twist of the 3³ mesh (where two twists put the Fermi level in
a 3-fold degenerate kinetic shell), and S(q) and g(r) on MP2 and
matrix-free CCD amplitudes, with and without T1.

Tolerances: twists, weights, bases exactly; S(q) and g(r) 1e-12 relative
(the port sums T2 in another order).
"""

import numpy as np
import pytest
import torch

from pymes_tpu.models import ueg as jueg
from pymes_tpu.util import kpoints as jkpoints
from pymes_tpu.util import structure_factor as jsf
from pymes_tpu_torch import configs
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd, mp2
from pymes_tpu_torch.util import kpoints, structure_factor

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gen_ir_ks_equal(n):
    frac, w = kpoints.gen_ir_ks(n)
    frac_j, w_j = jkpoints.gen_ir_ks(n)
    assert np.array_equal(frac, frac_j) and np.array_equal(w, w_j)
    assert len(frac) == {2: 4, 3: 4, 4: 10}[n]
    assert np.isclose(w.sum(), 1.0)


def test_gen_ir_ks_anisotropic_mesh_refused():
    with pytest.raises(ValueError):
        kpoints.gen_ir_ks([2, 2, 3])
    with pytest.raises(ImportError):
        kpoints.gen_ir_ks(2, lattice=np.eye(3) * 2)


@pytest.mark.parametrize("cutoff", [5, 14])
def test_twist_bases_and_occupied_sets_equal(cutoff):
    for k in kpoints.gen_ir_ks(3)[0]:
        ut, uj = ueg.UEG(14, NO, NO, 0.5), jueg.UEG(14, NO, NO, 0.5)
        ut.init_single_basis(cutoff, list(k))
        uj.init_single_basis(cutoff, list(k))
        for f in ("k_int", "kp", "kinetic", "index_map"):
            assert np.array_equal(getattr(ut.basis, f),
                                  getattr(uj.basis, f)), (k, f)
        assert np.array_equal(ut.basis.k_int[:NO], uj.basis.k_int[:NO])


def _sf_equal(u, uj, T2, T1=None):
    q, S = structure_factor.transition_structure_factor(u, T2, T1)
    T2n = T2.numpy()
    T1n = None if T1 is None else T1.numpy()
    qj, Sj = jsf.transition_structure_factor(uj, T2n, T1n)
    assert np.array_equal(q, qj) and len(q) > 1
    assert np.abs(S - Sj).max() <= 1e-12 * np.abs(Sj).max()
    r = np.linspace(0.1, 5.0, 20)
    g = structure_factor.calcRealSpaceStructureFactor(r, u, T2, T1)
    gj = jsf.calcRealSpaceStructureFactor(r, uj, T2n, T1n)
    assert np.abs(g - gj).max() <= 1e-12 * np.abs(gj).max()
    qn, Sn = structure_factor.calcReciprocalSpaceStructureFactor(u, T2, T1)
    qnj, Snj = jsf.calcReciprocalSpaceStructureFactor(uj, T2n, T1n)
    assert np.array_equal(qn, qnj)
    assert np.abs(Sn - Snj).max() <= 1e-12 * np.abs(Snj).max()


def test_structure_factor_mp2_equal():
    u, uj = ueg.UEG(14, NO, NO, 1.0), jueg.UEG(14, NO, NO, 1.0)
    u.init_single_basis(2)
    uj.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, V[:NO, :NO, :NO, :NO], NO)
    eps_a = hf.calcVirtualOrbE(kin, V[NO:, :NO, NO:, :NO],
                               V[NO:, :NO, :NO, NO:], NO, u.n_spatial - NO)
    _, T2 = mp2.solve(eps_i, eps_a, V[:NO, :NO, NO:, NO:],
                      V[NO:, NO:, :NO, :NO])
    _sf_equal(u, uj, T2)
    T1 = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (u.n_spatial - NO, NO)) * 0.01)
    _sf_equal(u, uj, T2, T1)


def test_structure_factor_mf_ccd_twist_equal():
    """Converged matrix-free CCD amplitudes at the (1/3, 1/3, 0) twist,
    cutoff 5, built through the configs."""
    k = tuple(kpoints.gen_ir_ks(3)[0][2])
    u = configs.UEGConfig(n_ele=14, rs=0.5, cutoff=5, k_shift=k).make()
    uj = jueg.UEG(14, NO, NO, 0.5)
    uj.init_single_basis(5, list(k))
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, "cpu", names=NEED)
    kin = u.kinetic_energies()
    fock = torch.diag(torch.cat([
        hf.calcOccupiedOrbE(kin, d["klij"], NO),
        hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)]))
    blocks = ccd.CCDBlocks(
        klij=d["klij"], ijab=d["ijab"], abij=d["abij"], iajb=d["iajb"],
        iabj=d["iabj"], abcd=None,
        ladder=ueg_ladder.build_block_ladder(u, "cpu"))
    res = configs.GroundStateConfig(no=NO, max_iter=60).make_ccd(
        "cpu").solve(fock, blocks, level_shift=-1.0)
    _sf_equal(u, uj, res["t2 amp"])
