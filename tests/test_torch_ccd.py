"""The port's CCD slice against the JAX package: HF, MP2, the doubles
residual (ladder and dense-``abcd`` branches; CCD, DCD, Brueckner), and the
whole matrix-free solve (iteration count and per-iteration energies), plus
the reference oracles (BASELINE.md).

Tolerances: building blocks 1e-12 relative (f64, another summation order);
per-iteration energies 1e-10 absolute (errors of the building blocks carried
through ≤ 10 nonlinear iterations); oracles as BASELINE.md states them.
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
from pymes_tpu.solver import mp2 as jmp2
from pymes_tpu.util import fcidump
from pymes_tpu_torch.mean_field import hf as thf
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccd as tccd
from pymes_tpu_torch.solver import mp2 as tmp2

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")
REL = 1e-12
ORACLE = {"ueg57_ccd": -0.5120153512190824, "ueg57_dcd": -0.515296499349519,
          "lih_hf": -7.92958534362757, "lih_ccd": -0.01830250126018896}
FCIDUMP_LIH = os.path.join(os.path.dirname(__file__), "data",
                           "FCIDUMP.LiH.321g")


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def _ueg(cutoff, dense=False):
    """The main path's set-up in both packages (bench.py's recipe):
    integral list → named blocks → HF orbital energies → ladder plan → MP2
    guess.  ``dense`` adds the ``abcd`` block (no ladder plan then)."""
    names = NEED + ("abcd",) if dense else NEED
    uj, ut = jueg.UEG(14, 7, 7, 0.5), tueg.UEG(14, 7, 7, 0.5)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    idx, vals = ut.eval_2b_integrals(sp=2)
    n_p = ut.n_spatial
    out = {}
    dj = jueg.sparse_to_blocks(idx, vals, n_p, NO, names=names,
                               dtype=jnp.float64)
    kin = jnp.asarray(uj.kinetic_energies())
    ei = jhf.calcOccupiedOrbE(kin, dj["klij"], NO)
    ea = jhf.calcVirtualOrbE(kin, dj["aibj"], dj["aijb"], NO, n_p - NO)
    lad = None if dense else jladder.build_block_ladder(uj, preslice=None)
    out["jax"] = dict(
        eps_i=ei, eps_a=ea, fock=jnp.diag(jnp.concatenate([ei, ea])),
        blocks=jccd.CCDBlocks(klij=dj["klij"], ijab=dj["ijab"],
                              abij=dj["abij"], iajb=dj["iajb"],
                              iabj=dj["iabj"], abcd=dj.get("abcd"),
                              ladder=lad))
    dt = tueg.sparse_to_blocks(idx, vals, n_p, NO, device="cpu", names=names)
    ei = thf.calcOccupiedOrbE(ut.kinetic_energies(), dt["klij"], NO)
    ea = thf.calcVirtualOrbE(ut.kinetic_energies(), dt["aibj"], dt["aijb"],
                             NO, n_p - NO)
    lad = None if dense else tladder.build_block_ladder(ut, device="cpu")
    out["torch"] = dict(
        eps_i=ei, eps_a=ea, fock=torch.diag(torch.cat([ei, ea])),
        blocks=tccd.CCDBlocks(klij=dt["klij"], ijab=dt["ijab"],
                              abij=dt["abij"], iajb=dt["iajb"],
                              iabj=dt["iabj"], abcd=dt.get("abcd"),
                              ladder=lad))
    for side, mod in (("jax", jmp2), ("torch", tmp2)):
        p = out[side]
        p["e_mp2"], p["T0"] = mod.solve(p["eps_i"], p["eps_a"],
                                        p["blocks"].ijab, p["blocks"].abij,
                                        -1.0)
    out["nv"] = n_p - NO
    return out


@pytest.fixture(scope="module")
def ueg19():
    return _ueg(2)


@pytest.fixture(scope="module")
def lih():
    n_elec, _, e_core, _, h, V = fcidump.read(FCIDUMP_LIH)
    return dict(no=n_elec // 2, e_core=e_core, h=h, V=V)


def test_hf_matches_jax_and_oracle(lih):
    no, h, V = lih["no"], lih["h"], lih["V"]
    ej = jhf.calc_hf_e(no, lih["e_core"], h, V)
    et = thf.calc_hf_e(no, lih["e_core"], torch.as_tensor(h),
                       torch.as_tensor(V))
    _close(float(et), float(ej))
    assert abs(float(et) - ORACLE["lih_hf"]) <= 1e-8
    _close(thf.construct_hf_matrix(no, torch.as_tensor(h),
                                   torch.as_tensor(V)).numpy(),
           jhf.construct_hf_matrix(no, h, V))


def test_ueg_orbital_energies_and_mp2_match_jax(ueg19):
    j, t = ueg19["jax"], ueg19["torch"]
    _close(t["eps_i"].numpy(), j["eps_i"])
    _close(t["eps_a"].numpy(), j["eps_a"])
    _close(float(t["e_mp2"]), float(j["e_mp2"]))
    _close(t["T0"].numpy(), j["T0"])
    for part in (None, 3):
        e_j = jmp2.solve_blocked(j["eps_i"], j["eps_a"], j["blocks"].ijab,
                                 j["blocks"].abij, -1.0, nv_part_size=part)
        e_t = tmp2.solve_blocked(t["eps_i"], t["eps_a"], t["blocks"].ijab,
                                 t["blocks"].abij, -1.0, nv_part_size=part)
        _close(float(e_t), float(e_j))
        _close(float(e_t), float(t["e_mp2"]))


@pytest.mark.parametrize("variant", ["ccd", "dcd", "bruekner"])
@pytest.mark.parametrize("branch", ["ladder", "abcd"])
def test_doubles_residual_matches_jax(branch, variant):
    p = _ueg(2, dense=branch == "abcd")
    flags = dict(is_dcd=variant == "dcd", is_bruekner=variant == "bruekner")
    nv = p["nv"]
    T = np.random.default_rng(17).standard_normal((NO, NO, nv, nv)) * 0.05
    j, t = p["jax"], p["torch"]
    Rj = jccd.doubles_residual_ij(j["fock"][NO:, NO:], j["fock"][:NO, :NO],
                                  jnp.asarray(T),
                                  jccd.blocks_ij_from(j["blocks"]), **flags)
    Rt = tccd.doubles_residual_ij(t["fock"][NO:, NO:], t["fock"][:NO, :NO],
                                  torch.as_tensor(T),
                                  tccd.blocks_ij_from(t["blocks"]), **flags)
    _close(Rt.numpy(), Rj)
    ej = jccd.ccd_energy_ij(jnp.asarray(T), j["blocks"].ijab,
                            jnp.transpose(j["blocks"].ijab, (0, 1, 3, 2)))
    et = tccd.ccd_energy_ij(torch.as_tensor(T), t["blocks"].ijab,
                            t["blocks"].ijab.transpose(2, 3))
    for a, b in zip(et, ej):
        _close(float(a), float(b))


def _solve_both(p, **kw):
    j, t = p["jax"], p["torch"]
    kw = {"max_iter": 60, **kw}
    out_j = jccd.ccd_solve_jit(j["fock"], j["blocks"], NO, j["T0"],
                               level_shift=-1.0, contract_mode="xla",
                               layout="ijab", **kw)
    out_t = tccd.ccd_solve(t["fock"], t["blocks"], NO, t["T0"],
                           level_shift=-1.0, **kw)
    return out_j, out_t


def _same_trajectory(out_j, out_t):
    n_it = int(out_j[5])
    assert out_t[5] == n_it
    hist_j = np.asarray(out_j[6])
    hist_t = out_t[6].numpy()
    assert np.abs(hist_t[:n_it] - hist_j[:n_it]).max() <= 1e-10
    assert np.isnan(hist_t[n_it:]).all() and np.isnan(hist_j[n_it:]).all()
    assert abs(float(out_t[0]) - float(out_j[0])) <= 1e-10
    _close(out_t[1].numpy(), out_j[1], rel=1e-8)   # T2 (abij)
    return n_it


@pytest.mark.parametrize("kw", [
    {}, {"is_dcd": True}, {"is_bruekner": True}, {"is_diis": False},
    {"delta_e": -1.0, "max_iter": 7},
], ids=["ccd", "dcd", "bruekner", "no_diis", "fixed_iterations"])
def test_solve_np19_same_trajectory_as_jax(ueg19, kw):
    kw = {"delta_e": 1e-8, **kw}
    out_j, out_t = _solve_both(ueg19, **kw)
    n_it = _same_trajectory(out_j, out_t)
    if kw["delta_e"] < 0:            # the loop runs to the cap: max_iter + 1
        assert n_it == kw["max_iter"] + 1


def test_main_path_np57_matches_jax_and_oracle():
    p = _ueg(5)
    out_j, out_t = _solve_both(p, delta_e=1e-8)
    assert _same_trajectory(out_j, out_t) == 6
    assert abs(float(out_t[0]) - ORACLE["ueg57_ccd"]) <= 1e-8
    # the user entry point: the CCD class on a dict of blocks + plan
    t = p["torch"]
    blocks = {f: getattr(t["blocks"], f) for f in t["blocks"]._fields}
    res = tccd.CCD(NO, device="cpu").solve(t["fock"], blocks, level_shift=-1.0,
                                           max_iter=60)
    assert abs(res["ccd e"] - float(out_t[0])) <= 1e-12
    assert res["t2 amp"].shape == (p["nv"], p["nv"], NO, NO)
    assert len(res["e history"]) == 6
    dcd = tccd.CCD(NO, device="cpu", is_dcd=True).solve(t["fock"], blocks,
                                                        level_shift=-1.0,
                                                        max_iter=60)
    assert abs(dcd["ccd e"] - ORACLE["ueg57_dcd"]) <= 1e-6


def test_lih_dense_ccd_oracle(lih):
    no = lih["no"]
    h, V = torch.as_tensor(lih["h"]), torch.as_tensor(lih["V"])
    fock = thf.construct_hf_matrix(no, h, V)
    res = tccd.CCD(no, device="cpu").solve(fock.numpy(), lih["V"])
    # the oracle's own tolerance (np.isclose, as tests/test_ccsd.py): the
    # solve stops at |dE| < 1e-8, so E carries an error of that order
    assert np.isclose(res["ccd e"], ORACLE["lih_ccd"])
    ref = jccd.CCD(no).solve(jhf.construct_hf_matrix(no, lih["h"], lih["V"]),
                             lih["V"])
    assert abs(res["ccd e"] - ref["ccd e"]) <= 1e-10
