"""The port's typed configurations (``configs.py``) against the JAX
package's: the same fields and defaults (``to_dict`` equal, a JAX dict
rebuilds the port's config), solvers built with equal settings, the card
as the default device, ``mixed_precision`` carried as in the JAX package,
and a config-built matrix-free CCD at cutoff 5 (Γ and one twist of the 3³
mesh) equal to the JAX package's per iteration, with ``log_iterations``
printing each iteration as the JAX solver does.

Tolerances: per-iteration energies 1e-10 absolute with equal iteration
counts (as ``tests/test_torch_ccd.py``).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu import configs as jconfigs
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.util.kpoints import gen_ir_ks
from pymes_tpu_torch import configs
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")
CLASSES = ("GroundStateConfig", "EOMConfig", "FEASTConfig", "RTConfig",
           "UEGConfig")
ATTRS = {
    "make_ccd": ("no", "delta_e", "is_dcd", "is_diis", "is_dr_ccd",
                 "is_bruekner", "max_iter", "dim_space", "log_iterations"),
    "make_ccsd": ("no", "delta_e", "is_dcd", "is_diis", "max_iter",
                  "dim_space", "log_iterations"),
    "EOMConfig": ("no", "n_excit", "max_iter", "e_epsilon", "max_dim"),
    "FEASTConfig": ("no", "e_c", "e_r", "n_trial", "max_iter", "tol",
                    "n_quad", "ls_max_iter"),
    "RTConfig": ("no", "e_c", "e_r", "dt", "n_quad", "ls_max_iter"),
}


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    jcls, tcls = getattr(jconfigs, name), getattr(configs, name)
    assert configs.to_dict(tcls()) == jconfigs.to_dict(jcls())
    jcfg = jcls(no=3) if name != "UEGConfig" else jcls(rs=0.5, cutoff=5)
    assert configs.to_dict(tcls(**jconfigs.to_dict(jcfg))) == \
        jconfigs.to_dict(jcfg)


def _same_attrs(t, j, names):
    for a in names:
        assert getattr(t, a) == getattr(j, a), a


@pytest.mark.parametrize("make", ["make_ccd", "make_ccsd"])
def test_ground_state_solvers_equal(make):
    kw = dict(no=7, delta_e=1e-9, max_iter=40, diis_dim=4, is_dcd=True,
              log_iterations=True)
    if make == "make_ccd":
        kw.update(is_bruekner=True, is_diis=False)
    t = getattr(configs.GroundStateConfig(**kw), make)(device="cpu")
    j = getattr(jconfigs.GroundStateConfig(**kw), make)()
    assert t.device == torch.device("cpu")
    _same_attrs(t, j, ATTRS[make])


@pytest.mark.parametrize("name", ["EOMConfig", "FEASTConfig", "RTConfig"])
def test_excited_state_solvers_equal(name):
    kw = {"EOMConfig": dict(no=2, n_excit=2, e_epsilon=1e-9),
          "FEASTConfig": dict(no=2, e_c=0.12, e_r=0.025, n_trial=2,
                              seed=7, ls_max_iter=60),
          "RTConfig": dict(no=1, e_c=0.5, e_r=0.6, n_quad=32)}[name]
    t = getattr(configs, name)(**kw).make(device="cpu")
    j = getattr(jconfigs, name)(**kw).make()
    assert t.device == torch.device("cpu")
    _same_attrs(t, j, ATTRS[name])
    if name == "FEASTConfig":   # the seeded trial generator
        assert np.array_equal(t._rng.random(4), j._rng.random(4))


def test_default_device_is_the_card():
    cfg = configs.GroundStateConfig(no=7)
    makers = (cfg.make_ccd, cfg.make_ccsd, configs.EOMConfig(no=7).make,
              configs.FEASTConfig(no=7).make, configs.RTConfig(no=7).make)
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                make()


def test_mixed_precision_refused():
    """``mixed_precision=True`` is refused by neither package: it is
    carried, not applied, by ``make_ccd``/``make_ccsd`` (the caller hands
    it to ``solve``), so both build solvers with equal settings and equal
    ``to_dict``."""
    kw = dict(no=7, mixed_precision=True, delta_e=1e-9, diis_dim=5)
    tcfg = configs.GroundStateConfig(**kw)
    jcfg = jconfigs.GroundStateConfig(**kw)
    assert configs.to_dict(tcfg) == jconfigs.to_dict(jcfg)
    assert configs.to_dict(tcfg)["mixed_precision"] is True
    for make in ("make_ccd", "make_ccsd"):
        t = getattr(tcfg, make)(device="cpu")
        _same_attrs(t, getattr(jcfg, make)(), ATTRS[make])


def test_ueg_model_equal():
    kw = dict(n_ele=14, rs=0.5, cutoff=5, k_shift=(1 / 3, 0.0, 0.0),
              correlator="gaskell", gamma=None, k_cutoff=1.0)
    t, j = configs.UEGConfig(**kw).make(), jconfigs.UEGConfig(**kw).make()
    assert isinstance(t, ueg.UEG)
    assert (t.n_ele, t.L, t.Omega, t.gamma, t.k_cutoff) == \
        (j.n_ele, j.L, j.Omega, j.gamma, j.k_cutoff)
    assert t.correlator.__name__ == j.correlator.__name__ == "gaskell"
    for field in ("k_int", "kp", "kinetic"):
        assert np.array_equal(getattr(t.basis, field),
                              getattr(j.basis, field)), field


def _jax_mf_ccd(shift):
    u = jueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(5, list(shift))
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = jueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED,
                              dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = jhf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = jhf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    blocks = jccd.CCDBlocks(
        klij=d["klij"], ijab=d["ijab"], abij=d["abij"], iajb=d["iajb"],
        iabj=d["iabj"], abcd=None,
        ladder=jladder.build_block_ladder(u, preslice=None))
    cfg = jconfigs.GroundStateConfig(no=NO, max_iter=60, log_iterations=True)
    return cfg.make_ccd().solve(jnp.diag(jnp.concatenate([eps_i, eps_a])),
                                blocks, level_shift=-1.0,
                                contract_mode="xla")


def _port_mf_ccd(shift):
    u = configs.UEGConfig(n_ele=14, rs=0.5, cutoff=5,
                          k_shift=tuple(shift)).make()
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device="cpu", names=NEED)
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    blocks = ccd.CCDBlocks(
        klij=d["klij"], ijab=d["ijab"], abij=d["abij"], iajb=d["iajb"],
        iabj=d["iabj"], abcd=None,
        ladder=ueg_ladder.build_block_ladder(u, device="cpu"))
    solver = configs.GroundStateConfig(
        no=NO, max_iter=60, log_iterations=True).make_ccd(device="cpu")
    return solver.solve(torch.diag(torch.cat([eps_i, eps_a])), blocks,
                        level_shift=-1.0)


def _logged(text):
    return [(int(m[0]), float(m[1])) for m in re.findall(
        r"CCD it (\d+): E = (-?\d+\.\d+)  dE", text)]


@pytest.mark.parametrize("twist", [0, 1], ids=["gamma", "third_x"])
def test_config_built_mf_ccd_matches_jax(twist, capfd):
    """Γ and (1/3, 0, 0) of ``gen_ir_ks(3)``: the matrix-free CCD built
    through the configs, per iteration against the JAX package, and the
    logged iterations of both packages."""
    shift = gen_ir_ks(3)[0][twist]
    ref = _jax_mf_ccd(shift)
    log_j = _logged(capfd.readouterr().out)
    res = _port_mf_ccd(shift)
    log_t = _logged(capfd.readouterr().out)
    hist_t, hist_j = res["e history"], np.asarray(ref["e history"])
    assert len(hist_t) == len(hist_j) >= 4
    assert np.abs(hist_t - hist_j).max() <= 1e-10
    assert abs(res["ccd e"] - float(ref["ccd e"])) <= 1e-10
    assert [i for i, _ in log_t] == [i for i, _ in log_j] == \
        list(range(1, len(hist_t) + 1))
    assert np.abs(np.array([e for _, e in log_t]) - hist_t).max() <= 1e-12
