"""The port's CCSD building blocks against the JAX package: the ovvv gather
twin (K4's plain version), the T1 dressing of every block the doubles
residual needs (dense and matrix-free, with the ``half_symmetric`` /
``out_perm`` / ``skip_identity`` options), the dressed Fock, the singles
residual, the dressed ladder, the doubles residual with the CCSD hooks, the
energy, one whole ``ccsd_iteration``, and the CCSD tail twins (K2′/K3′'s
plain versions) against one JAX tail step.

Systems: LiH/3-21G and TC-LiH (FCIDUMP + TCDUMP corrections) for the dense
molecular path; the UEG 14e, rs=1.0, cutoff 2 (nP=19) with the seeded
non-canonical Fock (momentum conservation keeps T1 ≡ 0 on a canonical UEG,
so a canonical run cannot show a wrong dressing), dense and matrix-free.
T1/T2 are seeded with numpy and go through both packages.

Tolerance: 1e-12 relative to the largest entry (f64, another summation
order); the iteration's energy 1e-12 absolute.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.integral import contraction as jcontraction
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.mixer import diis as jdiis
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.util import fcidump, tcdump
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.kernels import ccsd_tail
from pymes_tpu_torch.mixer import diis as tdiis
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccd as tccd
from pymes_tpu_torch.solver import ccsd as tccsd

DATA = os.path.join(os.path.dirname(__file__), "data")
REL = 1e-12
MF_DROP = ("abcd", "abci", "iabc", "aibc", "abic")


def _close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def _system(fock, V, no, jax_dict=None, torch_dict=None, plan=None, seed=3):
    nb = fock.shape[0]
    nv = nb - no
    rng = np.random.default_rng(seed)
    T1 = rng.standard_normal((nv, no)) * 0.05
    T2 = rng.standard_normal((no, no, nv, nv)) * 0.05
    T2 = 0.5 * (T2 + T2.transpose(1, 0, 3, 2))   # P(ab,ij)-symmetric
    dj = jax_dict if jax_dict is not None else jpart(no, jnp.asarray(V))
    dt = torch_dict if torch_dict is not None else tpart(
        no, torch.as_tensor(V))
    return dict(no=no, nv=nv, T1=T1, T2=T2, fock=fock, dj=dj, dt=dt,
                plan=plan)


def _lih():
    n_elec, _, _, _, h, V = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    return _system(np.array(jhf.construct_hf_matrix(no, h, V)), V, no)


def _tc_lih():
    n_elec, _, _, _, h, V = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.tc"), is_tc=True)
    no = n_elec // 2
    L = tcdump.read(os.path.join(DATA, "TCDUMP.LiH_FNO"))
    fock = (np.asarray(jhf.construct_hf_matrix(no, h, V))
            + jcontraction.get_double_contraction(no, L))
    return _system(fock, V + jcontraction.get_single_contraction(no, L), no)


def _ueg(matrix_free):
    u = jueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    fock = np.asarray(jhf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    noise = np.random.default_rng(5).standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T
    if not matrix_free:
        return _system(fock, V, no)
    dj = {k: v for k, v in jpart(no, jnp.asarray(V)).items()
          if k not in MF_DROP}
    dj["_ovvv_plans"] = jladder.build_ovvv_plans(u)
    plan = jladder.build_block_ladder(u, bra="all", preslice=None)
    return _system(fock, V, no, jax_dict=dj,
                   torch_dict=interop.blocks_from_numpy(dj, "cpu"),
                   plan=(plan, interop.block_ladder_from_numpy(plan, "cpu")))


SYSTEMS = {"lih": _lih, "tc_lih": _tc_lih,
           "ueg": lambda: _ueg(False), "ueg_mf": lambda: _ueg(True)}
_CACHE = {}


def system(name):
    if name not in _CACHE:
        _CACHE[name] = SYSTEMS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_ovvv_gather_twin_matches_jax(cutoff, pat):
    u = jueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    plan_j = jladder.build_ovvv_plans(u)[pat]
    plan_t = interop.ovvv_plans_from_numpy({pat: plan_j}, "cpu")[pat]
    T1 = np.random.default_rng(cutoff).standard_normal(
        (u.n_spatial - 7, 7))
    want = jladder.ovvv_t1_apply_j(plan_j, T1)
    got = tladder.ovvv_t1_apply_j(plan_t, torch.as_tensor(T1))
    _close(got, want)
    assert bool((got.numpy()[:, np.asarray(plan_j.S) < 0] == 0).all())


@pytest.mark.parametrize("key", jccsd.DOUBLES_DRESSED)
@pytest.mark.parametrize("name", ["lih", "ueg"])
def test_dressed_block_matches_jax(name, key):
    s = system(name)
    _close(tccsd.dressed_block(key, s["dt"], torch.as_tensor(s["T1"])),
           jccsd.dressed_block(key, s["dj"], jnp.asarray(s["T1"])))


def test_get_T1_dressed_V_all_blocks_matches_jax():
    s = system("tc_lih")
    got = tccsd.get_T1_dressed_V(torch.as_tensor(s["T1"]), s["dt"])
    want = jccsd.get_T1_dressed_V(jnp.asarray(s["T1"]), s["dj"])
    assert got.keys() == want.keys() and len(got) == 16
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", ["ueg", "ueg_mf"])
@pytest.mark.parametrize("opts", [
    dict(key="abij", skip_sources=("abcd",), out_perm=(2, 3, 0, 1),
         skip_identity=True, half_symmetric=True),
    dict(key="abij", skip_sources=("abcd",), out_perm=(2, 3, 0, 1)),
    dict(key="iajb", skip_identity=True),
    dict(key="iabj", out_perm=(0, 3, 2, 1)),
    dict(key="klij", half_symmetric=True),
], ids=["abij_half", "abij_perm", "iajb_skip_id", "iabj_perm", "klij_half"])
def test_dressed_block_options_match_jax(name, opts):
    s = system(name)
    opts = dict(opts)
    key = opts.pop("key")
    got = tccsd.dressed_block(key, s["dt"], torch.as_tensor(s["T1"]),
                              **opts)
    _close(got, jccsd.dressed_block(key, s["dj"], jnp.asarray(s["T1"]),
                                    **opts))
    if opts.get("half_symmetric") and not opts.get("skip_identity"):
        # S + P(S) is the full dressing
        full = tccsd.dressed_block(key, s["dt"], torch.as_tensor(s["T1"]))
        _close(got + got.permute(1, 0, 3, 2), full)


@pytest.mark.parametrize("name", ["lih", "tc_lih", "ueg", "ueg_mf"])
def test_dressed_fock_matches_jax(name):
    s = system(name)
    no = s["no"]
    got = tccsd.get_T1_dressed_fock(torch.as_tensor(s["fock"]),
                                    torch.as_tensor(s["T1"]), s["dt"], no=no)
    _close(got, jccsd.get_T1_dressed_fock(
        jnp.asarray(s["fock"]), jnp.asarray(s["T1"]), s["dj"], no=no))


def _ladder_W(s):
    """The all-bra W[i,j,p,q] of the matrix-free system, both packages."""
    Wj = jladder.block_ladder_apply_ij(s["plan"][0], jnp.asarray(s["T2"]))
    Wt = tladder.block_ladder_apply_ij(s["plan"][1], torch.as_tensor(s["T2"]))
    return Wj, Wt


@pytest.mark.parametrize("name", ["tc_lih", "ueg_mf"])
def test_singles_residual_matches_jax(name):
    s = system(name)
    no = s["no"]
    fd = jccsd.get_T1_dressed_fock(jnp.asarray(s["fock"]),
                                   jnp.asarray(s["T1"]), s["dj"], no=no)
    Wj = Wt = None
    if s["plan"] is not None:
        Wj, Wt = _ladder_W(s)
        _close(Wt, Wj)
    want = jccsd.singles_residual_ij(fd, jnp.asarray(s["T1"]),
                                     jnp.asarray(s["T2"]), s["dj"],
                                     ladder_W=Wj)
    got = tccsd.singles_residual_ij(torch.tensor(np.asarray(fd)),
                                    torch.as_tensor(s["T1"]),
                                    torch.as_tensor(s["T2"]), s["dt"],
                                    ladder_W=Wt)
    _close(got, want)


def test_dressed_ladder_and_doubles_hooks_match_jax():
    s = system("ueg_mf")
    no = s["no"]
    T1, T2 = s["T1"], s["T2"]
    Wj, Wt = _ladder_W(s)
    want = jladder.dressed_ladder_apply_ij(s["plan"][0], jnp.asarray(T1),
                                           jnp.asarray(T2), no)
    got = tladder.dressed_ladder_apply_ij(s["plan"][1], torch.as_tensor(T1),
                                          torch.as_tensor(T2), no)
    _close(got, want)
    _close(tladder.dressed_ladder_apply_ij(
        s["plan"][1], torch.as_tensor(T1), torch.as_tensor(T2), no, W=Wt),
        want)

    # the doubles residual with t_T_ai / ladder_W / ex_half / abij_t=None
    ex_j = jccsd.dressed_block("abij", s["dj"], jnp.asarray(T1),
                               skip_sources=("abcd",), out_perm=(2, 3, 0, 1),
                               skip_identity=True, half_symmetric=True)
    ex_t = torch.tensor(np.asarray(ex_j))
    fock = s["fock"]
    for abij_t in (None, np.asarray(s["dj"]["abij"]).transpose(2, 3, 0, 1)):
        blk_j = jccd.CCDBlocksIJ(
            klij=s["dj"]["klij"], ijab=s["dj"]["ijab"], ijab_x=None,
            abij_t=None if abij_t is None else jnp.asarray(abij_t),
            ikac=jnp.transpose(s["dj"]["iajb"], (2, 0, 1, 3)),
            kjcb=jnp.transpose(s["dj"]["iabj"], (0, 3, 2, 1)), abcd=None,
            ladder=s["plan"][0], ladder_W=Wj, ex_half=ex_j)
        blk_t = tccd.CCDBlocksIJ(
            klij=s["dt"]["klij"], ijab=s["dt"]["ijab"], ijab_x=None,
            abij_t=None if abij_t is None else torch.tensor(abij_t),
            ikac=s["dt"]["iajb"].permute(2, 0, 1, 3),
            kjcb=s["dt"]["iabj"].permute(0, 3, 2, 1), abcd=None,
            ladder=s["plan"][1], ladder_W=Wt, ex_half=ex_t)
        Rj = jccd.doubles_residual_ij(
            jnp.asarray(fock[no:, no:]), jnp.asarray(fock[:no, :no]),
            jnp.asarray(T2), blk_j, t_T_ai=jnp.asarray(T1))
        Rt = tccd.doubles_residual_ij(
            torch.as_tensor(fock[no:, no:]), torch.as_tensor(fock[:no, :no]),
            torch.as_tensor(T2), blk_t, t_T_ai=torch.as_tensor(T1))
        _close(Rt, Rj)


def test_ccsd_energy_matches_jax():
    s = system("tc_lih")
    no = s["no"]
    want = jccsd.ccsd_energy_ij(jnp.asarray(s["fock"][:no, no:]),
                                jnp.asarray(s["T1"]), jnp.asarray(s["T2"]),
                                s["dj"]["ijab"])
    got = tccsd.ccsd_energy_ij(torch.as_tensor(s["fock"][:no, no:]),
                               torch.as_tensor(s["T1"]),
                               torch.as_tensor(s["T2"]), s["dt"]["ijab"])
    for a, b in zip(got, want):
        _close(a, b)


def _rings(n_flat, count, m=6, seed=11):
    """A DIIS state after ``count`` insertions, seeded, in both packages."""
    rng = np.random.default_rng(seed)
    n_valid = min(count, m)
    amps = np.zeros((m, n_flat))
    errs = np.zeros((m, n_flat))
    amps[:n_valid] = rng.standard_normal((n_valid, n_flat)) * 0.05
    errs[:n_valid] = rng.standard_normal((n_valid, n_flat)) * 1e-3
    B = errs @ errs.T
    sj = jdiis.DIISState(amps=jnp.asarray(amps), errs=jnp.asarray(errs),
                         count=jnp.asarray(count, jnp.int32),
                         B=jnp.asarray(B))
    # copies: the port updates its rings in place
    st = tdiis.DIISState(amps=torch.tensor(amps), errs=torch.tensor(errs),
                         count=count, B=torch.tensor(B))
    return sj, st


@pytest.mark.parametrize("count", [0, 7], ids=["first", "full_ring"])
@pytest.mark.parametrize("name", ["tc_lih", "ueg_mf"])
def test_ccsd_iteration_matches_jax(name, count):
    s = system(name)
    no, nv = s["no"], s["nv"]
    fock = s["fock"]
    eps = np.diag(fock).copy()   # np.diag returns a read-only view
    eps_i, eps_a = eps[:no], eps[no:]
    shift = -0.5
    D_ai = 1.0 / (eps_i[None, :] - eps_a[:, None] + shift)
    D2 = 1.0 / (eps_i[:, None, None, None] + eps_i[None, :, None, None]
                - eps_a[None, None, :, None] - eps_a[None, None, None, :]
                + shift)
    sj, st = _rings(nv * no + no * no * nv * nv, count)
    dj = dict(s["dj"])
    dj["abij_t"] = jnp.transpose(dj["abij"], (2, 3, 0, 1))
    dt = dict(s["dt"])
    dt["abij_t"] = dt["abij"].permute(2, 3, 0, 1).contiguous()
    e_last = -0.3
    plan_j, plan_t = s["plan"] if s["plan"] is not None else (None, None)
    T1j, T2j, sj, ej, dEj = jccsd.ccsd_iteration(
        jnp.asarray(fock), dj, no, jnp.asarray(s["T1"]),
        jnp.asarray(s["T2"]), jnp.asarray(D_ai), jnp.asarray(D2), sj,
        jnp.asarray(e_last), ladder_all=plan_j, layout="ijab")
    T1t, T2t = torch.tensor(s["T1"]), torch.tensor(s["T2"])  # updated in place
    st, et, dEt, info = tccsd.ccsd_iteration(
        torch.as_tensor(fock), dt, no, T1t, T2t,
        torch.as_tensor(eps_i), torch.as_tensor(eps_a), shift, st,
        torch.tensor(e_last, dtype=torch.float64), ladder_all=plan_t)
    assert int(info) == 0 and st.count == count + 1
    _close(T1t, T1j)
    _close(T2t, T2j)
    _close(st.amps, sj.amps)
    _close(st.errs, sj.errs)
    assert abs(float(et) - float(ej)) <= 1e-12
    assert abs(float(dEt) - float(dEj)) <= 1e-12


@pytest.mark.parametrize("slot,n_valid", [(0, 1), (2, 6)])
def test_ccsd_tail_twins_match_jax_step(slot, n_valid):
    """K2′/K3′'s plain versions against one JAX tail step
    (``pymes_tpu/solver/ccsd.py:615-634``) on seeded residuals."""
    s = system("ueg")
    no, nv = s["no"], s["nv"]
    rng = np.random.default_rng(slot)
    R1 = rng.standard_normal((nv, no)) * 0.01
    R2 = rng.standard_normal((no, no, nv, nv)) * 0.01
    fock = s["fock"]
    eps = np.diag(fock).copy()   # np.diag returns a read-only view
    eps_i, eps_a = eps[:no], eps[no:]
    shift = -1.0
    D_ai = 1.0 / (eps_i[None, :] - eps_a[:, None] + shift)
    D2 = 1.0 / (eps_i[:, None, None, None] + eps_i[None, :, None, None]
                - eps_a[None, None, :, None] - eps_a[None, None, None, :]
                + shift)
    count = slot if n_valid < 6 else 6 + slot
    sj, st = _rings(nv * no + no * no * nv * nv, count)
    # JAX: Jacobi, diis.mix over the flat [T1 | T2], energy
    dT1, dT2 = R1 * D_ai, R2 * D2
    T1n, T2n = s["T1"] + dT1, s["T2"] + dT2
    sj, mixed = jdiis.mix(sj, jnp.concatenate([dT1.ravel(), dT2.ravel()]),
                          jnp.concatenate([T1n.ravel(), T2n.ravel()]))
    mixed = np.asarray(mixed)
    T1j = mixed[:nv * no].reshape(nv, no)
    T2j = mixed[nv * no:].reshape(no, no, nv, nv)
    ej = jccsd.ccsd_energy_ij(jnp.asarray(fock[:no, no:]), T1j, T2j,
                              s["dj"]["ijab"])
    # port: K2′'s twin, the DIIS coefficients, K3′'s twin
    T1t, T2t = torch.tensor(s["T1"]), torch.tensor(s["T2"])  # updated in place
    assert (count % 6, min(count + 1, 6)) == (slot, n_valid)
    row = ccsd_tail.jacobi_diis_insert(
        torch.as_tensor(R1), T1t, torch.as_tensor(R2), T2t,
        torch.as_tensor(eps_i), torch.as_tensor(eps_a), shift, st.errs,
        st.amps, slot, n_valid)
    _close(st.errs, sj.errs)
    _close(st.amps, sj.amps)
    _, coeff, info = tdiis.coefficients(st.B, row, slot, n_valid)
    assert int(info) == 0
    et = ccsd_tail.diis_mix_energy(
        st.amps, coeff, n_valid, T1t, T2t,
        *tccsd.energy_blocks(torch.as_tensor(fock), s["dt"], no))
    _close(T1t, T1j)
    _close(T2t, T2j)
    for a, b in zip(et, ej):
        _close(a, b)
