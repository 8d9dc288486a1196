"""The port's EOM-CCSD building blocks against the JAX package: the H̄
intermediates, the factorised sigma (against the JAX package's factorised
sigma and, in each operator form they take, its term lists, also through
the reference-name wrappers ``EOM_CCSD.update_singles`` /
``update_doubles``), the H̄ diagonals, the batched sigma in every operator
mode, the abij ladder entries and the batched ovvv gather, and the plain
twins of K5 (pair symmetrisation) and K6 (Davidson residual).

Systems: fully asymmetric random blocks (no=3, nv=6; any wrong term or
index order shows there), and the UEG 14e, rs=1.0, cutoff 2 (nP=19), dense
and matrix-free, with seeded T1 ≠ 0 dressing (a canonical UEG keeps
T1 ≡ 0, so a canonical run cannot show a wrong dressed term).  Inputs are
made with numpy from a seed and go through both packages
(``interop.eom_operator_from_numpy`` for the operator dicts).

Tolerance: 1e-12 relative to the largest entry on the random blocks and
the plans, 1e-11 on the UEG sigmas (f64, another summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.solver import eom_ccsd as jeom
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.kernels import davidson, pair_sym
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccsd as tccsd
from pymes_tpu_torch.solver import eom_ccsd as teom

REL = 1e-12
NO = 7
MF_DROP = ("abcd", "iabc", "abic", "aibc", "abci")


def _close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def random_blocks():
    """Fully asymmetric random f, V, T, u (no=3, nv=6) in both packages."""
    rng = np.random.default_rng(0)
    no, nv = 3, 6
    nb = no + nv
    f = rng.standard_normal((nb, nb))
    V = rng.standard_normal((nb,) * 4)
    T = rng.standard_normal((nv, nv, no, no))
    u1 = rng.standard_normal((nv, no))
    u2 = rng.standard_normal((nv, nv, no, no))
    dj = jpart(no, jnp.asarray(V))
    hj = jeom.build_hbar(jnp.asarray(f), dj, jnp.asarray(T))
    dt = tpart(no, torch.as_tensor(V))
    ht = teom.build_hbar(_t(f), dt, _t(T))
    return dict(f=f, T=T, u1=u1, u2=u2, dj=dj, dt=dt, hj=hj, ht=ht)


def test_build_hbar_matches_jax(random_blocks):
    s = random_blocks
    for name in teom.HbarIntermediates._fields:
        want, got = getattr(s["hj"], name), getattr(s["ht"], name)
        if want is None:
            assert got is None, name
        else:
            _close(got, want)


@pytest.mark.parametrize("which", ["singles_hbar", "doubles_hbar",
                                   "singles", "doubles"])
def test_sigma_matches_jax(random_blocks, which):
    """The factorised sigmas equal the JAX package's, and the port's
    reference-name wrappers (``EOM_CCSD.update_singles`` /
    ``update_doubles``, routed through the factorised sigma) equal the JAX
    package's term lists."""
    s = random_blocks
    jargs = [jnp.asarray(s[k]) for k in ("u1", "u2", "T")]
    targs = [_t(s[k]) for k in ("u1", "u2", "T")]
    fj, ft = jnp.asarray(s["f"]), _t(s["f"])
    if which.endswith("_hbar"):
        want = getattr(jeom, "sigma_" + which)(fj, s["dj"], s["hj"], *jargs)
        got = getattr(teom, "sigma_" + which)(ft, s["dt"], s["ht"], *targs)
    else:
        want = getattr(jeom, "sigma_" + which)(fj, s["dj"], *jargs)
        tc = teom.EOM_CCSD(s["u1"].shape[1], device="cpu")
        got = getattr(tc, "update_" + which)(ft, s["dt"], *targs)
    _close(got, want)


def _term_list_form(request, form):
    """(fock, JAX operator dict, T, u1, u2) of one operator form that the
    JAX package's term lists take: dense blocks with ``abcd`` (the random
    blocks), the T1-dressed blocks with ``abcd_t1`` on the all-bra plan in
    place of ``abcd``, and the bare blocks with the bare all-bra plan
    (T1 = 0; the sigma cuts the plan's virtual corner)."""
    if form == "dense":
        s = request.getfixturevalue("random_blocks")
        return s["f"], s["dj"], s["T"], s["u1"], s["u2"]
    s = request.getfixturevalue("ueg19")
    if form == "abcd_t1":
        fock, Vop = _modes(s)["abcd_t1"]
    else:
        fock = s["fock"]
        Vop = {**{k: np.asarray(v) for k, v in s["dict_V"].items()},
               "abcd": None,
               "abcd_ladder": jladder.build_block_ladder(s["u"], bra="all")}
    return fock, Vop, s["T2"], s["U1"][0], s["U2"][0]


@pytest.mark.parametrize("form", ["dense", "abcd_t1", "bare_plan"])
def test_factorised_sigma_equals_term_list(request, form):
    """In each operator form of the JAX term lists, the port's factorised
    sigma and its reference-name wrappers equal the JAX package's
    ``sigma_singles`` / ``sigma_doubles``."""
    fock, Vop, T, u1, u2 = _term_list_form(request, form)
    no = u1.shape[1]
    Vt = interop.eom_operator_from_numpy(Vop, "cpu")
    if form != "dense":
        assert Vt["abcd"] is None and Vt.get("iabc") is not None
    jargs = [jnp.asarray(x) for x in (u1, u2, T)]
    targs = [_t(x) for x in (u1, u2, T)]
    fj, ft = jnp.asarray(fock), _t(fock)
    hbar = teom.build_hbar(ft, Vt, targs[2])
    tc = teom.EOM_CCSD(no, device="cpu", n_excit=2)
    for which in ("singles", "doubles"):
        want = getattr(jeom, "sigma_" + which)(fj, Vop, *jargs)
        _close(getattr(teom, "sigma_" + which + "_hbar")(ft, Vt, hbar,
                                                         *targs), want)
        _close(getattr(tc, "update_" + which)(ft, Vt, *targs), want)


def test_eom_class_helpers_match_jax(random_blocks):
    """EOM_CCSD.update_singles / update_doubles (the factorised sigma,
    H̄'s intermediates built in the call) and the QR of a packed subspace
    equal the JAX class's (whose wrappers run its term lists)."""
    s = random_blocks
    no = s["u1"].shape[1]
    jc = jeom.EOM_CCSD(no, n_excit=2)
    tc = teom.EOM_CCSD(no, device="cpu", n_excit=2)
    jargs = [jnp.asarray(s[k]) for k in ("u1", "u2", "T")]
    targs = [_t(s[k]) for k in ("u1", "u2", "T")]
    for name in ("update_singles", "update_doubles"):
        _close(getattr(tc, name)(_t(s["f"]), s["dt"], *targs),
               getattr(jc, name)(jnp.asarray(s["f"]), s["dj"], *jargs))
    rng = np.random.default_rng(2)
    us = [rng.standard_normal(s["u1"].shape) for _ in range(3)]
    ud = [rng.standard_normal(s["u2"].shape) for _ in range(3)]
    for got, want in zip(tc.QR(us, ud), jc.QR(us, ud)):
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("which", ["singles", "doubles"])
def test_diag_matches_jax(random_blocks, which):
    s = random_blocks
    want = getattr(jeom, "get_diag_" + which)(jnp.asarray(s["f"]), s["dj"],
                                              jnp.asarray(s["T"]))
    got = getattr(teom, "get_diag_" + which)(_t(s["f"]), s["dt"],
                                             _t(s["T"]))
    _close(got, want)


def test_batched_sigma_equals_single(random_blocks):
    """A batch of three trials gives each trial's single sigma."""
    s = random_blocks
    rng = np.random.default_rng(1)
    U1 = _t(rng.standard_normal((3,) + s["u1"].shape))
    U2 = _t(rng.standard_normal((3,) + s["u2"].shape))
    f, T = _t(s["f"]), _t(s["T"])
    W1, W2 = teom._sigma_batched_hbar(f, s["dt"], s["ht"], U1, U2, T)
    for n in range(3):
        _close(W1[n], teom.sigma_singles_hbar(f, s["dt"], s["ht"], U1[n],
                                              U2[n], T).numpy())
        _close(W2[n], teom.sigma_doubles_hbar(f, s["dt"], s["ht"], U1[n],
                                              U2[n], T).numpy())


# ---- UEG nP=19: dense, matrix-free and T1-dressed operators --------------

@pytest.fixture(scope="module")
def ueg19():
    """UEG 14e, rs=1.0, cutoff 2 with the seeded non-canonical Fock
    (noise rng(5)·0.02, symmetrised), seeded T1/T2, the T1-dressed dense
    blocks and Fock of the JAX package, and the matrix-free plans."""
    uj = jueg.UEG(14, 7, 7, 1.0)
    uj.init_single_basis(2)
    V = np.asarray(uj.eval_2b_integrals())
    nv = uj.n_spatial - NO
    fock = np.asarray(jhf.construct_hf_matrix(
        NO, np.diag(uj.kinetic_energies()), V))
    noise = np.random.default_rng(5).standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T
    rng = np.random.default_rng(8)
    T1 = rng.standard_normal((nv, NO)) * 0.02
    T2 = rng.standard_normal((nv, nv, NO, NO)) * 0.02
    T2 = 0.5 * (T2 + T2.transpose(1, 0, 3, 2))
    dict_V = jpart(NO, jnp.asarray(V))
    cc = jccsd.CCSD(NO)
    fd = np.asarray(cc.get_T1_dressed_fock(fock, T1, dict_V))
    Vd = {k: np.asarray(v) for k, v in
          cc.get_T1_dressed_V(T1, dict_V).items()}
    U1 = rng.standard_normal((2, nv, NO))
    U2 = rng.standard_normal((2, nv, nv, NO, NO))
    return dict(u=uj, V=V, dict_V=dict_V, fock=fock, T1=T1, T2=T2, fd=fd,
                Vd=Vd, U1=U1, U2=U2, nv=nv)


def _modes(s):
    """name → (fock, EOM operator dict as numpy/JAX objects)."""
    u = s["u"]
    Vd = s["Vd"]
    plans = jladder.build_ovvv_plans(u)
    all_bra = jladder.build_block_ladder(u, bra="all")
    mf = {k: v for k, v in Vd.items() if k not in MF_DROP}
    return {
        "dense": (s["fd"], Vd),
        # matrix-free T1-dressed ladder, dense ovvv blocks
        "abcd_t1": (s["fd"], {**{k: v for k, v in Vd.items()
                                 if k != "abcd"},
                              "abcd": None, "abcd_ladder": all_bra,
                              "abcd_t1": s["T1"]}),
        # no ovvv block, T1-dressed: gathers + bare small blocks
        "no_ovvv_t1": (s["fd"], {**mf, "abcd": None, "abcd_ladder": all_bra,
                                 "abcd_t1": s["T1"], "_ovvv_plans": plans,
                                 "_bare": {k: np.asarray(s["dict_V"][k])
                                           for k in ("iajb", "iabj",
                                                     "ijka")}}),
        # no ovvv block, undressed operator (T1 = 0: the bare blocks)
        "no_ovvv": (s["fock"], {**{k: np.asarray(v) for k, v in
                                   s["dict_V"].items()
                                   if k not in MF_DROP},
                                "abcd": None, "abcd_ladder": all_bra,
                                "_ovvv_plans": plans}),
    }


@pytest.mark.parametrize("mode", ["dense", "abcd_t1", "no_ovvv_t1",
                                  "no_ovvv"])
def test_batched_sigma_ueg_matches_jax_and_dense(ueg19, mode):
    """The batched sigma of two trials in each operator mode: against the
    JAX package's batched sigma on the same operator, and against the
    port's dense sigma of the same (dressed or bare) Hamiltonian."""
    s = ueg19
    fock, Vop = _modes(s)[mode]
    T2, U1, U2 = s["T2"], s["U1"], s["U2"]
    W1j, W2j = jeom.EOM_CCSD(NO, n_excit=2)._batched_sigma(
        jnp.asarray(fock), Vop, U1, U2, jnp.asarray(T2))
    Vt = interop.eom_operator_from_numpy(Vop, "cpu")
    W1, W2 = teom.EOM_CCSD(NO, device="cpu", n_excit=2)._batched_sigma(
        _t(fock), Vt, _t(U1), _t(U2), _t(T2))
    _close(W1, W1j, 1e-11)
    _close(W2, W2j, 1e-11)
    # the same Hamiltonian with dense blocks
    dense = (s["dict_V"] if mode == "no_ovvv" else s["Vd"])
    Vdense = interop.eom_operator_from_numpy(dense, "cpu")
    W1d, W2d = teom.EOM_CCSD(NO, device="cpu", n_excit=2)._batched_sigma(
        _t(fock), Vdense, _t(U1), _t(U2), _t(T2))
    _close(W1, W1d.numpy(), 1e-11)
    _close(W2, W2d.numpy(), 1e-11)


def test_build_hbar_no_ovvv_noncanonical_matches_jax(ueg19):
    """W_laji (the (o,v) corner of the all-bra ladder on T2) and the other
    intermediates in the T1-dressed no-ovvv mode, T1 ≠ 0."""
    s = ueg19
    fock, Vop = _modes(s)["no_ovvv_t1"]
    hj = jeom.build_hbar(jnp.asarray(fock), Vop, jnp.asarray(s["T2"]))
    ht = teom.build_hbar(_t(fock), interop.eom_operator_from_numpy(Vop,
                                                                   "cpu"),
                         _t(s["T2"]))
    assert ht.W_laji.shape == (NO, s["nv"], NO, NO)
    for name in teom.HbarIntermediates._fields:
        _close(getattr(ht, name), getattr(hj, name), 1e-11)


def test_diag_matrix_free_matches_jax(ueg19):
    """The doubles diagonal with the ladder plan's w0 term."""
    s = ueg19
    fock, Vop = _modes(s)["no_ovvv"]
    Vt = interop.eom_operator_from_numpy(Vop, "cpu")
    for name in ("singles", "doubles"):
        want = getattr(jeom, "get_diag_" + name)(jnp.asarray(fock), Vop,
                                                 jnp.asarray(s["T2"]))
        _close(getattr(teom, "get_diag_" + name)(_t(fock), Vt, _t(s["T2"])),
               want)


def test_abij_ladder_entries_match_jax(ueg19):
    """block_ladder_apply on one and on a batch of abij operands, the
    dressed ladder and the batched ovvv gather against the JAX package."""
    s = ueg19
    u = s["u"]
    pj = jladder.build_block_ladder(u, bra="all")
    pt = interop.block_ladder_from_numpy(pj, "cpu")
    U2 = s["U2"]
    one = tladder.block_ladder_apply(pt, _t(U2[0]))
    _close(one, jladder.block_ladder_apply(pj, jnp.asarray(U2[0])))
    batch = tladder.ladder_apply(pt, _t(U2))
    for n in range(2):
        _close(batch[n], jladder.ladder_apply(pj, jnp.asarray(U2[n])))
    dressed = tladder.dressed_ladder_apply(pt, _t(s["T1"]), _t(U2), NO)
    for n in range(2):
        _close(dressed[n], jladder.dressed_ladder_apply(
            pj, jnp.asarray(s["T1"]), jnp.asarray(U2[n]), NO))
    plans_j = jladder.build_ovvv_plans(u)
    plans_t = interop.ovvv_plans_from_numpy(plans_j, "cpu")
    for pat in ("ovv", "vov", "vvo"):
        got = tladder.ovvv_t1_apply(plans_t[pat], _t(s["U1"]))
        for n in range(2):
            _close(got[n], jladder.ovvv_t1_apply(plans_j[pat],
                                                 jnp.asarray(s["U1"][n])))


def test_eom_operator_from_numpy(ueg19):
    _, Vop = _modes(ueg19)["no_ovvv_t1"]
    Vt = interop.eom_operator_from_numpy(Vop, "cpu")
    assert Vt["abcd"] is None
    assert isinstance(Vt["abcd_ladder"], tladder.BlockLadder)
    assert isinstance(Vt["_ovvv_plans"]["vov"], tladder.OVVVPlan)
    assert set(Vt["_bare"]) == {"iajb", "iabj", "ijka"}
    for k in ("ijab", "abcd_t1"):
        assert Vt[k].dtype == torch.float64
        _close(Vt[k], Vop[k], 0.0)


def test_eom_dressed_keys_match_jax():
    assert tccsd.EOM_DRESSED == jccsd.EOM_DRESSED


# ---- the plain twins of K5 and K6 ---------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 5, 5), (2, 5, 5, 3, 3)])
@pytest.mark.parametrize("with_y", [False, True])
def test_pair_symmetrize_twin(shape, with_y):
    """K5's twin: Y + X[p,q,r,s] + X[q,p,s,r] on both layouts, with and
    without a batch axis, element by element."""
    rng = np.random.default_rng(len(shape))
    X = rng.standard_normal(shape)
    Y = rng.standard_normal(shape) if with_y else np.zeros(shape)
    want = Y + X + np.swapaxes(np.swapaxes(X, -4, -3), -2, -1)
    got = pair_sym.pair_symmetrize(_t(X), _t(Y) if with_y else None)
    _close(got, want, 0.0)


def test_davidson_residual_twin_matches_jax():
    """K6's twin against the JAX package's _residual_precond, with m < the
    buffer rows and denominators inside the clamp."""
    rng = np.random.default_rng(11)
    max_dim, N, k, m = 8, 40, 2, 5
    U = np.zeros((max_dim, N))
    W = np.zeros((max_dim, N))
    U[:m] = rng.standard_normal((m, N))
    W[:m] = rng.standard_normal((m, N))
    v = np.zeros((max_dim, k))
    v[:m] = rng.standard_normal((m, k))
    e = np.array([0.3, 1.1])
    diag = rng.standard_normal(N)
    diag[:3] = e[0] + np.array([0.0, 3e-6, -4e-6])   # inside the clamp
    want = jeom._residual_precond(jnp.asarray(U), jnp.asarray(W),
                                  jnp.asarray(v), jnp.asarray(e),
                                  jnp.asarray(diag))
    got = davidson.davidson_residual(_t(U), _t(W), _t(v), _t(e), _t(diag),
                                     m)
    _close(got, want)
