"""The port's precision modes against the JAX package's, on the CPU (the
kernels' f32 and f64 twins; the JAX package as its own tests run it, CPU
and x64, its f32 parts at full f32):

* the EOM mixed-precision Davidson (``EOM_CCSD.precision="mixed"``, the
  JAX package's default): an f32 seed phase, then the f64 polish seeded
  with its Ritz vectors, on the UEG nP=19 no-ovvv operator and on dressed
  LiH/3-21G; the polish alone from one f64 seed; the f32 ``_orth_append``;
* CCD and CCSD ``solve(mixed_precision=True)`` (an f32 bulk, then f64),
  the DIIS on f32 rings, CCD's mixed bulk beside ``ring_mesh``, and the
  CCSD ``dress_precision``, which takes the f64 dressing only;
* the f32 twins of K2/K3, K2′/K3′, K4's fused trace and K6 against their
  f64 twins.

Inputs come from numpy seeds or the JAX package's set-up, and each
package gets the same ones.  Tolerances: roots within 1e-8 (the Davidson
threshold ``e_epsilon``; the two packages' f32 phases round differently,
so their seeds and polishes differ at that level), the polish from one f64
seed per iteration within 1e-10, iteration counts within 2 (EOM phases)
or 1 (the f32 ground-state passes, which stop on an f32 |dE|); energies
within 1e-9 of the JAX package's run of the same mode and 1e-8 of its f64
run (the f64 polish stops at |dE| < 1e-8); DIIS coefficients within 1e-6
(f32 Gram rows); the f32 twins within 1e-5 relative (f32 rounding, ~6e-8
an operation, over sums of up to a few hundred terms).
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.mean_field import hf as jhf
from pymes_tpu.mixer import diis as jdiis
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccd as jccd
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu.solver import eom_ccsd as jeom
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu_torch import interop
from pymes_tpu_torch.kernels import ccd_tail, ccsd_tail, davidson
from pymes_tpu_torch.kernels import ovvv_gather
from pymes_tpu_torch.mixer import diis as tdiis
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.solver import ccd as tccd
from pymes_tpu_torch.solver import ccsd as tccsd
from pymes_tpu_torch.solver import eom_ccsd as teom

DATA = os.path.join(os.path.dirname(__file__), "data")
NO = 7
MF_DROP = ("abcd", "iabc", "abic", "aibc", "abci")
LIH_ROOTS = (0.1180867117168979, 0.154376205595602)
F32_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These solves run many small tensor operations, which more threads
    only slow down where several test processes share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logged(fn):
    """``fn()`` with its printed log captured: (result, log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _f32_iterations(log):
    return int(re.search(r"mixed precision: (\d+) f32 iterations",
                         log).group(1))


def _spy(monkeypatch, module, name):
    """Wrap ``module.name`` to record the dtypes of the tensor arguments
    of every call; returns the list of records."""
    real, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append(tuple(a.dtype for a in args
                           if isinstance(a, torch.Tensor)))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture(scope="module")
def ueg19():
    """UEG 14e, rs=1.0, cutoff 2 (nP=19) through the JAX package: the HF
    Fock, the dense blocks, the converged CCD T2 (dense, shift −1) and the
    no-ovvv EOM operator, as numpy; the port's operator and plans."""
    u = jueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    fock = np.array(jhf.construct_hf_matrix(
        NO, np.diag(u.kinetic_energies()), V))
    T2 = np.array(_logged(lambda: jccd.CCD(NO).solve(
        fock, V, level_shift=-1.0, max_iter=60))[0]["t2 amp"])
    dense = {k: np.array(v) for k, v in jpart(NO, jnp.asarray(V)).items()}
    mf = {k: v for k, v in dense.items() if k not in MF_DROP}
    mf.update(abcd=None, abcd_ladder=jladder.build_block_ladder(u, bra="all"),
              _ovvv_plans=jladder.build_ovvv_plans(u))
    tu = tueg.UEG(14, 7, 7, 1.0)
    tu.init_single_basis(2)
    return dict(u=u, tu=tu, V=V, fock=fock, T2=T2, dense=dense, mf=mf,
                Vt=interop.eom_operator_from_numpy(mf, "cpu"),
                nv=u.n_spatial - NO)


@pytest.fixture(scope="module")
def lih():
    """LiH/3-21G: the HF Fock and V, and the EOM input from the JAX
    package's CCSD (|dE| < 1e-12): the T1-dressed Fock and blocks and T2,
    as numpy."""
    n_elec, _, _, _, h, V = jfcidump.read(os.path.join(DATA,
                                                       "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = np.array(jhf.construct_hf_matrix(no, h, V))
    cc = jccsd.CCSD(no)
    res = _logged(lambda: cc.solve(fock, V, delta_e=1e-12))[0]
    dV = jpart(no, V)
    fd = np.array(cc.get_T1_dressed_fock(fock, res["t1"], dV))
    Vd = {k: np.array(v) for k, v in cc.get_T1_dressed_V(
        res["t1"], dV, {k: None for k in jccsd.EOM_DRESSED}).items()}
    return dict(no=no, fock=fock, V=np.array(V), fd=fd, Vd=Vd,
                t2=np.array(res["t2"]))


# ---- EOM-CCSD precision="mixed" -------------------------------------------

def _jax_mixed_eom(fock, V, T2, no):
    """The JAX package's default EOM (mixed): roots, f32-phase and polish
    iterations (the f32 phase's from its tracking log)."""
    s = jeom.EOM_CCSD(no, n_excit=2)
    assert s.precision == "mixed"
    s.max_iter = 1000
    s._debug_track = True
    e, log = _logged(lambda: s.solve(fock, V, T2))
    it32 = int(re.search(r"f32 phase e=.* iters=(\d+)", log).group(1))
    return np.sort(np.real(e)), it32, s.n_iterations


def _port_mixed_eom(monkeypatch, fock, V, T2, no):
    """The port's EOM with precision="mixed": roots, f32-phase and polish
    iterations, and the dtypes K6 (its twin here) saw."""
    k6 = _spy(monkeypatch, davidson, "davidson_residual")
    s = teom.EOM_CCSD(no, device="cpu", n_excit=2)
    assert s.precision == "f64"       # the port's default
    s.precision = "mixed"
    s.max_iter = 1000
    e = _logged(lambda: s.solve(fock, V, T2))[0]
    nv = T2.shape[0]
    assert all(bool(torch.isfinite(u).all()) and u.dtype == torch.float64
               for u in s.u_singles + s.u_doubles)
    assert s.u_singles[0].shape == (nv, no)
    return np.sort(e), s.n_iterations_f32, s.n_iterations, {c[0] for c in k6}


def test_eom_mixed_ueg_matches_jax_default(ueg19, monkeypatch):
    """UEG nP=19 no-ovvv operator on the CCD amplitudes: the port's mixed
    pipeline (its f32 phase through the f32 twins, K6's included) gives
    the JAX package's default roots, in the same phases' iterations, and
    the f64 roots to 1e-8."""
    fock, V, T2 = ueg19["fock"], ueg19["mf"], ueg19["T2"]
    e_j, it32_j, it_j = _jax_mixed_eom(fock, V, T2, NO)
    e_t, it32_t, it_t, k6 = _port_mixed_eom(
        monkeypatch, torch.as_tensor(fock), ueg19["Vt"], torch.as_tensor(T2),
        NO)
    assert k6 == {torch.float32, torch.float64}
    assert np.abs(e_t - e_j).max() <= 1e-8
    assert abs(it32_t - it32_j) <= 2 and abs(it_t - it_j) <= 2
    s = teom.EOM_CCSD(NO, device="cpu", n_excit=2)
    e64 = np.sort(_logged(lambda: s.solve(
        torch.as_tensor(fock), ueg19["Vt"], torch.as_tensor(T2)))[0])
    assert np.abs(e_t - e64).max() <= 1e-8
    assert it32_t > 1 and it_t < s.n_iterations


def test_eom_mixed_lih_matches_jax_default(lih, monkeypatch):
    """Dressed LiH/3-21G (dense operator): the port's mixed roots within
    1e-8 of the JAX package's default and 1e-7 of the oracle."""
    no = lih["no"]
    e_j, it32_j, it_j = _jax_mixed_eom(lih["fd"], lih["Vd"], lih["t2"], no)
    Vt = interop.eom_operator_from_numpy(lih["Vd"], "cpu")
    e_t, it32_t, it_t, k6 = _port_mixed_eom(
        monkeypatch, torch.as_tensor(lih["fd"]), Vt,
        torch.as_tensor(lih["t2"]), no)
    assert k6 == {torch.float32, torch.float64}
    assert np.abs(e_t - e_j).max() <= 1e-8
    assert np.abs(e_t - np.asarray(LIH_ROOTS)).max() <= 1e-7
    assert abs(it32_t - it32_j) <= 2 and abs(it_t - it_j) <= 2


def test_seed_polish_matches_jax_per_iteration(ueg19):
    """``_solve_fixed(_seed=...)`` alone, from one f64 seed (the Ritz
    vectors of an f64 Davidson stopped at 1e-4, where the f32 phase
    stops), MOM tracking from the seed's QR: the same selected Ritz values
    as the JAX package's at every iteration (1e-10), in the same count."""
    fock, T2 = ueg19["fock"], ueg19["T2"]
    tf, tT = torch.as_tensor(fock), torch.as_tensor(T2).contiguous()
    pre = teom.EOM_CCSD(NO, device="cpu", n_excit=2)
    pre.e_epsilon = 1e-4
    _logged(lambda: pre.solve(tf, ueg19["Vt"], tT))
    seed = np.stack([np.concatenate([s.numpy().ravel(), d.numpy().ravel()])
                     for s, d in zip(pre.u_singles, pre.u_doubles)])
    ts = teom.EOM_CCSD(NO, device="cpu", n_excit=2)
    js = jeom.EOM_CCSD(NO, n_excit=2)
    js.max_dim = 16
    js.root_tracking = "guess"
    ritz = {"jax": [], "torch": []}
    for name, s in (("jax", js), ("torch", ts)):
        real = type(s)._realify_ritz
        s._realify_ritz = (lambda ev, vec, order, name=name, real=real:
                           ritz[name].append(ev[order])
                           or real(ev, vec, order))
    _logged(lambda: js._solve_fixed(fock, ueg19["mf"], T2, _seed=seed))
    _logged(lambda: ts._solve_fixed(tf, ueg19["Vt"], tT, _seed=seed))
    assert ts.n_iterations == js.n_iterations == len(ritz["torch"]) > 1
    for rj, rt in zip(ritz["jax"], ritz["torch"]):
        assert np.abs(np.asarray(rj) - rt).max() <= 1e-10


def test_orth_append_f32_matches_jax_and_drops_f32_noise():
    """The f32 ``_orth_append`` against the JAX function on f32 rows: the
    same rows and norms to f32 rounding, and a candidate whose remainder
    is 1e-6 (dead below the f32 threshold 3e-6, alive in f64) zeroed by
    both."""
    rng = np.random.default_rng(12)
    N, k = 400, 3
    Q = np.linalg.qr(rng.standard_normal((N, 5)))[0].T
    U = np.zeros((8, N))
    U[:5] = Q
    R = rng.standard_normal((k, N))
    off = rng.standard_normal(N)
    off -= Q.T @ (Q @ off)
    R[1] = Q[2] + 1e-6 * off / np.linalg.norm(off)
    U32, R32 = U.astype(np.float32), R.astype(np.float32)
    Rj, nj = (np.asarray(x) for x in jeom._orth_append(jnp.asarray(U32),
                                                       jnp.asarray(R32)))
    Rt, nt = teom._orth_append(torch.as_tensor(U32), torch.as_tensor(R32))
    assert Rt.dtype == torch.float32 and Rj.dtype == np.float32
    Rt, nt = Rt.numpy(), nt.numpy()
    assert nt[1] == nj[1] == 0.0 and not Rt[1].any()
    assert np.abs(Rt - Rj).max() <= F32_REL
    assert np.abs(nt - nj).max() <= F32_REL
    assert np.abs(Rt[[0, 2]] @ Rt[[0, 2]].T - np.eye(2)).max() <= 1e-6
    n64 = teom._orth_append(torch.as_tensor(U), torch.as_tensor(R))[1]
    assert abs(float(n64[1]) - 1.0) <= 1e-9   # f64: normalised, alive


# ---- CCD / CCSD mixed_precision --------------------------------------------

def _ccd_inputs(name, lih, ueg19):
    """(JAX fock, JAX V or blocks, port fock, port V or dict, solve
    options) of LiH/3-21G (dense) or UEG nP=19 (virtual ladder plan)."""
    if name == "lih":
        fock, V = lih["fock"], lih["V"]
        return fock, V, torch.as_tensor(fock), torch.as_tensor(V), {}, {}
    d = ueg19["dense"]
    jb = jccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                        iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                        ladder=jladder.build_block_ladder(ueg19["u"],
                                                          preslice=None))
    tb = {k: torch.as_tensor(d[k])
          for k in ("klij", "ijab", "abij", "iajb", "iabj")}
    tb["ladder"] = tladder.build_block_ladder(ueg19["tu"], device="cpu")
    kw = dict(level_shift=-1.0, max_iter=60)
    return (ueg19["fock"], jb, torch.as_tensor(ueg19["fock"]), tb,
            dict(kw, contract_mode="xla"), kw)


@pytest.mark.parametrize("name", ["lih", "ueg_mf"])
def test_ccd_mixed_matches_jax(name, lih, ueg19, monkeypatch):
    """CCD ``mixed_precision=True`` on LiH (dense) and the cutoff-2
    matrix-free UEG: within 1e-9 of the JAX package's mixed energy and
    1e-8 of its f64 one, the f32 pass in the JAX package's iterations ±1,
    each of them one f32 K2 (twin) call."""
    no = lih["no"] if name == "lih" else NO
    jf, jV, tf, tV, jkw, tkw = _ccd_inputs(name, lih, ueg19)
    rj, log = _logged(lambda: jccd.CCD(no).solve(jf, jV,
                                                 mixed_precision=True, **jkw))
    e64 = _logged(lambda: jccd.CCD(no).solve(jf, jV, **jkw))[0]["ccd e"]
    k2 = _spy(monkeypatch, ccd_tail, "jacobi_diis_insert")
    s = tccd.CCD(no, device="cpu")
    rt, tlog = _logged(lambda: s.solve(tf, tV, mixed_precision=True, **tkw))
    it32 = _f32_iterations(tlog)
    assert it32 == s.n_iterations_f32 > 1
    assert abs(it32 - _f32_iterations(log)) <= 1
    assert [c[0] for c in k2] == ([torch.float32] * it32
                                  + [torch.float64]
                                  * len(rt["e history"]))
    assert abs(rt["ccd e"] - rj["ccd e"]) <= 1e-9
    assert abs(rt["ccd e"] - e64) <= 1e-8


def test_ccsd_mixed_lih_matches_jax(lih, monkeypatch):
    """CCSD ``mixed_precision=True`` on LiH/3-21G: within 1e-9 of the JAX
    package's mixed energy and 1e-8 of its f64 one, f32 iterations ±1,
    the f32 pass through the f32 K2′/K3′ twins."""
    no, fock, V = lih["no"], lih["fock"], lih["V"]
    rj, log = _logged(lambda: jccsd.CCSD(no).solve(fock, V,
                                                   mixed_precision=True))
    e64 = _logged(lambda: jccsd.CCSD(no).solve(fock, V))[0]["ccsd e"]
    k3 = _spy(monkeypatch, ccsd_tail, "diis_mix_energy")
    s = tccsd.CCSD(no, device="cpu")
    rt, tlog = _logged(lambda: s.solve(torch.as_tensor(fock),
                                       torch.as_tensor(V),
                                       mixed_precision=True))
    it32 = s.n_iterations_f32
    assert abs(it32 - _f32_iterations(log)) <= 1
    assert [c[0] for c in k3] == ([torch.float32] * it32
                                  + [torch.float64] * len(rt["e history"]))
    assert abs(rt["ccsd e"] - rj["ccsd e"]) <= 1e-9
    assert abs(rt["ccsd e"] - e64) <= 1e-8


@pytest.fixture(scope="module")
def mf_ccsd(ueg19):
    """The matrix-free CCSD system of ``tests/test_r4_numerics.py:74-103``
    (UEG nP=19, the HF Fock plus symmetrised noise rng(5)·0.02, so T1 ≠ 0)
    for both packages: Fock, V dict with the OVVV plans, all-bra plan."""
    fock = ueg19["fock"]
    noise = np.random.default_rng(5).standard_normal(fock.shape) * 0.02
    fock = fock + noise + noise.T
    d = {k: v for k, v in ueg19["dense"].items() if k not in MF_DROP}
    jd = dict(d, _ovvv_plans=jladder.build_ovvv_plans(ueg19["u"]))
    td = {k: torch.as_tensor(v) for k, v in d.items()}
    td["_ovvv_plans"] = tladder.build_ovvv_plans(ueg19["tu"], device="cpu")
    return dict(fock=fock, jd=jd, jl=jladder.build_block_ladder(
        ueg19["u"], bra="all"), td=td,
        tl=tladder.build_block_ladder(ueg19["tu"], device="cpu", bra="all"),
        kw=dict(delta_e=1e-10, max_iter=200))


def test_ccsd_mixed_matrix_free_matches_jax_f64(mf_ccsd, monkeypatch):
    """CCSD ``mixed_precision=True`` on the matrix-free non-canonical UEG:
    within 1e-8 of the JAX package's f64 energy, the f32 pass through the
    f32 K1/K4 (and the fused trace) twins.  The JAX package's own mixed run
    fails on this input: ``pymes_tpu/solver/ccsd.py:805`` casts every dict
    value, and the OVVV plans are a dict (AttributeError), so the port
    casts the f64 leaves only and is held to the f64 run."""
    x = mf_ccsd
    e64 = _logged(lambda: jccsd.CCSD(NO).solve(
        x["fock"], dict(x["jd"]), ladder=x["jl"], **x["kw"]))[0]["ccsd e"]
    with pytest.raises(AttributeError):
        _logged(lambda: jccsd.CCSD(NO).solve(
            x["fock"], dict(x["jd"]), ladder=x["jl"], mixed_precision=True,
            **x["kw"]))
    diag = _spy(monkeypatch, ovvv_gather, "ovvv_gather_diag")
    s = tccsd.CCSD(NO, device="cpu")
    rt = _logged(lambda: s.solve(torch.as_tensor(x["fock"]), dict(x["td"]),
                                 ladder=x["tl"], mixed_precision=True,
                                 **x["kw"]))[0]
    n32 = 2 * s.n_iterations_f32
    assert [c[-1] for c in diag] == ([torch.float32] * n32
                                     + [torch.float64]
                                     * (2 * len(rt["e history"])))
    assert float(rt["t1"].abs().max()) > 1e-3
    assert abs(rt["ccsd e"] - e64) <= 1e-8


def test_ccsd_dress_precision_takes_f64_only(mf_ccsd):
    """``dress_precision`` None and "f64" are the f64 dressing: on the
    matrix-free non-canonical UEG the energy of each within 1e-10 of the
    JAX package's ``dress_precision="f64"`` run.  "f32" raises: the JAX
    package's f32 dressing carriers serve its Ozaki contraction modes,
    which alone choose them, and the port leaves both out."""
    x = mf_ccsd
    ej = _logged(lambda: jccsd.CCSD(NO).solve(
        x["fock"], dict(x["jd"]), ladder=x["jl"], dress_precision="f64",
        **x["kw"]))[0]["ccsd e"]
    for prec in (None, "f64"):
        e = _logged(lambda: tccsd.CCSD(NO, device="cpu").solve(
            torch.as_tensor(x["fock"]), dict(x["td"]), ladder=x["tl"],
            dress_precision=prec, **x["kw"]))[0]["ccsd e"]
        assert abs(e - ej) <= 1e-10
    for prec in ("f32", "bf16"):
        with pytest.raises(ValueError):
            tccsd.CCSD(NO, device="cpu").solve(torch.as_tensor(x["fock"]),
                                               dict(x["td"]), ladder=x["tl"],
                                               dress_precision=prec)


def test_diis_f32_rings_match_jax():
    """The DIIS of the f32 ground-state bulk: every ring, the Gram matrix
    and the mixed vector in f32 (``init_state(..., float32)``); over 7
    insertions into a ring of 4 (wrapping once) the coefficients within
    1e-6 of the JAX package's f32 ``diis.mix`` (each amplitude is one-hot
    on its slot in the first m entries, so the mixed vector's first m
    entries are the coefficients)."""
    rng = np.random.default_rng(17)
    m, n = 4, 300
    sj = jdiis.init_state(m, n, jnp.float32)
    st = tdiis.init_state(m, n, torch.float32, device="cpu")
    for t in range(7):
        err = rng.standard_normal(n).astype(np.float32) * 0.5 ** t
        amp = rng.standard_normal(n).astype(np.float32)
        amp[:m] = 0.0
        amp[t % m] = 1.0
        sj, mj = jdiis.mix(sj, jnp.asarray(err), jnp.asarray(amp))
        st, mt = tdiis.mix(st, torch.as_tensor(err), torch.as_tensor(amp))
        assert mt.dtype == torch.float32 and st.B.dtype == torch.float32
        assert np.abs(mt.numpy()[:m] - np.asarray(mj)[:m]).max() <= 1e-6
        assert np.abs(mt.numpy() - np.asarray(mj)).max() <= 1e-5


# ---- the f32 twins ---------------------------------------------------------

def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _pair(x):
    """An f32 tensor and the same values in f64."""
    x32 = torch.as_tensor(x, dtype=torch.float32)
    return x32, x32.double()


def test_f32_tail_twins_match_f64():
    """K2/K3 and K2′/K3′ in f32 against f64 on the same
    f32-representable values: rings, Gram rows, mixed amplitudes and
    energies within 1e-5 relative."""
    rng = np.random.default_rng(23)
    no, nv, m = 3, 8, 5
    eps = np.sort(rng.standard_normal(no + nv))
    ei, ea = _pair(eps[:no]), _pair(eps[no:])
    shape2 = (no, no, nv, nv)
    R, T, V, Vx = (_pair(rng.standard_normal(shape2) * 0.1)
                   for _ in range(4))
    R1, T1, F1 = (_pair(rng.standard_normal((nv, no)) * 0.1)
                  for _ in range(3))
    coeff = _pair(rng.standard_normal(m))
    for tail, n, args in (
            (ccd_tail, no * no * nv * nv, lambda i: (R[i], T[i])),
            (ccsd_tail, nv * no + no * no * nv * nv,
             lambda i: (R1[i], T1[i], R[i], T[i]))):
        rings = _pair(rng.standard_normal((2, m, n)) * 0.1)
        errs = [r[0].clone() for r in rings]
        amps = [r[1].clone() for r in rings]
        rows = [tail.jacobi_diis_insert(*args(i), ei[i], ea[i], -1.0,
                                        errs[i], amps[i], 2, 4)
                for i in (0, 1)]
        assert rows[0].dtype == torch.float32
        for got, want in ((rows[0], rows[1]), (errs[0], errs[1]),
                          (amps[0], amps[1])):
            assert _rel(got, want) <= F32_REL
        if tail is ccd_tail:
            outs = [ccd_tail.diis_mix_energy(amps[i], coeff[i], 4,
                                             T[i].clone(), V[i], Vx[i])
                    for i in (0, 1)]
        else:
            outs = [ccsd_tail.diis_mix_energy(amps[i], coeff[i], 4,
                                              T1[i].clone(), T[i].clone(),
                                              F1[i], V[i], Vx[i])
                    for i in (0, 1)]
        for got, want in zip(*outs):
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= F32_REL * abs(float(want))


def test_f32_trace_and_davidson_twins_match_f64(ueg19):
    """K4's fused G_vv trace on the f32 OVVV plans (nP=19) and K6 on f32
    Davidson buffers against f64 on the same values, within 1e-5
    relative."""
    rng = np.random.default_rng(29)
    nv = ueg19["nv"]
    plans = tladder.build_ovvv_plans(ueg19["tu"], device="cpu")
    T1 = _pair(rng.standard_normal((nv, NO)) * 0.05)
    for pat, axis in (("vov", 1), ("ovv", 0)):
        p = plans[pat]
        W = _pair(p.W.float())
        got, want = (ovvv_gather.ovvv_gather_diag(p.S, W[i], T1[i], axis)
                     for i in (0, 1))
        assert got.dtype == torch.float32 and float(want.abs().max()) > 0
        assert _rel(got, want) <= F32_REL
    max_dim, k, N, m = 16, 2, 5000, 11
    U, W = (_pair(rng.standard_normal((max_dim, N))) for _ in range(2))
    v = _pair(rng.standard_normal((max_dim, k)))
    e, diag = _pair(np.array([0.5, 0.7])), _pair(rng.standard_normal(N))
    got, want = (davidson.davidson_residual(U[i], W[i], v[i], e[i], diag[i],
                                            m) for i in (0, 1))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= F32_REL


@pytest.mark.parametrize("solver", ["ccd", "ccsd"])
def test_mixed_precision_on_cut_blocks_matches_whole(lih, solver):
    """``mixed_precision=True`` on LiH/3-21G blocks cut over a mesh of
    three (repeated) CPU devices (``mesh.shard_blocks``: the f32 copy casts
    the cut blocks piece by piece, and the f32 pass runs tensor-parallel):
    the f32 iterations and the energy of the whole blocks' mixed solve
    (1e-10)."""
    from pymes_tpu_torch.integral.partition import part_2_body_int
    from pymes_tpu_torch.parallel import mesh as tmesh

    no = lih["no"]
    fock = torch.as_tensor(lih["fock"])
    d = part_2_body_int(no, torch.as_tensor(lih["V"]))
    cut = tmesh.shard_blocks(tmesh.make_mesh(3, device="cpu",
                                             devices=["cpu"] * 3),
                             d)
    cls, key = ((tccd.CCD, "ccd e") if solver == "ccd"
                else (tccsd.CCSD, "ccsd e"))
    out = []
    for V in (d, cut):
        s = cls(no, device="cpu")
        e = _logged(lambda: s.solve(fock, V, mixed_precision=True))[0][key]
        out.append((e, s.n_iterations_f32))
    assert out[1][1] == out[0][1] > 1
    assert abs(out[1][0] - out[0][0]) <= 1e-10


@pytest.mark.parametrize("abcd", ["cut", "whole", "shards"])
def test_ccd_mixed_precision_with_ring_mesh(lih, abcd):
    """CCD ``mixed_precision=True`` with ``ring_mesh`` on LiH/3-21G over
    three (repeated) CPU devices.  The f32 pass runs without the ring (as
    the JAX package's does), so only an ``abcd`` cut by
    ``mesh.shard_blocks`` keeps it off one device: that one runs
    tensor-parallel in f32 and with the ring in f64, within 1e-10 of the
    whole blocks' mixed solve with the same f32 iterations; a whole
    ``abcd`` or a list of its shards raises."""
    from pymes_tpu_torch.integral.partition import part_2_body_int
    from pymes_tpu_torch.parallel import mesh as tmesh

    no = lih["no"]
    fock = torch.as_tensor(lih["fock"])
    d = part_2_body_int(no, torch.as_tensor(lih["V"]))
    m = tmesh.make_mesh(3, device="cpu", devices=["cpu"] * 3)
    cut = tmesh.shard_blocks(m, d)
    V = {"cut": cut, "whole": d,
         "shards": {**d, "abcd": list(cut["abcd"].shards)}}[abcd]
    s = tccd.CCD(no, device="cpu")
    if abcd != "cut":
        with pytest.raises(ValueError):
            s.solve(fock, V, ring_mesh=m, mixed_precision=True)
        return
    e = _logged(lambda: s.solve(fock, V, ring_mesh=m,
                                mixed_precision=True))[0]["ccd e"]
    whole = tccd.CCD(no, device="cpu")
    e0 = _logged(lambda: whole.solve(fock, d,
                                     mixed_precision=True))[0]["ccd e"]
    assert s.n_iterations_f32 == whole.n_iterations_f32 > 1
    assert abs(e - e0) <= 1e-10
