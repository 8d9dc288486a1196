"""The port's FEAST/RT mixed-precision engine (``ls_precision="mixed"``: f32
Krylov inside f64 iterative refinement, ``pymes_tpu_torch/solver/
feast_eom_ccsd.py``) and the f32 twins of K1, K4, K5, K7 and K8, against
the JAX package's mixed engine (``pymes_tpu/solver/feast_eom_ccsd.py:
585-800``) and the port's own f64 path, on the CPU (the kernels' twins;
the JAX package as its own tests run it, CPU and x64, its f32 parts under
``jax.default_matmul_precision("float32")``).  Inputs come from numpy
seeds.  Tolerances:

* the f32 sigma on the UEG nP=19 no-ovvv operator: within 1e-5 relative
  (max-abs norm) of the JAX package's sigma on ``_cast_f32`` of the same
  operator and of the port's f64 sigma (f32 rounding, ~6e-8 an operation,
  over sums of a few hundred terms);
* each f32 twin within 1e-5 relative of its f64 twin on f32-representable
  inputs (the same bound);
* the refined shifted solves (nP=19, FEAST and RT operators, one trial a
  node, so that the two packages' Krylov spaces coincide) at
  ``ls_conv_tol`` 1e-10: honest residuals ≤ 1e-10 in both, x within 1e-8
  relative, refinement passes equal or within one (the inner solves stop
  on f32 residuals that the two packages round differently: the JAX one
  rotates in f32, the port in host f64);
* H₂ FEAST (the settings of ``tests/test_r4_numerics.py:123-133``): the
  mixed root within 1e-8 of the JAX package's mixed root and of the port's
  f64 root, within 1e-6 of Davidson; H₂ RT, three mixed steps within 1e-8
  of the JAX package's default (mixed) RT;
* a ``node_mesh`` takes the f64 path: bit for bit the f64 node-mesh run.
"""

import os
import warnings

import jax
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
from pymes_tpu.solver import feast_eom_ccsd as jfeast
from pymes_tpu.solver import rt_eom_ccsd as jrt
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu_torch import interop, kernels
from pymes_tpu_torch.kernels import arnoldi, ovvv_gather
from pymes_tpu_torch.kernels import pair_sym, shifted
from pymes_tpu_torch.ops import gmres as tgmres
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.parallel import mesh as tmesh
from pymes_tpu_torch.solver import eom_ccsd as teom
from pymes_tpu_torch.solver import feast_eom_ccsd as tfeast
from pymes_tpu_torch.solver import rt_eom_ccsd as trt

DATA = os.path.join(os.path.dirname(__file__), "data")
NO = 7
MF_DROP = ("abcd", "iabc", "abic", "aibc", "abci")
F32_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These solves run many small tensor operations, which more threads
    only slow down where several test processes share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ueg19():
    """UEG 14e, rs=1.0, cutoff 2 (nP=19): seeded T2 and the no-ovvv
    operator (all-bra plan + OVVV plans) of the JAX package, as numpy,
    its H̄ intermediates and diagonal, and the port's operator."""
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
    fj, Tj = jnp.asarray(fock), jnp.asarray(T2)
    hbar = jeom.build_hbar(fj, mf, Tj, contract_mode="xla")
    diag = jnp.asarray(np.concatenate([
        np.ravel(jeom.get_diag_singles(fj, mf, Tj)),
        np.ravel(jeom.get_diag_doubles(fj, mf, Tj))]))
    return dict(fock=fock, T2=T2, mf=mf, nv=nv, hbar=hbar, diag=diag,
                Vt=interop.eom_operator_from_numpy(mf, "cpu"),
                N=nv * NO + nv * nv * NO * NO)


# ---- the f32 sigma ---------------------------------------------------------

def test_f32_sigma_matches_jax_cast_f32_and_f64(ueg19):
    """The port's ``_sigma_batched_hbar`` on its f32 operator (K1, K4, K5
    twins in f32) against the JAX package's on ``_cast_f32`` of the same
    operator, and against the port's f64 sigma, on 3 seeded trials."""
    nv, T2 = ueg19["nv"], ueg19["T2"]
    rng = np.random.default_rng(21)
    U1 = rng.standard_normal((3, nv, NO)).astype(np.float32)
    U2 = (rng.standard_normal((3, nv, nv, NO, NO)) * 0.1).astype(np.float32)

    f3, V3, T3, h3 = jfeast._cast_f32((jnp.asarray(ueg19["fock"]),
                                       ueg19["mf"], jnp.asarray(T2),
                                       ueg19["hbar"]))
    # (only values are compared: under x64 an f64 constant inside the JAX
    # sigma promotes its output to f64)
    with jax.default_matmul_precision("float32"):
        wj = jeom._sigma_batched_hbar(f3, V3, h3, jnp.asarray(U1),
                                      jnp.asarray(U2), T3)

    s = tfeast.FEAST_EOM_CCSD(NO, device="cpu")
    op = s._operator(ueg19["fock"], ueg19["Vt"], T2)
    op32 = s._operator32(op)
    assert op32[0].dtype == op32[2].dtype == op32[3].dtype == torch.float32
    lad = op32[1]["abcd_ladder"]
    assert lad.packed.blocks.dtype == torch.float32
    assert all(g.blocks.dtype == torch.float32 for g in lad.groups)
    assert lad.packed.perm.dtype == torch.int32          # indices stay
    assert op32[1]["_ovvv_plans"]["vov"].W.dtype == torch.float32
    assert s._hbar32.A1.dtype == torch.float32
    u1, u2 = torch.as_tensor(U1), torch.as_tensor(U2)
    w32 = teom._sigma_batched_hbar(op32[0], op32[1], s._hbar32, u1, u2,
                                   op32[2])
    w64 = teom._sigma_batched_hbar(op[0], op[1], s._hbar_of(*op[:3]),
                                   u1.double(), u2.double(), op[2])
    for a, b, c in zip(w32, wj, w64):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), b) <= F32_REL
        assert _rel(a.double().numpy(), c.numpy()) <= F32_REL


# ---- the f32 twins -----------------------------------------------------------

def _twin_pair(fn, *args32):
    """``fn`` on f32 inputs and on the same values in f64."""
    def up(x):
        return x.double() if (isinstance(x, torch.Tensor)
                              and x.dtype == torch.float32) else x
    return fn(*args32), fn(*map(up, args32))


def test_k1_f32_twin_matches_f64(ueg19):
    plan32 = ueg_ladder.cast_plan(ueg19["Vt"]["abcd_ladder"], torch.float32)
    plan64 = ueg_ladder.cast_plan(plan32, torch.float64)  # same values
    rng = np.random.default_rng(22)
    nv = ueg19["nv"]
    T = torch.as_tensor(rng.standard_normal((2, nv, nv, NO, NO)),
                        dtype=torch.float32)
    got = ueg_ladder.ladder_apply(plan32, T)
    want = ueg_ladder.ladder_apply(plan64, T.double())
    assert got.dtype == torch.float32
    assert _rel(got.double(), want) <= F32_REL


def test_k4_f32_twin_matches_f64(ueg19):
    plans = ueg19["Vt"]["_ovvv_plans"]
    rng = np.random.default_rng(23)
    T1 = torch.as_tensor(rng.standard_normal((4, ueg19["nv"], NO)),
                         dtype=torch.float32)
    for pl in plans.values():
        p32 = pl._replace(W=pl.W.float())
        got, want = _twin_pair(ovvv_gather.ovvv_gather, p32.S, p32.W, T1)
        assert got.dtype == torch.float32
        assert _rel(got.double(), want) <= F32_REL


def test_k5_f32_twin_matches_f64():
    rng = np.random.default_rng(24)
    X = torch.as_tensor(rng.standard_normal((2, 12, 12, NO, NO)),
                        dtype=torch.float32)
    Y = torch.as_tensor(rng.standard_normal(X.shape), dtype=torch.float32)
    for y in (None, Y):
        got, want = _twin_pair(pair_sym.pair_symmetrize, X, y)
        assert got.dtype == torch.float32
        assert _rel(got.double(), want) <= F32_REL


def test_k7_f32_twin_matches_f64():
    """The CGS2 projection (Hessenberg column in f64 for either type, the
    new row in the basis type) and the fused combine."""
    rng = np.random.default_rng(25)
    L, R1, n = 3, 9, 500
    V = torch.as_tensor(np.linalg.qr(rng.standard_normal((L, n, R1)))[0]
                        .transpose(0, 2, 1).copy(), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    lanes = torch.as_tensor([2, 0])
    m = torch.as_tensor([4, 8])
    V32, V64 = V.clone(), V.double()
    h32 = arnoldi.arnoldi_cgs2(V32, w.clone(), lanes, m)
    h64 = arnoldi.arnoldi_cgs2(V64, w.double(), lanes, m)
    assert h32.dtype == h64.dtype == torch.float64
    assert V32.dtype == torch.float32
    assert _rel(h32, h64) <= F32_REL
    assert _rel(V32[lanes, m].double(), V64[lanes, m]) <= F32_REL
    C = torch.as_tensor(rng.standard_normal((2, 2, R1)))
    x0 = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    got = arnoldi.krylov_combine_xr(V, C, m, lanes, x0=x0)
    want = arnoldi.krylov_combine_xr(V.double(), C, m, lanes,
                                     x0=x0.double())
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a.double(), b) <= F32_REL


@pytest.mark.parametrize("mode,rt", [("apply", False), ("apply", True),
                                     ("residual", False), ("residual", True),
                                     ("precond", False), ("precond", True)])
def test_k8_f32_twin_matches_f64(mode, rt):
    rng = np.random.default_rng(26 + len(mode) + rt)
    La, n1, n2 = 3, 84, 7056
    N = n1 + n2

    def r(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale + shift,
                               dtype=torch.float32)

    args = (r(2 * La, n1), r(2 * La, n2), r(La, 2 * N),
            r(La, scale=0.1, shift=0.5), r(La, scale=0.1, shift=0.3),
            r(N, shift=1.0))
    B = r(La, 2 * N) if mode == "residual" else None

    def k8(H1, H2, X, zr, zi, diag, B):
        return shifted.shifted_precond(H1, H2, X, zr, zi, diag, dt=0.1,
                                       rt=rt, mode=mode, B=B)

    got, want = _twin_pair(k8, *args, B)
    if mode != "residual":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a.double(), b) <= F32_REL


def test_no_twin_launch_is_counted():
    """On the CPU every f32 path runs its twin: no kernel launch counts."""
    kernels.reset_launches()
    test_k5_f32_twin_matches_f64()
    test_k7_f32_twin_matches_f64()
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_f32_breakdown_guard():
    """A new Krylov direction of norm 1e-20 is zeroed in f32 (the JAX f32
    ``_BREAK`` 1e-18) and kept in f64 (1e-140), by K7's twin and by the
    GMRES start vector; the guards follow the type as the JAX GMRES's
    do."""
    n = 64
    V = torch.zeros((1, 3, n), dtype=torch.float32)
    V[0, 0, 0] = 1.0
    w = torch.zeros((1, n), dtype=torch.float32)
    w[0, 5] = 1e-20
    lanes, m = torch.as_tensor([0]), torch.as_tensor([1])
    for dtype, zeroed in ((torch.float32, True), (torch.float64, False)):
        Vd = V.to(dtype)
        h = arnoldi.arnoldi_cgs2(Vd, w.to(dtype), lanes, m)
        assert float(h[0, 1]) == pytest.approx(1e-20, rel=1e-6)
        assert bool((Vd[0, 1] == 0).all()) == zeroed
        if not zeroed:
            assert float(Vd[0, 1, 5]) == pytest.approx(1.0)
        unit = tgmres._safe_unit(w.to(dtype), tgmres._norms(w.to(dtype)),
                                 tgmres.guards(dtype)[0])
        assert bool((unit == 0).all()) == zeroed
    assert tgmres.guards(torch.float32) == (1e-18, 1e-30)
    assert tgmres.guards(torch.float64) == (1e-140, 1e-300)


# ---- the refinement against the JAX package --------------------------------

def _refine_both(ueg19, z, rt, dt, phases):
    """JAX ``_solve_chunk_mixed`` and the port's mixed chunk on the nodes
    ``z`` with right-hand sides ``phases[e]·b`` (one trial a node):
    (x, rel, passes) of each."""
    N, nv = ueg19["N"], ueg19["nv"]
    b = np.random.default_rng(4).standard_normal(N)
    b /= np.linalg.norm(b)
    rhs = phases[:, None] * b[None]
    kw = dict(ls_conv_tol=1e-10)
    settings = dict(ls_restart=30, ls_max_iter=20, ls_refine_max=8)

    js = jfeast.FEAST_EOM_CCSD(NO, **kw)
    for k, v in settings.items():
        setattr(js, k, v)
    fj, Tj, Vj = jnp.asarray(ueg19["fock"]), jnp.asarray(ueg19["T2"]), \
        ueg19["mf"]
    js._reset_op_cache(fj, Vj, Tj)
    hbar = js._get_hbar(fj, Vj, Tj)
    calls = []
    scan = jfeast._shifted_solve_nodes_scan

    def counted(*a, **k):
        calls.append(1)
        return scan(*a, **k)

    jfeast._shifted_solve_nodes_scan = counted
    try:
        xj, relj = js._solve_chunk_mixed(
            fj, Vj, Tj, hbar, (jnp.asarray(rhs.real), jnp.asarray(rhs.imag)),
            (jnp.asarray(z.real), jnp.asarray(z.imag)), ueg19["diag"], nv,
            is_rt=rt, dt=dt, backend="inhouse", damping=1.0,
            sigma_sliced=None)
    finally:
        jfeast._shifted_solve_nodes_scan = scan

    s = tfeast.FEAST_EOM_CCSD(NO, device="cpu", ls_precision="mixed", **kw)
    for k, v in settings.items():
        setattr(s, k, v)
    op = s._operator(ueg19["fock"], ueg19["Vt"], ueg19["T2"])
    s._new_stats()
    B = torch.as_tensor(np.concatenate([rhs.real, rhs.imag], axis=1))
    X, relt = s._solve_chunks(op, B, torch.as_tensor(z.real),
                              torch.as_tensor(z.imag), rt, dt, 1e12)
    xt = X[:, :N].numpy() + 1j * X[:, N:].numpy()
    assert s.ls_stats["chunks"] == 1
    return ((np.asarray(xj), np.asarray(relj), len(calls)),
            (xt, relt, s.ls_stats["passes"][0]))


@pytest.mark.parametrize("rt", [False, True])
def test_ueg19_refinement_matches_jax_solve_chunk_mixed(ueg19, rt):
    """Three nodes off the real axis, one trial each: both packages refine
    every honest residual to ≤ 1e-10, x agrees within 1e-8 relative, and
    the refinement passes are equal or within one (equal, 3 and 3, for
    both operators on a CPU: after two passes the residual sits near
    1e-10, so a rounding difference may add a pass to one package)."""
    if rt:
        dt = 0.1
        z = np.array([0.05 + 0.1j, 0.02 + 0.15j, -0.03 + 0.12j])
        phases = np.exp(z)
    else:
        dt = 0.0
        z = np.array([0.3 + 0.4j, 0.5 + 0.3j, 0.1 + 0.5j])
        phases = np.ones(3)
    (xj, relj, pj), (xt, relt, pt) = _refine_both(ueg19, z, rt, dt, phases)
    assert np.max(relj) <= 1e-10 and np.max(relt) <= 1e-10
    assert _rel(xt, xj) <= 1e-8
    assert pt >= 2 and abs(pt - pj) <= 1, (pt, pj)


# ---- H₂: FEAST window and RT steps -----------------------------------------

def _h2_dressed():
    """H₂/STO-6G through the JAX package: CCSD, the T1-dressed Fock and V,
    T2, and the Davidson root and vector (numpy)."""
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
    e_dav = float(np.real(dav.solve(fd, Vd, t2)[0]))
    u = (np.asarray(dav.u_singles[0]).astype(complex),
         np.asarray(dav.u_doubles[0]).astype(complex))
    return no, fd, Vd, t2, e_dav, u


def _window_root(ev, e_dav):
    ev = np.real(np.asarray(ev))
    return ev[np.argmin(np.abs(ev - e_dav))]


def test_h2_window_mixed_matches_jax_mixed_and_f64():
    """``tests/test_r4_numerics.py:123-133``'s window (its ls_restart 20,
    ls_conv_tol 1e-4, the JAX default mixed engine)."""
    no, fd, Vd, t2, e_dav, _ = _h2_dressed()
    kw = dict(e_c=e_dav, e_r=0.2, n_trial=2, max_iter=50, tol=1e-10, seed=1)
    js = jfeast.FEAST_EOM_CCSD(no, **kw)
    js.ls_max_iter = 50
    assert js.ls_precision == "mixed"
    root_j = _window_root(js.solve(fd, Vd, t2), e_dav)
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    roots = {}
    for prec in ("mixed", "f64"):
        s = tfeast.FEAST_EOM_CCSD(no, device="cpu", ls_precision=prec, **kw)
        s.ls_max_iter, s.ls_restart = 50, 20
        roots[prec] = _window_root(s.solve(fd, Vt, t2), e_dav)
        assert bool(s.ls_stats["passes"]) == (prec == "mixed")
    assert abs(roots["mixed"] - root_j) <= 1e-8
    assert abs(roots["mixed"] - roots["f64"]) <= 1e-8
    assert abs(roots["mixed"] - e_dav) <= 1e-6


def test_h2_rt_mixed_matches_jax_default():
    """Three RT steps from the Davidson vector, the port's mixed engine
    against the JAX package's default RT (mixed)."""
    no, fd, Vd, t2, omega, u = _h2_dressed()
    kw = dict(e_c=omega, e_r=0.5, n_quad=32, ls_conv_tol=1e-10)
    js = jrt.RT_EOM_CCSD(no, **kw)
    ts = trt.RT_EOM_CCSD(no, device="cpu", ls_precision="mixed", **kw)
    assert js.ls_precision == ts.ls_precision == "mixed"
    for s in (js, ts):
        s.ls_restart = 20
        s.ls_max_iter = 100
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    qj = qt = u
    for _ in range(3):
        qj = js.solve(fd, Vd, t2, dt=0.1, u_singles=qj[0], u_doubles=qj[1])
        qt = ts.solve(fd, Vt, t2, dt=0.1, u_singles=qt[0], u_doubles=qt[1])
        for a, b in zip(qt, qj):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
        assert ts.ls_stats["passes"] and np.max(ts.last_ls_residuals) <= 1e-10
    # the f32 operator is made once for the three steps of one operator
    assert ts._op32 is not None and ts._op32[1] is ts._operator32(ts._op)[1]


# ---- dispatch, the stall test, the settings --------------------------------

def test_node_mesh_takes_the_f64_path():
    """With a node mesh, "mixed" runs the f64 path: bit for bit the f64
    node-mesh run, and no refinement pass."""
    no, fd, Vd, t2, e_dav, _ = _h2_dressed()
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    out = {}
    for prec in ("mixed", "f64"):
        s = tfeast.FEAST_EOM_CCSD(
            no, device="cpu", e_c=e_dav, e_r=0.2, n_trial=2, max_iter=4,
            tol=-1.0,
            seed=1, ls_precision=prec,
            node_mesh=tmesh.make_mesh(2, device="cpu", devices=["cpu"] * 2))
        s.ls_max_iter = 50
        out[prec] = (np.asarray(s.solve(fd, Vt, t2)), s.ls_stats["passes"])
    assert np.array_equal(out["mixed"][0], out["f64"][0])
    assert out["mixed"][1] == out["f64"][1] == []


def test_stalled_refinement_stops_and_warns(ueg19):
    """GMRES(2) inner solves barely contract a near-axis node: refinement
    stops at the stall (the worst lane above half its last residual)
    before ``ls_refine_max``, and the unconverged solves warn."""
    s = tfeast.FEAST_EOM_CCSD(NO, device="cpu", e_c=1.4, e_r=0.3, n_trial=1,
                              n_quad=4, max_iter=1, seed=2, n_excit=1,
                              ls_conv_tol=1e-10, ls_precision="mixed")
    s.ls_restart, s.ls_max_iter, s.ls_refine_max = 2, 1, 10
    with pytest.warns(UserWarning, match="not converged"):
        s.solve(ueg19["fock"], ueg19["Vt"], ueg19["T2"])
    passes = s.ls_stats["passes"]
    assert len(passes) == 1 and 2 <= passes[0] < s.ls_refine_max
    assert np.max(s.last_ls_residuals) > 10 * s.ls_conv_tol


def test_unknown_ls_precision_raises():
    with pytest.raises(ValueError, match="ls_precision"):
        tfeast.FEAST_EOM_CCSD(1, device="cpu", ls_precision="f32")
    s = trt.RT_EOM_CCSD(1, device="cpu")
    assert s.ls_precision == "f64" and s.ls_refine_max == 4
    for bad in ("bf16", None, "MIXED"):
        with pytest.raises(ValueError, match="ls_precision"):
            s.ls_precision = bad
    s.ls_precision = "mixed"
    assert s.ls_precision == "mixed"


def test_matmul_settings_scoped_to_the_engine():
    """Inside the engine f32 GEMMs run at "highest" with TF32 off; the
    caller's settings come back afterwards."""
    no, fd, Vd, t2, e_dav, _ = _h2_dressed()
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
        caller = (torch.get_float32_matmul_precision(),
                  torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        s = tfeast.FEAST_EOM_CCSD(no, device="cpu", e_c=e_dav, e_r=0.2,
                                  n_trial=2,
                                  max_iter=2, seed=1, ls_precision="mixed")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.solve(fd, interop.eom_operator_from_numpy(Vd, "cpu"), t2)
        assert s.ls_stats["matmul"] == ("highest", False, False)
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == caller
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[2]
    assert torch.backends.cuda.matmul.allow_tf32 == saved[1]


def test_krylov_budget_counts_the_element_size():
    """A budget of one f64 lane holds two f32 lanes: the mixed engine
    chunks the H₂ lanes half as often."""
    no, fd, Vd, t2, e_dav, _ = _h2_dressed()
    Vt = interop.eom_operator_from_numpy(Vd, "cpu")
    n2 = 2 * 2                     # 2N for H₂ (N = 2)
    chunks = {}
    for prec in ("f64", "mixed"):
        s = tfeast.FEAST_EOM_CCSD(no, device="cpu", e_c=e_dav, e_r=0.2,
                                  n_trial=2,
                                  max_iter=1, seed=1, ls_precision=prec)
        s.ls_restart = 20
        s.krylov_mem_budget_bytes = 21 * n2 * 8     # one f64 lane
        s.solve(fd, Vt, t2)
        chunks[prec] = s.ls_stats["chunks"]
    assert chunks["f64"] == 2 * chunks["mixed"] == 16
