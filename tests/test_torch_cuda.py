"""The port's hand-written kernels on the card, each against its plain twin.

K1 (CUDA C++ ladder), K2/K3 (CUDA C++ CCD tail), K4 (CUDA C++ ovvv
gather and its fused trace), K2′/K3′ (the same CUDA C++ source, with T1),
K5 (CUDA C++ pair symmetrisation), K6 (Triton Davidson residual), K7
(CUDA C++ Arnoldi CGS2 and Krylov combines) and K8 (Triton shifted operator
and preconditioner), K9 (CUDA C++ ring step; with the ring over a
repeated card and over two cards, and the sector-sharded K1) and K10 (CUDA
C++ set-up scatter of the sparse integrals into the blocks) run only on an
NVIDIA card: these tests carry the ``cuda`` marker and skip where torch
sees no card.  The card has no jax, so this file imports only the port; run
it there without the
repository's conftest (which sets up jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: max|kernel − twin| ≤ 1e-12·max|twin| (both f64; only the
summation order and FMA contraction differ); K4's gather (one multiply an
element), K5 (which sums in its twin's order) and the ring rows that K2/K2′
write (one division and one add an element, in the twin's order) must equal
their twins bit for bit, and so must K10's blocks (one store a kept
entry, the twin's cast of the values), and the tails' sums repeat bit for
bit from launch to launch (the last block adds the blocks' partials in
block order).  K1,
K7 and K9 add no values by atomics (f32 K7's tickets only count the
blocks that arrived), so a second launch must repeat the first bit for
bit.  The f32 kernels of K1, K4, K5, K7 and K8 (the FEAST/RT
mixed-precision engine) and of K2/K3, K2′/K3′, K4's fused trace and K6
(the ground-state and Davidson precision modes) are held to their f32
twins within 1e-5·max|twin| (f32 rounding, ~6e-8 an operation, over the
sums of a few hundred terms; K4's gather, K5 and the tails' ring rows bit
for bit), a mixed FEAST solve on the card to the CPU's,
and LiH's CCSD ``mixed_precision`` (1e-10) and mixed EOM (1e-8) on the
card to the CPU's.
"""

import numpy as np
import pytest
import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.integral.partition import part_2_body_int
from pymes_tpu_torch.kernels import (ccd_tail, ccsd_tail, davidson, pair_sym,
                                     ring_step)
from pymes_tpu_torch.kernels import block_ladder as k1
from pymes_tpu_torch.kernels import ovvv_gather as k4
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd, ccsd, eom_ccsd, mp2

pytestmark = pytest.mark.cuda

NO = 7
REL = 1e-12
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


def _problem(cutoff, device):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device=device, names=NEED)
    eps_i = hf.calcOccupiedOrbE(u.kinetic_energies(), d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(u.kinetic_energies(), d["aibj"], d["aijb"],
                               NO, n_p - NO)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=ueg_ladder.build_block_ladder(
                               u, device=device))
    return u, blocks, eps_i, eps_a


def _randn(rng, shape, device, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           device=device)


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_block_ladder_kernel_matches_twin(device, cutoff, bra):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra=bra)
    nv = u.n_spatial - NO
    T = _randn(np.random.default_rng(cutoff), (NO, NO, nv, nv), device)
    before = kernels.LAUNCHES["block_ladder"]
    got = ueg_ladder.block_ladder_apply_ij(plan, T)
    assert kernels.LAUNCHES["block_ladder"] == before + 1
    want = ueg_ladder.block_ladder_apply_ij(plan, T, twin=True)
    assert kernels.LAUNCHES["block_ladder"] == before + 1
    assert got.shape == want.shape
    _close(got, want)


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got - want).abs().max())


def _offset(t, k):
    """``t`` copied into a contiguous view that starts ``k`` elements into
    its storage (operands off the 16-byte grid: the kernels' scalar head)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def _tail_eps(rng, no, nv, device, dtype=torch.float64):
    eps = np.sort(rng.standard_normal(no + nv))
    return (torch.as_tensor(eps[:no] - 1.0, dtype=dtype, device=device),
            torch.as_tensor(eps[no:] + 1.0, dtype=dtype, device=device))


def _jacobi_runs(call, ring, name, close):
    """K2/K2′ (``call(errs, amps, twin)``) against its twin on copies of
    ``ring``: the ring rows bit for bit, the Gram row within ``close``; a
    second launch repeats the first bit for bit (the last block sums the
    blocks' partials in block order)."""
    before = kernels.LAUNCHES[name]
    rings = [tuple(r.clone() for r in ring) for _ in range(3)]
    rows = [call(e, a, tw) for (e, a), tw in zip(rings, (False, True, False))]
    assert kernels.LAUNCHES[name] == before + 2
    close(rows[0], rows[1])
    for k in range(2):
        _same(rings[0][k], rings[1][k])
        _same(rings[2][k], rings[0][k])
    _same(rows[2], rows[0])
    return rows[0]


# (no, nv, operand offset): the nP=19 shape (nv = 12, 16-byte vectors);
# nv = 13 (odd N1 = 91 for CCSD, odd N = 8281 for CCD: scalars); operands
# one element off the 16-byte grid (a scalar head and tail)
TAIL_SHAPES = [(NO, 12, 0), (NO, 13, 0), (NO, 12, 1)]


@pytest.mark.parametrize("shape", TAIL_SHAPES)
@pytest.mark.parametrize("slot,n_valid,m", [(0, 1, 6), (3, 4, 6), (2, 6, 6),
                                            (16, 17, 17), (5, 17, 17)])
def test_jacobi_diis_kernel_matches_twin(device, slot, n_valid, m, shape):
    """K2 (the CCD pass, no T1 segment): slot 0 of a fresh ring, a
    part-filled ring, a wrapped slot, and a 17-slot ring (several Gram
    groups)."""
    no, nv, off = shape
    rng = np.random.default_rng(slot + 7 * m)
    eps_i, eps_a = _tail_eps(rng, no, nv, device)
    t2, n = (no, no, nv, nv), no * no * nv * nv
    R, T = (_offset(_randn(rng, t2, device), off) for _ in range(2))
    ring = tuple(_offset(_randn(rng, (m, n), device), off) for _ in range(2))
    row = _jacobi_runs(
        lambda e, a, tw: ccd_tail.jacobi_diis_insert(
            R, T, eps_i, eps_a, -1.0, e, a, slot, n_valid, twin=tw),
        ring, "ccd_jacobi_diis", _close)
    assert bool((row[n_valid:] == 0).all())


def _mix_runs(call, outs, name, close):
    """K3/K3′ (``call(outs, twin)``, writing the tensors ``outs``) against
    its twin: the mixed amplitudes and energies within ``close``; a second
    launch repeats the first bit for bit."""
    before = kernels.LAUNCHES[name]
    ts = [tuple(t.clone() for t in outs) for _ in range(3)]
    es = [call(t, tw) for t, tw in zip(ts, (False, True, False))]
    assert kernels.LAUNCHES[name] == before + 2
    for a, b in zip(ts[0], ts[1]):
        close(a, b)
    for a, b in zip(es[0], es[1]):
        close(a, b)
    for a, b in zip(ts[2] + tuple(es[2]), ts[0] + tuple(es[0])):
        _same(a, b)


@pytest.mark.parametrize("shape", TAIL_SHAPES)
@pytest.mark.parametrize("n_valid,m", [(1, 6), (4, 6), (6, 6), (17, 17)])
def test_mix_energy_kernel_matches_twin(device, n_valid, m, shape):
    no, nv, off = shape
    rng = np.random.default_rng(n_valid + 7 * m)
    t2, n = (no, no, nv, nv), no * no * nv * nv
    amps = _offset(_randn(rng, (m, n), device), off)
    coeff = _randn(rng, (m,), device)
    V = _offset(_randn(rng, t2, device), off)
    Vx = _offset(V.transpose(2, 3).contiguous(), off)
    T = _offset(torch.zeros(t2, dtype=torch.float64, device=device), off)
    _mix_runs(lambda o, tw: ccd_tail.diis_mix_energy(
        amps, coeff, n_valid, o[0], V, Vx, twin=tw), (T,),
        "ccd_mix_energy", _close)


def test_tail_kernels_right_after_a_failed_call(device):
    """A call that raises, in the wrapper (a slot outside the ring) or in
    the library (a vector width the kernels do not take), leaves the next
    calls right: K2 and K3 against their twins."""
    from pymes_tpu_torch.kernels import _build

    rng = np.random.default_rng(99)
    eps_i, eps_a = _tail_eps(rng, NO, 12, device)
    t2, n = (NO, NO, 12, 12), NO * NO * 144
    R, T, V = (_randn(rng, t2, device) for _ in range(3))
    ring = (_randn(rng, (6, n), device), _randn(rng, (6, n), device))
    coeff = _randn(rng, (6,), device)
    with pytest.raises(ValueError):
        ccd_tail.jacobi_diis_insert(R, T, eps_i, eps_a, -1.0, *ring, 6, 6)
    lib = _build.library()
    out = torch.empty(6 + 6 + 1, dtype=torch.float64, device=device)
    rc = _build.launch(R.device, lib.pymes_cc_jacobi, None, None,
                       R.data_ptr(), T.data_ptr(), eps_i.data_ptr(),
                       eps_a.data_ptr(), -1.0, ring[0].data_ptr(),
                       ring[1].data_ptr(), out.data_ptr(), 0, n, NO, 12, 6,
                       2, 6, 3, 0, n // 3, 0, 1)
    assert rc != 0
    rc = _build.launch(R.device, lib.pymes_cc_mix, ring[1].data_ptr(),
                       coeff.data_ptr(), None, T.data_ptr(), None,
                       V.data_ptr(), V.data_ptr(), out.data_ptr(), 0, n, NO,
                       12, 6, 3, 0, n // 3, 0, 1, 0)
    assert rc != 0
    _jacobi_runs(lambda e, a, tw: ccd_tail.jacobi_diis_insert(
        R, T, eps_i, eps_a, -1.0, e, a, 2, 6, twin=tw), ring,
        "ccd_jacobi_diis", _close)
    _mix_runs(lambda o, tw: ccd_tail.diis_mix_energy(
        ring[1], coeff, 6, o[0], V, V, twin=tw), (T,),
        "ccd_mix_energy", _close)


def test_solve_on_card_matches_cpu(device):
    """The whole nP=19 solve: card (through the kernels) vs CPU (twins);
    on the card the set-up scatters its blocks through K10 once."""
    out = {}
    kernels.reset_launches()
    for dev in (device, torch.device("cpu")):
        _, blocks, eps_i, eps_a = _problem(2, dev)
        fock = torch.diag(torch.cat([eps_i, eps_a]))
        _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
        out[dev.type] = ccd.ccd_solve(fock, blocks, NO, T0, level_shift=-1.0,
                                      delta_e=1e-8, max_iter=60)
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    assert out["cuda"][5] == out["cpu"][5]
    n_it = out["cpu"][5]
    hist = (out["cuda"][6][:n_it].cpu() - out["cpu"][6][:n_it]).abs()
    assert float(hist.max()) <= 1e-10
    ccd_kernels = ("block_ladder", "ccd_jacobi_diis", "ccd_mix_energy",
                   "pair_symmetrize")
    assert all(launches[k] == n_it for k in ccd_kernels), launches
    assert launches["block_scatter"] == 1, launches
    assert all(launches[k] == 0 for k in launches
               if k not in ccd_kernels + ("block_scatter",)), launches


def test_kernels_refuse_what_they_do_not_take(device):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(2)
    plan = ueg_ladder.build_block_ladder(u, device=device)
    nv = u.n_spatial - NO
    T32 = torch.zeros((NO, NO, nv, nv), dtype=torch.float32, device=device)
    with pytest.raises(TypeError):
        ueg_ladder.block_ladder_apply_ij(plan, T32)
    T_wide = torch.zeros((NO, NO, nv + 1, nv + 1), dtype=torch.float64,
                         device=device)
    with pytest.raises(ValueError):
        ueg_ladder.block_ladder_apply_ij(plan, T_wide)
    ring = torch.zeros((6, T32.numel()), dtype=torch.float64, device=device)
    eps = torch.zeros(NO, dtype=torch.float64, device=device)
    with pytest.raises(TypeError):
        ccd_tail.jacobi_diis_insert(T32, T32, eps, eps, 0.0, ring, ring,
                                    0, 1)


def _columns(rng, nv, ncol, device):
    """T1 of ``ncol`` columns as the callers give it: (nv, 1) and (nv, 7)
    (the CCSD dressing), a column-major (nv, 33) view, and the 896
    columns of the FEAST nP=57 sigma as a strided (128, nv, 7) view of
    Krylov rows."""
    if ncol == 33:
        return _randn(rng, (ncol, nv), device).t()
    if ncol == 896:
        return _randn(rng, (128, nv * NO + 5), device)[:, :nv * NO].reshape(
            128, nv, NO)
    return _randn(rng, (nv, ncol), device)


@pytest.mark.parametrize("ncol", [1, 7, 33, 896])
@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
@pytest.mark.parametrize("cutoff", [5, 14])
def test_ovvv_gather_kernel_matches_twin(device, cutoff, pat, ncol):
    """K4 is one multiply an element, as its twin: bit for bit, at every
    column count, with one (p) row of the plan all outside the basis."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
    S = plan.S.clone()
    S[-1] = -1
    T1 = _columns(np.random.default_rng(cutoff + ncol), u.n_spatial - NO,
                  ncol, device)
    before = kernels.LAUNCHES["ovvv_gather"]
    got = k4.ovvv_gather(S, plan.W, T1)
    want = k4.ovvv_gather(S, plan.W, T1, twin=True)
    assert kernels.LAUNCHES["ovvv_gather"] == before + 1
    assert got.shape == want.shape == (ncol,) + tuple(S.shape)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0 and not bool(got[:, -1].any())
    assert torch.equal(got, want)


@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
def test_ovvv_batched_apply_reads_strided_trials(device, pat):
    """The sigma's entry on a (k, nv, no) view of (k, N) Krylov rows (the
    FEAST/RT layout, read in place) equals the per-trial gathers."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(10)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
    nv = u.n_spatial - NO
    rows = _randn(np.random.default_rng(123), (5, nv * NO + nv), device)
    U1 = rows[:, :nv * NO].reshape(5, nv, NO)
    got = ueg_ladder.ovvv_t1_apply(plan, U1)
    want = torch.stack([ueg_ladder.ovvv_t1_apply(plan, U1[b].contiguous(),
                                                 twin=True)
                        for b in range(5)])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("pat,axis", [("vov", 1), ("ovv", 0)])
@pytest.mark.parametrize("cutoff", [5, 14])
def test_ovvv_gather_diag_kernel_matches_twin(device, cutoff, pat, axis):
    """The fused G_vv trace against the full gather and its einsum."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
    T1 = _randn(np.random.default_rng(cutoff), (u.n_spatial - NO, NO),
                device)
    before = dict(kernels.LAUNCHES)
    got = ueg_ladder.ovvv_t1_trace(plan, T1, axis)
    want = ueg_ladder.ovvv_t1_trace(plan, T1, axis, twin=True)
    assert kernels.LAUNCHES["ovvv_gather_diag"] == \
        before["ovvv_gather_diag"] + 1
    assert kernels.LAUNCHES["ovvv_gather"] == before["ovvv_gather"]
    assert got.shape == want.shape == (u.n_spatial - NO,) * 2
    _close(got, want)


def test_block_ladder_kernel_stacked_operand_np219(device):
    """K1 on the all-bra plan with T2 stacked over T1⊗T1, (2·no², nv²):
    the operand of the matrix-free CCSD iteration."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(14)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all")
    nv = u.n_spatial - NO
    rng = np.random.default_rng(219)
    T2 = _randn(rng, (NO, NO, nv, nv), device, 0.01)
    T1 = _randn(rng, (nv, NO), device, 0.01)
    X = torch.einsum("ci,dj->ijcd", T1, T1)
    TX = torch.stack([T2.reshape(NO * NO, nv, nv),
                      X.reshape(NO * NO, nv, nv)])
    got = ueg_ladder.block_ladder_apply_ij(plan, TX)
    want = ueg_ladder.block_ladder_apply_ij(plan, TX, twin=True)
    assert got.shape == (2, NO * NO, plan.n_bra, plan.n_bra)
    _close(got, want)


@pytest.mark.parametrize("shape", TAIL_SHAPES)
@pytest.mark.parametrize("slot,n_valid,m", [(0, 1, 6), (3, 4, 6), (2, 6, 6),
                                            (16, 17, 17)])
def test_ccsd_jacobi_diis_kernel_matches_twin(device, slot, n_valid, m,
                                              shape):
    """K2′ over [T1 | T2]: N1 = 84 (aligned), N1 = 91 (odd: scalars), and
    operands one element off the 16-byte grid."""
    no, nv, off = shape
    rng = np.random.default_rng(slot + 7 * m)
    eps_i, eps_a = _tail_eps(rng, no, nv, device)
    n = nv * no + no * no * nv * nv
    R1, T1 = (_randn(rng, (nv, no), device) for _ in range(2))
    R2, T2 = (_offset(_randn(rng, (no, no, nv, nv), device), off)
              for _ in range(2))
    ring = tuple(_offset(_randn(rng, (m, n), device), off) for _ in range(2))
    row = _jacobi_runs(
        lambda e, a, tw: ccsd_tail.jacobi_diis_insert(
            R1, T1, R2, T2, eps_i, eps_a, -1.0, e, a, slot, n_valid,
            twin=tw), ring, "ccsd_jacobi_diis", _close)
    assert bool((row[n_valid:] == 0).all())


@pytest.mark.parametrize("shape", TAIL_SHAPES)
@pytest.mark.parametrize("n_valid,m", [(1, 6), (4, 6), (6, 6), (17, 17)])
def test_ccsd_mix_energy_kernel_matches_twin(device, n_valid, m, shape):
    """K3′: the T1 segment mixed in its own launch, the T2 elements reading
    the mixed T1 factors of T_eff; the one-body energy seeded."""
    no, nv, off = shape
    rng = np.random.default_rng(n_valid + 7 * m)
    t2, n = (no, no, nv, nv), nv * no + no * no * nv * nv
    amps = _offset(_randn(rng, (m, n), device), off)
    coeff = _randn(rng, (m,), device)
    F1 = _randn(rng, (nv, no), device)
    V = _offset(_randn(rng, t2, device), off)
    Vx = _offset(V.transpose(2, 3).contiguous(), off)
    outs = (torch.zeros((nv, no), dtype=torch.float64, device=device),
            _offset(torch.zeros(t2, dtype=torch.float64, device=device),
                    off))
    _mix_runs(lambda o, tw: ccsd_tail.diis_mix_energy(
        amps, coeff, n_valid, o[0], o[1], F1, V, Vx, twin=tw), outs,
        "ccsd_mix_energy", _close)


def test_mf_ccsd_on_card_matches_cpu(device):
    """Matrix-free CCSD, nP=19 (rs=1.0, cutoff 2) with the seeded
    non-canonical Fock: card (K1, K4, K2′, K3′) vs CPU (twins)."""
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    noise = np.random.default_rng(5).standard_normal(tuple(fock.shape))
    fock = fock + torch.as_tensor(0.02 * noise + 0.02 * noise.T)
    out = {}
    for dev in (device, torch.device("cpu")):
        d = {k: v.to(dev) for k, v in part_2_body_int(NO, V).items()
             if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
        d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=dev)
        plan = ueg_ladder.build_block_ladder(u, device=dev, bra="all")
        kernels.reset_launches()
        out[dev.type] = ccsd.CCSD(NO, device=dev).solve(
            fock.to(dev), d, ladder=plan, delta_e=1e-10, max_iter=100)
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    n_it = len(out["cpu"]["e history"])
    assert len(out["cuda"]["e history"]) == n_it
    hist = np.abs(out["cuda"]["e history"] - out["cpu"]["e history"])
    assert float(hist.max()) <= 1e-10
    assert float(out["cpu"]["t1"].abs().max()) > 1e-3
    for k in ("block_ladder", "ccsd_jacobi_diis", "ccsd_mix_energy"):
        assert launches[k] == n_it, launches
    # the dressing: 4 full gathers and 2 traced ones (G_vv) an iteration
    assert launches["ovvv_gather"] == 4 * n_it, launches
    assert launches["ovvv_gather_diag"] == 2 * n_it, launches
    assert launches["ccd_jacobi_diis"] == launches["ccd_mix_energy"] == 0


def test_ovvv_gather_refuses_what_it_does_not_take(device):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(2)
    plan = ueg_ladder.build_ovvv_t1_plan(u, "vvo", device=device)
    T1 = torch.zeros((u.n_spatial - NO, NO), dtype=torch.float64,
                     device=device)
    with pytest.raises(TypeError):
        ueg_ladder.ovvv_t1_apply_j(plan._replace(S=plan.S.long()), T1)
    with pytest.raises(TypeError):
        ueg_ladder.ovvv_t1_apply_j(plan, T1.float())
    with pytest.raises(ValueError):
        ueg_ladder.ovvv_t1_apply_j(plan._replace(W=plan.W[:, :-1]), T1)
    vov = ueg_ladder.build_ovvv_t1_plan(u, "vov", device=device)
    with pytest.raises(TypeError):
        ueg_ladder.ovvv_t1_trace(vov._replace(S=vov.S.long()), T1, 1)
    with pytest.raises(TypeError):
        ueg_ladder.ovvv_t1_trace(vov, T1.float(), 1)
    with pytest.raises(ValueError):        # no axis 2
        ueg_ladder.ovvv_t1_trace(vov, T1, 2)
    with pytest.raises(ValueError):        # axis 0 of vov runs over nv
        ueg_ladder.ovvv_t1_trace(vov, T1, 0)
    with pytest.raises(ValueError):        # a batch has no trace
        ueg_ladder.ovvv_t1_trace(vov, T1[None], 1)
    with pytest.raises(ValueError):        # plan and T1 on two devices
        k4.ovvv_gather_diag(vov.S, vov.W.cpu(), T1, 1)


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("layout", ["ijab", "abij"])
def test_pair_symmetrize_kernel_matches_twin(device, layout, batch, with_y):
    """K5 on the CCD/CCSD residual layout (no, no, nv, nv) and the EOM
    sigma layout (nv, nv, no, no), with and without a batch axis and Y."""
    nv = 12
    shape = (NO, NO, nv, nv) if layout == "ijab" else (nv, nv, NO, NO)
    if batch is not None:
        shape = (batch,) + shape
    rng = np.random.default_rng(len(shape) + 2 * with_y)
    X = _randn(rng, shape, device)
    Y = _randn(rng, shape, device) if with_y else None
    before = kernels.LAUNCHES["pair_symmetrize"]
    got = pair_sym.pair_symmetrize(X, Y)
    want = pair_sym.pair_symmetrize(X, Y, twin=True)
    assert kernels.LAUNCHES["pair_symmetrize"] == before + 1
    assert got.shape == want.shape
    torch.cuda.synchronize()
    assert torch.equal(got, want)        # the twin's order: bit for bit


# (shape, with Y): the EOM sigma's abij batches at nP=219 (nv = 212), the
# CCD/CCSD residual's ijab with Y, and the edges: R = 1, R = 16 / 17 around
# the switch from the warp program to the tiled one, odd P, P = 1
K5_SHAPES = [((1, 212, 212, 7, 7), False), ((2, 212, 212, 7, 7), False),
             ((1, 212, 212, 7, 7), True), ((2, 212, 212, 7, 7), True),
             ((7, 7, 212, 212), True), ((2, 7, 7, 212, 212), False),
             ((5, 5, 1, 1), True), ((2, 9, 9, 16, 16), True),
             ((2, 9, 9, 17, 17), True), ((3, 3, 33, 33), False),
             ((13, 13, 7, 7), True), ((1, 1, 7, 7), False),
             ((1, 1, 40, 40), True), ((2, 1, 1, 17, 17), False)]


@pytest.mark.parametrize("shape,with_y", K5_SHAPES)
def test_pair_symmetrize_kernel_bit_equal_at_edges(device, shape, with_y):
    rng = np.random.default_rng(sum(shape) + with_y)
    X = _randn(rng, shape, device)
    Y = _randn(rng, shape, device) if with_y else None
    got = pair_sym.pair_symmetrize(X, Y)
    want = pair_sym.pair_symmetrize(X, Y, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [16, 5])
@pytest.mark.parametrize("k", [1, 2])
def test_davidson_residual_kernel_matches_twin(device, k, m):
    """K6 with m < max_dim valid rows (zero past them) and k = 1, 2, with
    denominators inside the clamp."""
    rng = np.random.default_rng(10 * k + m)
    max_dim, N = 16, 5000
    U = torch.zeros((max_dim, N), dtype=torch.float64, device=device)
    W = torch.zeros_like(U)
    U[:m], W[:m] = _randn(rng, (m, N), device), _randn(rng, (m, N), device)
    v = torch.zeros((max_dim, k), dtype=torch.float64, device=device)
    v[:m] = _randn(rng, (m, k), device)
    e = _randn(rng, (k,), device) + 2.0
    diag = _randn(rng, (N,), device) + 2.0
    diag[:3] = e[0] + torch.tensor([0.0, 3e-6, -4e-6], dtype=torch.float64,
                                   device=device)
    before = kernels.LAUNCHES["davidson_residual"]
    got = davidson.davidson_residual(U, W, v, e, diag, m)
    want = davidson.davidson_residual(U, W, v, e, diag, m, twin=True)
    assert kernels.LAUNCHES["davidson_residual"] == before + 1
    assert got.shape == (k, N)
    # the clamped columns are ~1e5 larger: each part to its own scale
    _close(got[:, :3], want[:, :3])
    _close(got[:, 3:], want[:, 3:])


def test_eom_on_card_matches_cpu(device):
    """EOM-CCSD on the matrix-free no-ovvv operator, nP=19 (rs=1.0,
    cutoff 2, MP2 amplitudes): card (K1, K4, K5, K6) vs CPU (twins), the
    same roots and iteration count."""
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    out = {}
    for dev in (device, torch.device("cpu")):
        d = {k: v.to(dev) for k, v in part_2_body_int(NO, V).items()
             if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
        d["abcd"] = None
        d["abcd_ladder"] = ueg_ladder.build_block_ladder(u, device=dev,
                                                         bra="all")
        d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=dev)
        f = fock.to(dev)
        eps = torch.diagonal(f)
        _, T2 = mp2.solve(eps[:NO], eps[NO:], d["ijab"], d["abij"], 0.0)
        kernels.reset_launches()
        solver = eom_ccsd.EOM_CCSD(NO, device=dev, n_excit=2)
        out[dev.type] = (np.sort(solver.solve(f, d, T2)),
                         solver.n_iterations)
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    assert out["cuda"][1] == out["cpu"][1]
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 1e-10
    for k in ("block_ladder", "ovvv_gather", "pair_symmetrize",
              "davidson_residual"):
        assert launches[k] > 0, launches


def _krylov(rng, L, R1, n, device):
    """Seeded Krylov bases (L, R1, n) with orthonormal rows, new vectors
    (L, n) and the lanes in reverse order (so lane ≠ row index)."""
    V = torch.linalg.qr(_randn(rng, (L, n, R1), device))[0].transpose(1, 2)
    return V.contiguous(), _randn(rng, (L, n), device), \
        torch.arange(L - 1, -1, -1, device=device)


@pytest.mark.parametrize("R1,n", [(121, 9000), (21, 70001)])
def test_arnoldi_cgs2_kernel_matches_twin(device, R1, n):
    """K7 with m = 1, a middle value and restart (the last step): the
    Hessenberg columns and the written row V[lane, m] against the twin."""
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(R1)
    L = 4
    V0, w, lanes = _krylov(rng, L, R1, n, device)
    for ms in ([1, 1, 1, 1], [1, R1 // 2, R1 - 1, 7]):
        m = torch.as_tensor(ms, device=device)
        Vk, Vt = V0.clone(), V0.clone()
        before = kernels.LAUNCHES["arnoldi_cgs2"]
        hk = arnoldi.arnoldi_cgs2(Vk, w.clone(), lanes, m)
        ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
        assert kernels.LAUNCHES["arnoldi_cgs2"] == before + 1
        assert hk.shape == (L, R1)
        _close(hk, ht)
        rows = Vt[lanes, m]
        _close(Vk[lanes, m], rows)
        assert torch.equal(Vk[lanes, 0], V0[lanes, 0])   # only row m moved
        assert float(rows.abs().max()) > 0


@pytest.mark.parametrize("with_x0", [False, True])
def test_krylov_combine_kernel_matches_twin(device, with_x0):
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(5 + with_x0)
    L, R1, n = 3, 121, 30001
    V, x0, lanes = _krylov(rng, L, R1, n, device)
    m = torch.as_tensor([1, 60, 121], device=device)
    C = _randn(rng, (L, R1), device)
    args = (V, C, m, lanes)
    x0 = x0 if with_x0 else None
    _close(arnoldi.krylov_combine(*args, x0=x0),
           arnoldi.krylov_combine(*args, x0=x0, twin=True))


def test_arnoldi_cgs2_int64_offsets(device):
    """L·(restart+1)·n > 2³¹: the last lane's rows lie past the int32
    range (17.4 GB of f64 basis)."""
    from pymes_tpu_torch.kernels import arnoldi
    L, R1, n = 2, 121, 9_000_000
    assert L * R1 * n > 2 ** 31
    V = torch.zeros((L, R1, n), dtype=torch.float64, device=device)
    rng = np.random.default_rng(31)
    m = torch.as_tensor([3, 3], device=device)
    lanes = torch.as_tensor([1, 0], device=device)
    V[:, :3] = _randn(rng, (L, 3, n), device) / 3000.0
    w = _randn(rng, (L, n), device)
    Vt = V[:, :4].clone()
    hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, m)
    ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
    _close(hk[:, :4], ht[:, :4])
    _close(V[1, 3], Vt[1, 3])
    C = _randn(rng, (L, R1), device)
    _close(arnoldi.krylov_combine(V, C, m, lanes),
           arnoldi.krylov_combine(V, C, m, lanes, twin=True))


@pytest.mark.parametrize("mode,rt", [("apply", False), ("apply", True),
                                     ("residual", False),
                                     ("residual", True),
                                     ("precond", False), ("precond", True)])
def test_shifted_precond_kernel_matches_twin(device, mode, rt):
    """K8 in its FEAST, RT, residual and preconditioner modes on 3 lanes
    (singles 84 columns, doubles 7056: the nP=19 split)."""
    from pymes_tpu_torch.kernels import shifted
    rng = np.random.default_rng(len(mode) + rt)
    La, n1, n2 = 3, 84, 7056
    N = n1 + n2
    X = _randn(rng, (La, 2 * N), device)
    H1 = _randn(rng, (2 * La, n1), device)
    H2 = _randn(rng, (2 * La, n2), device)
    zr = _randn(rng, (La,), device, 0.1) + 0.5
    zi = _randn(rng, (La,), device, 0.1) + 0.3
    diag = _randn(rng, (N,), device) + 1.0
    B = _randn(rng, (La, 2 * N), device) if mode == "residual" else None
    kw = dict(dt=0.1, rt=rt, mode=mode, B=B)
    before = kernels.LAUNCHES["shifted_precond"]
    got = shifted.shifted_precond(H1, H2, X, zr, zi, diag, **kw)
    want = shifted.shifted_precond(H1, H2, X, zr, zi, diag, twin=True, **kw)
    assert kernels.LAUNCHES["shifted_precond"] == before + 1
    if mode != "residual":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)


def test_feast_on_card_matches_cpu(device):
    """FEAST on the nP=19 no-ovvv operator (MP2 amplitudes): card (K1, K4,
    K5, K7, K8) vs CPU (twins), the same roots."""
    from pymes_tpu_torch.solver import feast_eom_ccsd
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    out = {}
    for dev in (device, torch.device("cpu")):
        d = {k: v.to(dev) for k, v in part_2_body_int(NO, V).items()
             if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
        d["abcd"] = None
        d["abcd_ladder"] = ueg_ladder.build_block_ladder(u, device=dev,
                                                         bra="all")
        d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=dev)
        f = fock.to(dev)
        eps = torch.diagonal(f)
        _, T2 = mp2.solve(eps[:NO], eps[NO:], d["ijab"], d["abij"], 0.0)
        e0 = float(eom_ccsd.EOM_CCSD(NO, device=dev, n_excit=1).solve(
            f, d, T2)[0])
        kernels.reset_launches()
        s = feast_eom_ccsd.FEAST_EOM_CCSD(NO, device=dev, e_c=e0, e_r=0.3,
                                          n_trial=2, max_iter=2, tol=-1.0,
                                          seed=3, ls_conv_tol=1e-8)
        s.ls_restart, s.ls_max_iter = 40, 4
        out[dev.type] = np.sort_complex(s.solve(f, d, T2))
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-8)
    for k in ("block_ladder", "ovvv_gather", "pair_symmetrize",
              "arnoldi_cgs2", "shifted_precond"):
        assert launches[k] > 0, launches


def _ring_views(layout, T_held, R):
    """The (M, K) and (M, N) views K9 takes: row-major ijab tensors, or the
    transposed views of cd-major (abij) ones."""
    if layout == "ijab":
        return T_held.view(T_held.shape[0] * T_held.shape[1], -1), \
            R.view(R.shape[0] * R.shape[1], -1)
    M = T_held.shape[-1] * T_held.shape[-2]
    return T_held.view(-1, M).t(), R.view(-1, M).t()


@pytest.mark.parametrize("layout", ["ijab", "abij"])
@pytest.mark.parametrize("nv, n_dev", [(16, 4), (50, 5)])
def test_ring_step_kernel_matches_twin(device, nv, n_dev, layout):
    """K9 at every panel offset of a shard, both layouts, accumulating
    into a nonzero R."""
    rng = np.random.default_rng(nv)
    no, csz = 3 if nv == 16 else NO, nv // n_dev
    V_loc = _randn(rng, (csz, nv, nv, nv), device)
    Vm = V_loc.view(csz * nv, nv * nv)
    ij = layout == "ijab"
    for src in range(n_dev):
        T = _randn(rng, (no, no, csz, nv) if ij else (csz, nv, no, no),
                   device)
        R0 = _randn(rng, (no, no, csz, nv) if ij else (csz, nv, no, no),
                    device)
        got, want = R0.clone(), R0.clone()
        Tv, Rv = _ring_views(layout, T, got)
        kernels.reset_launches()
        ring_step.ring_step(Rv, Tv, Vm, src * csz * nv)
        assert kernels.LAUNCHES["ring_step"] == 1
        Tv, Rv = _ring_views(layout, T, want)
        ring_step.ring_step(Rv, Tv, Vm, src * csz * nv, twin=True)
        assert kernels.LAUNCHES["ring_step"] == 1
        _close(got - R0, want - R0)


def test_ring_ladder_on_a_repeated_card_matches_twin(device):
    """The ring over ["cuda:0"] * 4: K9 P² times, equal to the twin's ring
    and to the dense einsum."""
    from pymes_tpu_torch.parallel import mesh, ring_ladder
    rng = np.random.default_rng(3)
    no, nv, P = 3, 16, 4
    V = _randn(rng, (nv, nv, nv, nv), device)
    T = _randn(rng, (no, no, nv, nv), device)
    m = mesh.make_mesh(P, device="cuda", devices=[device] * P)
    Vs = mesh.shard_blocks(m, {"abcd": V})["abcd"]
    kernels.reset_launches()
    got = ring_ladder.ring_ladder_inside_ij(Vs, T, m)
    assert kernels.LAUNCHES["ring_step"] == P * P
    _close(got, ring_ladder.ring_ladder_inside_ij(Vs, T, m, twin=True))
    _close(got, torch.einsum("abcd,ijcd->ijab", V, T))
    Ta = T.permute(2, 3, 0, 1).contiguous()
    _close(ring_ladder.ring_ladder(V, Ta, m),
           torch.einsum("abcd,cdij->abij", V, Ta))


def test_ring_ladder_over_two_cards(device):
    """The same ring over two distinct cards (peer copies)."""
    from pymes_tpu_torch.parallel import mesh, ring_ladder
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    rng = np.random.default_rng(4)
    no, nv = 3, 16
    m = mesh.make_mesh(2, device="cuda")
    V = _randn(rng, (nv, nv, nv, nv), m.devices[0])
    T = _randn(rng, (no, no, nv, nv), m.devices[0])
    Vs = mesh.shard_tensor(m, V, 0)
    assert Vs.shards[1].device == m.devices[1]
    got = ring_ladder.ring_ladder_inside_ij(Vs, T, m)
    assert got.device == m.devices[0]
    _close(got, torch.einsum("abcd,ijcd->ijab", V, T))


def _k1_cd(plan, Tt):
    """K1 twice on a cd-major operand (reruns must be bit-equal) and its
    twin; returns (kernel, twin)."""
    before = kernels.LAUNCHES["block_ladder"]
    got = k1.block_ladder_cd(plan, Tt)
    again = k1.block_ladder_cd(plan, Tt)
    assert kernels.LAUNCHES["block_ladder"] == before + 2
    want = k1.block_ladder_cd(plan, Tt, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.shape == want.shape and float(want.abs().max()) > 0
    return got, want


@pytest.mark.parametrize("N", [1, 49, 98, 6272, 33, 77, 129])
@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_block_ladder_kernel_widths(device, bra, N):
    """K1 on the nP=57 plans at operand widths N = no² (one tile of 7 n8
    tiles), 2 no² (13), the FEAST lane batch 128 no² (tiles of 16), odd
    widths and one column."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra=bra)
    nv = u.n_spatial - NO
    Tt = _randn(np.random.default_rng(N), (nv * nv, N), device)
    _close(*_k1_cd(plan, Tt))


@pytest.mark.parametrize("N,ld", [(98, 99), (49, 51), (49, 50), (8, 13)])
def test_block_ladder_kernel_row_stride(device, N, ld):
    """A cd-major operand whose rows lie ``ld`` doubles apart (odd: 8-byte
    copies; even: 16-byte ones) gives the contiguous operand's bits."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all")
    nv = u.n_spatial - NO
    buf = _randn(np.random.default_rng(ld), (nv * nv, ld), device)
    got, want = _k1_cd(plan, buf[:, :N])
    _close(got, want)
    assert torch.equal(got, k1.block_ladder_cd(
        plan, buf[:, :N].contiguous()))


@pytest.mark.parametrize("N", [49, 98])
def test_block_ladder_kernel_on_8x8_buckets_only(device, N):
    """A plan whose only bucket is 8 × 8 (sectors packed four to a unit),
    with padding rows and bra pairs that no sector holds (zero rows)."""
    rng = np.random.default_rng(8)
    nv, nS = 10, 12
    kets = rng.permutation(nv * nv)[:8 * nS].reshape(nS, 8)
    bras = rng.permutation(nv * nv)[:8 * nS].reshape(nS, 8)
    blocks = rng.standard_normal((nS, 8, 8))
    inv_bra = np.full(nv * nv, 8 * nS, np.int64)       # the zero column
    for t in range(nS):
        live = 8 - t % 4                                # padding rows
        blocks[t, live:] = 0.0
        inv_bra[bras[t, :live]] = t * 8 + np.arange(live)
    plan = ueg_ladder.plan_from_arrays([(blocks, kets.astype(np.int32))],
                                       inv_bra, nv, nv, 0.0, device)
    assert plan.packed.zero_rows.numel() > 0
    Tt = _randn(rng, (nv * nv, N), device)
    got, want = _k1_cd(plan, Tt)
    _close(got, want)
    assert bool((got[plan.packed.zero_rows.long()] == 0).all())


def test_block_ladder_kernel_np219_widths(device):
    """K1 at nP=219 (all-bra) on the main path's N = 49 (through the ijab
    entry's even-stride copy) and the stacked N = 98 cd-major operand."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(14)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all")
    nv = u.n_spatial - NO
    rng = np.random.default_rng(49)
    T = _randn(rng, (NO, NO, nv, nv), device, 0.01)
    got = ueg_ladder.block_ladder_apply_ij(plan, T)
    _close(got, ueg_ladder.block_ladder_apply_ij(plan, T, twin=True))
    _close(*_k1_cd(plan, _randn(rng, (nv * nv, 2 * NO * NO), device, 0.01)))


def test_sharded_block_ladder_kernel_bit_equal(device):
    """K1 on the sector-sharded all-bra plan (4 shards of one card, one
    launch each) equals K1 on the whole padded plan bit for bit."""
    from pymes_tpu_torch.parallel import mesh
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    nv = u.n_spatial - NO
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all",
                                         pad_sectors=4)
    sh = ueg_ladder.shard_block_ladder(
        plan, mesh.make_mesh(4, device="cuda", devices=[device] * 4))
    rng = np.random.default_rng(5)
    T = _randn(rng, (NO, NO, nv, nv), device)
    Tb = _randn(rng, (2, nv, nv, NO, NO), device)
    kernels.reset_launches()
    got = ueg_ladder.block_ladder_apply_ij(sh, T)
    assert kernels.LAUNCHES["block_ladder"] == 4
    want = ueg_ladder.block_ladder_apply_ij(plan, T)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ueg_ladder.block_ladder_apply(sh, Tb),
                       ueg_ladder.block_ladder_apply(plan, Tb))
    _close(got, ueg_ladder.block_ladder_apply_ij(sh, T, twin=True))


# (M, N, K, row length L of V, panel offset c0, layout): M off the 16-row
# DMMA tile, N and K off the column tiles and the 32-deep stages, odd
# offsets and odd row strides (8-byte copies), one split and several
RING_EDGES = [(9, 100, 37, 101, 3, "ijab"), (9, 100, 37, 101, 3, "abij"),
              (57, 300, 129, 400, 7, "ijab"), (113, 1000, 999, 2001, 1,
                                              "abij"),
              (49, 2000, 3001, 3002, 1, "ijab"), (49, 2000, 3001, 3003, 2,
                                                  "abij"),
              (49, 4000, 4000, 8000, 0, "ijab")]


@pytest.mark.parametrize("M,N,K,L,c0,layout", RING_EDGES)
def test_ring_step_kernel_edges(device, M, N, K, L, c0, layout):
    rng = np.random.default_rng(M + N + c0)
    V = _randn(rng, (N, L), device)
    T = _randn(rng, (M, K), device) if layout == "ijab" else \
        _randn(rng, (K, M), device).t()
    R0 = _randn(rng, (M, N), device) if layout == "ijab" else \
        _randn(rng, (N, M), device).t()
    got = [R0.clone() for _ in range(2)]
    for R in got:
        ring_step.ring_step(R, T, V, c0)
    want = ring_step.ring_step(R0.clone(), T, V, c0, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    _close(got[0] - R0, want - R0)


def test_ring_step_edges_plan_one_split_and_several(device):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = {ring_step.plan(M, N, K, sms)[1]
              for M, N, K, *_ in RING_EDGES}
    assert 1 in splits and max(splits) > 1


def _unit_basis(L, R1, n, device):
    """Bases whose rows are standard unit vectors (lane l, row i is
    e_{(7 l + 3 i) mod n}): products with them are exact."""
    V = torch.zeros((L, R1, n), dtype=torch.float64, device=device)
    for l in range(L):
        for i in range(R1):
            V[l, i, (7 * l + 3 * i) % n] = 1.0
    return V


@pytest.mark.parametrize("R1,n", [(121, 9000), (21, 70002)])
def test_arnoldi_cgs2_kernel_edges(device, R1, n):
    """m = 1 and m = R on a lane subset, reruns bit-equal; the row written
    and the Hessenberg column against the twin."""
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(R1 + 1)
    L = 5
    V0, _, _ = _krylov(rng, L, R1, n, device)
    lanes = torch.as_tensor([3, 0], device=device)
    w = _randn(rng, (2, n), device)
    for ms in ([1, 1], [R1 - 1, 1], [R1 - 1, R1 - 1]):
        m = torch.as_tensor(ms, device=device)
        Vk, Vk2, Vt = V0.clone(), V0.clone(), V0.clone()
        hk = arnoldi.arnoldi_cgs2(Vk, w.clone(), lanes, m)
        hk2 = arnoldi.arnoldi_cgs2(Vk2, w.clone(), lanes, m)
        ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
        torch.cuda.synchronize()
        assert torch.equal(hk, hk2) and torch.equal(Vk, Vk2)
        _close(hk, ht)
        _close(Vk[lanes, m], Vt[lanes, m])
        # the lanes outside the subset are untouched
        assert torch.equal(Vk[[1, 2, 4]], V0[[1, 2, 4]])


def test_arnoldi_cgs2_kernel_breakdown_row(device):
    """w in the span of the valid rows: CGS2 leaves exactly zero, so the
    BREAK guard writes a zero row and a zero norm, as the twin does."""
    from pymes_tpu_torch.kernels import arnoldi
    L, R1, n, mm = 3, 21, 4000, 6
    V = _unit_basis(L, R1, n, device)
    lanes = torch.as_tensor([2, 1], device=device)
    m = torch.full((2,), mm, dtype=torch.int64, device=device)
    coef = torch.as_tensor([[1.5, -2.0, 0.25, 3.0, -0.5, 1.0],
                            [0.5, 1.0, -1.25, 2.0, 4.0, -3.0]],
                           dtype=torch.float64, device=device)
    w = torch.einsum("ai,ain->an", coef, V[lanes, :mm])
    Vt = V.clone()
    hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, m)
    ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(hk, ht)
    assert torch.equal(hk[:, :mm], coef)
    assert bool((hk[:, mm:] == 0).all())
    assert bool((V[lanes, mm] == 0).all())


@pytest.mark.parametrize("with_x0", [False, True])
def test_krylov_combine_xr_kernel_matches_twin(device, with_x0):
    """The fused two-output combine at m = 1 and m = R + 1 on a lane
    subset, reruns bit-equal, each output against its single twin."""
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(9 + with_x0)
    L, R1, n = 4, 121, 30002
    V, x0, _ = _krylov(rng, L, R1, n, device)
    lanes = torch.as_tensor([1, 3, 0], device=device)
    m = torch.as_tensor([1, R1, 60], device=device)
    C = _randn(rng, (3, 2, R1), device)
    x0 = x0[:3].contiguous() if with_x0 else None
    before = kernels.LAUNCHES["arnoldi_cgs2"]
    got = arnoldi.krylov_combine_xr(V, C, m, lanes, x0=x0)
    again = arnoldi.krylov_combine_xr(V, C, m, lanes, x0=x0)
    assert kernels.LAUNCHES["arnoldi_cgs2"] == before + 2
    want = arnoldi.krylov_combine_xr(V, C, m, lanes, x0=x0, twin=True)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c)


def _tc_model(cutoff, rs=0.5):
    """The transcorrelated UEG of ``chip_smoke.py`` phase 18: gaskell with
    ``k_cutoff`` as ``tests/test_ueg.py:114``."""
    u = ueg.UEG(14, 7, 7, rs)
    u.init_single_basis(cutoff)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / rs
    return u


@pytest.mark.parametrize("flags", [{"is_only_2b": True},
                                   {"is_only_non_hermi_2b": True},
                                   {"is_only_hermi_2b": True}],
                         ids=lambda f: next(iter(f)))
@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_block_ladder_kernel_matches_twin_on_tc_plans(device, bra, flags):
    """K1 on the TC sector blocks (the non-hermitian term added at build
    time), through the ijab and the cd-major entries; the all-bra
    non-hermitian plan is the one a transposed block would fail."""
    u = _tc_model(5)
    plan = ueg_ladder.build_block_ladder(u, device=device,
                                         correlator=u.gaskell,
                                         bra=bra, **flags)
    nv = u.n_spatial - NO
    T = _randn(np.random.default_rng(29), (NO, NO, nv, nv), device)
    before = kernels.LAUNCHES["block_ladder"]
    got = ueg_ladder.block_ladder_apply_ij(plan, T)
    want = ueg_ladder.block_ladder_apply_ij(plan, T, twin=True)
    assert kernels.LAUNCHES["block_ladder"] == before + 1
    _close(got, want)
    Tab = T.permute(2, 3, 0, 1).contiguous()
    _close(ueg_ladder.block_ladder_apply(plan, Tab),
           ueg_ladder.block_ladder_apply(plan, Tab, twin=True))


@pytest.mark.parametrize("ncol", [7, 14, 896])
@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
def test_ovvv_gather_kernel_matches_twin_on_tc_plans(device, pat, ncol):
    """K4 on the hermitian-TC OVVV plans (their W carries the Σ∇u·∇u
    convolution and q²u): bit for bit, and the fused trace to 1e-12."""
    u = _tc_model(5)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device,
                                         correlator=u.gaskell,
                                         is_only_hermi_2b=True)
    nv = u.n_spatial - NO
    T1 = _columns(np.random.default_rng(ncol), nv, ncol, device)
    got = k4.ovvv_gather(plan.S, plan.W, T1)
    want = k4.ovvv_gather(plan.S, plan.W, T1, twin=True)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0 and torch.equal(got, want)
    axis = {"vov": 1, "ovv": 0}.get(pat)
    if axis is not None and ncol == 7:
        T1o = _randn(np.random.default_rng(3), (nv, NO), device)
        _close(ueg_ladder.ovvv_t1_trace(plan, T1o, axis),
               ueg_ladder.ovvv_t1_trace(plan, T1o, axis, twin=True))


def test_entry_points_default_to_the_card(device):
    """Given no device, the entry points place their tensors on the card;
    the HF functions take numpy there and give tensors that numpy reads
    back; the reference's ``ladder_apply(plan, T, 1)`` (its ``chunk``) is
    one K1 launch, bit-equal to the default call."""
    assert ccd.CCD(NO).device.type == "cuda"
    assert ccsd.CCSD(NO).device.type == "cuda"
    assert eom_ccsd.EOM_CCSD(NO, n_excit=2).device.type == "cuda"
    u = ueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(2)
    plan = ueg_ladder.build_block_ladder(u)
    assert plan.inv_bra.is_cuda and all(g.blocks.is_cuda
                                        for g in plan.groups)
    idx, vals = u.eval_2b_integrals(sp=2)
    d = ueg.sparse_to_blocks(idx, vals, u.n_spatial, NO)
    assert all(t.is_cuda for t in d.values())
    V = u.eval_2b_integrals()
    h = np.diag(u.kinetic_energies())
    f = hf.construct_hf_matrix(NO, h, V)
    want = hf.construct_hf_matrix(NO, h, V, device="cpu")
    assert f.is_cuda and not want.is_cuda
    assert np.abs(np.asarray(f) - np.asarray(want)).max() <= \
        REL * np.abs(np.asarray(want)).max()
    T = torch.as_tensor(np.random.default_rng(26).standard_normal(
        (plan.nv, plan.nv, NO, NO)), device=device)
    kernels.reset_launches()
    W1 = ueg_ladder.ladder_apply(plan, T, 1)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "block_ladder": 1}
    assert torch.equal(W1, ueg_ladder.ladder_apply(plan, T))


def test_configs_build_solvers_on_the_card_by_default(device):
    """The configs' default device is the card: a config-built mf-CCD at
    cutoff 5 runs there (one K1, K2, K3 and K5 launch an iteration) and
    repeats the CPU solve."""
    from pymes_tpu_torch import configs

    cfg = configs.GroundStateConfig(no=NO, max_iter=60)
    for make in (cfg.make_ccd, cfg.make_ccsd, configs.EOMConfig(no=NO).make,
                 configs.FEASTConfig(no=NO).make,
                 configs.RTConfig(no=NO).make):
        assert make().device.type == "cuda"
    runs = {}
    for dev in ("cuda", "cpu"):
        _, blocks, eps_i, eps_a = _problem(5, dev)
        before = dict(kernels.LAUNCHES)
        runs[dev] = cfg.make_ccd(device=dev).solve(
            torch.diag(torch.cat([eps_i, eps_a])), blocks, level_shift=-1.0)
        if dev == "cuda":
            n = len(runs[dev]["e history"])
            for k in ("block_ladder", "ccd_jacobi_diis", "ccd_mix_energy",
                      "pair_symmetrize"):
                assert kernels.LAUNCHES[k] - before[k] == n, k
    assert len(runs["cuda"]["e history"]) == len(runs["cpu"]["e history"])
    assert np.abs(runs["cuda"]["e history"]
                  - runs["cpu"]["e history"]).max() <= 1e-10


def test_checkpoint_round_trip_of_card_tensors(device, tmp_path):
    """A CCSD result on the card: from_result copies its tensors to the
    host, save/load keep them bit for bit, the DIIS ring comes back on the
    card, and the warm start from the loaded amplitudes runs there."""
    from pymes_tpu_torch.util import checkpoint

    u, blocks, eps_i, eps_a = _problem(2, device)
    fock = torch.diag(torch.cat([eps_i, eps_a]))
    V = torch.as_tensor(u.eval_2b_integrals(), device=device)
    res = ccsd.CCSD(NO, device=device).solve(fock, V, max_iter=3)
    ck = checkpoint.from_result(res, meta={"nP": u.n_spatial})
    assert isinstance(ck.t2, np.ndarray) and isinstance(ck.t1, np.ndarray)
    rng = np.random.default_rng(8)
    ck.diis_amps, ck.diis_errs, ck.diis_count = (
        rng.standard_normal((6, 40)), rng.standard_normal((6, 40)), 9)
    checkpoint.save(str(tmp_path / "ck"), ck)
    back = checkpoint.load(str(tmp_path / "ck"))
    assert np.array_equal(back.t2, res["t2"].cpu().numpy())
    assert np.array_equal(back.t1, res["t1"].cpu().numpy())
    st = back.diis_state(device=device)
    assert st.amps.device.type == torch.device(device).type
    assert st.count == 9
    _close(st.B, torch.as_tensor(back.diis_errs @ back.diis_errs.T,
                                 device=device))
    warm = ccsd.CCSD(NO, device=device).solve(fock, V, amps=back.amps)
    cold = ccsd.CCSD(NO, device=device).solve(fock, V)
    assert abs(warm["ccsd e"] - cold["ccsd e"]) <= 1e-8


# ---- the last solver slice: the generic FEAST kernel, the node fan-out ----

def _no_ovvv_operator(dev, rs=1.0, cutoff=2):
    """The no-ovvv operator of the UEG 14e at ``rs`` and ``cutoff`` on
    ``dev`` (small blocks, no ``abcd``, the all-bra plan, the OVVV plans)
    with the HF Fock and MP2 amplitudes; by default nP=19, as in
    :func:`test_feast_on_card_matches_cpu`."""
    u = ueg.UEG(14, 7, 7, rs)
    u.init_single_basis(cutoff)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    d = {k: v.to(dev) for k, v in part_2_body_int(NO, V).items()
         if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
    d["abcd"] = None
    d["abcd_ladder"] = ueg_ladder.build_block_ladder(u, device=dev, bra="all")
    d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=dev)
    f = fock.to(dev)
    eps = torch.diagonal(f)
    _, T2 = mp2.solve(eps[:NO], eps[NO:], d["ijab"], d["abij"], 0.0)
    return f, d, T2


def test_packed_sigma_on_card_matches_cpu(device):
    """The generic kernel's matvec (one batched sigma of the (Re, Im) pair
    of rows) on the card equals its CPU twin within 1e-12 relative, and
    launches K1 (+ 1 for H̄), K4 three times and K5 once a matvec."""
    rng = np.random.default_rng(20)
    out, x, y = {}, None, None
    for dev in (device, torch.device("cpu")):
        f, d, T2 = _no_ovvv_operator(dev)
        kernels.reset_launches()
        op = eom_ccsd.PackedSigma(eom_ccsd.EOM_CCSD(NO, device=dev), f, d, T2)
        if x is None:
            x = rng.standard_normal(op.vector_size())
            y = rng.standard_normal(op.vector_size())
        out[dev.type] = (op.matvec(x), op.matvec(x + 1j * y),
                         op.diag)
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert (launches["block_ladder"], launches["ovvv_gather"],
            launches["pair_symmetrize"]) == (3, 6, 2), launches


def test_eom_reference_wrappers_on_card_match_cpu(device):
    """``EOM_CCSD.update_singles`` / ``update_doubles`` (the factorised
    sigma on one trial, H̄'s intermediates built in each call) on the nP=57
    no-ovvv operator (rs=0.5, cutoff 5, MP2 amplitudes): the card (K1, K4,
    K5) equals the CPU (twins) within 1e-12 relative.  Each call launches
    K1 twice (H̄'s W_laji and the trial's ladder image), update_doubles
    also K4 three times and K5 once."""
    rng = np.random.default_rng(21)
    out, u1, u2 = {}, None, None
    for dev in (device, torch.device("cpu")):
        f, d, T2 = _no_ovvv_operator(dev, 0.5, 5)
        if u1 is None:
            nv = T2.shape[0]
            u1 = rng.standard_normal((nv, NO))
            u2 = rng.standard_normal((nv, nv, NO, NO))
        args = (f, d, torch.as_tensor(u1, device=dev),
                torch.as_tensor(u2, device=dev), T2)
        solver = eom_ccsd.EOM_CCSD(NO, device=dev, n_excit=2)
        got, launches = [], []
        for name in ("update_singles", "update_doubles"):
            kernels.reset_launches()
            got.append(getattr(solver, name)(*args).cpu())
            launches.append(tuple(kernels.LAUNCHES[k] for k in (
                "block_ladder", "ovvv_gather", "pair_symmetrize")))
        out[dev.type] = got, launches
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert got.shape == want.shape
        _close(got, want)
    assert out["cuda"][1] == [(2, 0, 0), (2, 3, 1)], out["cuda"][1]
    assert out["cpu"][1] == [(0, 0, 0), (0, 0, 0)], out["cpu"][1]


def _lih_dressed(dev):
    from pymes_tpu_torch.util import fcidump
    from pathlib import Path
    path = Path(__file__).resolve().parent / "data" / "FCIDUMP.LiH.321g"
    n_elec, _, _, _, h, V = fcidump.read(str(path))
    no = n_elec // 2
    h, V = torch.as_tensor(h, device=dev), torch.as_tensor(V, device=dev)
    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no, device=dev)
    res = cc.solve(fock, V, delta_e=1e-12, max_iter=200)
    dV = part_2_body_int(no, V)
    return (cc.get_T1_dressed_fock(fock, res["t1"], dV),
            cc.get_T1_dressed_V(res["t1"], dV,
                                {k: None for k in ccsd.EOM_DRESSED}),
            res["t2"])


def test_generic_feast_over_card_sigma_matches_cpu(device):
    """``feast_kernel.feast`` over the card's LiH sigma equals the same
    run over the CPU twin within 1e-9 (the oracle roots 0.1180867 and
    0.1543762 in the window)."""
    from pymes_tpu_torch.solver import feast_kernel
    out = {}
    for dev in (device, torch.device("cpu")):
        fd, Vd, t2 = _lih_dressed(dev)
        op = eom_ccsd.PackedSigma(eom_ccsd.EOM_CCSD(t2.shape[-1], device=dev),
                                  fd,
                                  Vd, t2)
        kernels.reset_launches()
        ev, _ = feast_kernel.feast(op.matvec, op.diag, nroots=3, e_c=0.136,
                                   e_r=0.03, max_cycle=20, ls_max_iter=20,
                                   seed=3, verbose=False)
        out[dev.type] = np.sort(ev.real)
        if dev.type == "cuda":
            assert kernels.LAUNCHES["pair_symmetrize"] > 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-9)
    for r in (0.1180867, 0.1543762):
        assert np.min(np.abs(out["cuda"] - r)) < 1e-6


def test_node_mesh_feast_on_a_repeated_card_matches_unsharded(device):
    """FEAST with its 8 nodes over ``node_mesh(2, devices=["cuda:0"] *
    2)`` equals the unsharded card run within 1e-10 in its iterations."""
    from pymes_tpu_torch.parallel import sharding
    from pymes_tpu_torch.solver import feast_eom_ccsd
    f, d, T2 = _no_ovvv_operator(device)
    e0 = float(eom_ccsd.EOM_CCSD(NO, device=device, n_excit=1).solve(
        f, d, T2)[0])
    out = {}
    for P in (None, 2):
        mesh = None if P is None else sharding.node_mesh(
            P, device="cuda", axis="a", devices=["cuda:0"] * P)
        s = feast_eom_ccsd.FEAST_EOM_CCSD(NO, device=device, e_c=e0, e_r=0.3,
                                          n_trial=2, max_iter=3, tol=-1.0,
                                          seed=3, ls_conv_tol=1e-8,
                                          node_mesh=mesh)
        s.ls_restart, s.ls_max_iter = 40, 4
        out[P] = (np.sort_complex(s.solve(f, d, T2)), s.n_iterations,
                  [len(np.atleast_1d(a)) for a in s.ls_stats["steps"]])
    np.testing.assert_allclose(out[2][0], out[None][0], rtol=0, atol=1e-10)
    assert out[2][1] == out[None][1] == 3
    assert out[2][2] == [8] * 6 and out[None][2] == [16] * 3


def test_tensor_parallel_lih_ccsd_on_a_repeated_card_matches_cpu(device):
    """LiH/3-21G CCSD with every block cut over ``["cuda:0"] * 3`` (the
    tensor-parallel iteration: ov³/v⁴ blocks contracted piece by piece)
    equals the unsharded CPU run within 1e-10 in its iterations, with
    exactly one K2′, K3′ and K5 launch an iteration."""
    import os

    from pymes_tpu_torch.parallel import mesh
    from pymes_tpu_torch.util import fcidump
    n_elec, _, _, _, h, V = fcidump.read(os.path.join(
        os.path.dirname(__file__), "data", "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, torch.as_tensor(h), torch.as_tensor(V))
    d = part_2_body_int(no, torch.as_tensor(V))
    kw = dict(delta_e=1e-10, max_iter=100)
    ref = ccsd.CCSD(no, device="cpu").solve(fock, d, **kw)
    m = mesh.make_mesh(3, device="cuda", devices=[device] * 3)
    cut = mesh.shard_blocks(m, {k: v.to(device) for k, v in d.items()})
    kernels.reset_launches()
    res = ccsd.CCSD(no, device=device).solve(fock.to(device), cut, **kw)
    torch.cuda.synchronize()
    n_it = len(ref["e history"])
    assert len(res["e history"]) == n_it
    assert float(np.abs(res["e history"] - ref["e history"]).max()) <= 1e-10
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(ccsd_jacobi_diis=n_it, ccsd_mix_energy=n_it,
                pair_symmetrize=n_it)
    assert dict(kernels.LAUNCHES) == want


# ---- the f32 instantiations (the FEAST/RT mixed-precision engine) ----------

F32_REL = 1e-5


def _close32(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    err = float((got.double() - want.double()).abs().max())
    assert err <= F32_REL * float(want.double().abs().max()), err


def _randn32(rng, shape, device, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32, device=device)


@pytest.mark.parametrize("N", [1, 33, 49, 98, 3136, 6272])
@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_block_ladder_f32_kernel_matches_twin(device, bra, N):
    """K1's f32 kernel (pipelined FFMA items over the DMMA kernel's units)
    on the nP=57 plans at the RT (64 no²) and FEAST (128 no²) lane
    batches (16-byte stores), the EOM widths and odd ones (staged stores);
    a rerun repeats the bits."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.cast_plan(
        ueg_ladder.build_block_ladder(u, device=device, bra=bra),
        torch.float32)
    nv = u.n_spatial - NO
    Tt = _randn32(np.random.default_rng(N + 1), (nv * nv, N), device)
    before = dict(kernels.LAUNCHES)
    got = k1.block_ladder_cd(plan, Tt)
    again = k1.block_ladder_cd(plan, Tt)
    assert kernels.LAUNCHES["block_ladder_f32"] == \
        before["block_ladder_f32"] + 2
    assert kernels.LAUNCHES["block_ladder"] == before["block_ladder"]
    want = k1.block_ladder_cd(plan, Tt, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and float(want.abs().max()) > 0
    _close32(got, want)


@pytest.mark.parametrize("N", [49, 98])
@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_block_ladder_f32_kernel_np219_widths(device, bra, N):
    """K1's f32 kernel on the nP=219 plans at the mixed CCD's N = no² and
    an EOM batch's 2 no² (two and four bins' worth of items an SM), and
    through the ijab entry (its cd-major copy padded to 16 bytes a row)."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(14)
    plan = ueg_ladder.cast_plan(
        ueg_ladder.build_block_ladder(u, device=device, bra=bra),
        torch.float32)
    nv = u.n_spatial - NO
    rng = np.random.default_rng(N)
    Tt = _randn32(rng, (nv * nv, N), device, 0.01)
    got, again = k1.block_ladder_cd(plan, Tt), k1.block_ladder_cd(plan, Tt)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close32(got, k1.block_ladder_cd(plan, Tt, twin=True))
    T = _randn32(rng, (N // (NO * NO), NO, NO, nv, nv), device, 0.01)
    _close32(ueg_ladder.block_ladder_apply_ij(plan, T[0]),
             ueg_ladder.block_ladder_apply_ij(plan, T[0], twin=True))


@pytest.mark.parametrize("flags", [{"is_only_2b": True},
                                   {"is_only_hermi_2b": True}],
                         ids=lambda f: next(iter(f)))
@pytest.mark.parametrize("N", [49, 6272])
def test_block_ladder_f32_kernel_on_tc_plans(device, N, flags):
    """K1's f32 kernel on the TC sector blocks cast to f32 (the
    non-hermitian virtual plan, the hermitian all-bra one)."""
    u = _tc_model(5)
    plan = ueg_ladder.cast_plan(ueg_ladder.build_block_ladder(
        u, device=device, correlator=u.gaskell,
        bra="virtual" if "is_only_2b" in flags else "all", **flags),
        torch.float32)
    nv = u.n_spatial - NO
    Tt = _randn32(np.random.default_rng(N + 7), (nv * nv, N), device)
    _close32(k1.block_ladder_cd(plan, Tt),
             k1.block_ladder_cd(plan, Tt, twin=True))


def test_sharded_block_ladder_f32_kernel_bit_equal(device):
    """K1's f32 kernel on the sector-sharded all-bra plan cast to f32 (4
    shards of one card, one launch each) equals it on the whole padded
    f32 plan bit for bit, at N = no² (staged stores) and the FEAST lane
    batch 128 no² (16-byte stores): a row's sum runs over k in order
    wherever it lies."""
    from pymes_tpu_torch.parallel import mesh
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    nv = u.n_spatial - NO
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all",
                                         pad_sectors=4)
    sh = ueg_ladder.cast_plan(ueg_ladder.shard_block_ladder(
        plan, mesh.make_mesh(4, device="cuda", devices=[device] * 4)),
        torch.float32)
    p32 = ueg_ladder.cast_plan(plan, torch.float32)
    rng = np.random.default_rng(17)
    T = _randn32(rng, (NO, NO, nv, nv), device)
    Tb = _randn32(rng, (128, nv, nv, NO, NO), device, 0.01)
    kernels.reset_launches()
    for apply, X in ((ueg_ladder.block_ladder_apply_ij, T),
                     (ueg_ladder.block_ladder_apply, Tb)):
        got, want = apply(sh, X), apply(p32, X)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        _close32(got, apply(sh, X, twin=True))
    assert kernels.LAUNCHES["block_ladder_f32"] == 2 * 4 + 2
    assert kernels.LAUNCHES["block_ladder"] == 0


def test_block_ladder_f32_kernel_strided_operand_and_mixed_types(device):
    """A row stride past the width, as the sigma's batch view gives it;
    an f32 operand on an f64 plan is refused."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.build_block_ladder(u, device=device, bra="all")
    nv = u.n_spatial - NO
    Tt = _randn32(np.random.default_rng(3), (nv * nv, 101), device)[:, :98]
    with pytest.raises(TypeError):
        k1.block_ladder_cd(plan, Tt)
    p32 = ueg_ladder.cast_plan(plan, torch.float32)
    _close32(k1.block_ladder_cd(p32, Tt),
             k1.block_ladder_cd(p32, Tt, twin=True))


@pytest.mark.parametrize("ncol", [7, 448, 896, 14])
@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
def test_ovvv_gather_f32_kernel_matches_twin(device, pat, ncol):
    """K4's f32 gather at the dressing's, an EOM batch's and the RT/FEAST
    lane batches' widths (a strided view of Krylov rows): one multiply,
    bit for bit."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
    plan = plan._replace(W=plan.W.float())
    nv = u.n_spatial - NO
    k = ncol // NO
    rows = _randn32(np.random.default_rng(ncol), (k, nv * NO + 3), device)
    T1 = rows[:, :nv * NO].reshape(k, nv, NO)
    before = kernels.LAUNCHES["ovvv_gather_f32"]
    got = k4.ovvv_gather(plan.S, plan.W, T1)
    want = k4.ovvv_gather(plan.S, plan.W, T1, twin=True)
    assert kernels.LAUNCHES["ovvv_gather_f32"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and float(want.abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("ncol", [7, 14, 448])
@pytest.mark.parametrize("cutoff", [14, 2])
def test_ovvv_gather_f32_kernel_np219_widths(device, cutoff, ncol):
    """K4's f32 gather at nP=219 (7 and 14 columns on its planned tiles of
    4 and 7, and 448) and at nP=19 (n = 1008: one short entry tile,
    one-column tiles), on a (nv, no) T1 and a strided batch: bit for
    bit."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    nv = u.n_spatial - NO
    rng = np.random.default_rng(ncol + cutoff)
    k = ncol // NO
    T1 = (_randn32(rng, (nv, NO), device) if k == 1 else
          _randn32(rng, (k, nv * NO + 1), device)[:, :nv * NO].reshape(
              k, nv, NO))
    for pat in ("vvo", "ovv", "vov"):
        plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
        W = plan.W.float()
        got = k4.ovvv_gather(plan.S, W, T1)
        torch.cuda.synchronize()
        assert torch.equal(got, k4.ovvv_gather(plan.S, W, T1, twin=True))


@pytest.mark.parametrize("shape,with_y", K5_SHAPES)
def test_pair_symmetrize_f32_kernel_bit_equal(device, shape, with_y):
    """K5 in f32 at the shapes of the f64 test (its tiles sized in bytes):
    the twin's order, bit for bit."""
    rng = np.random.default_rng(sum(shape) + 2 * with_y)
    X = _randn32(rng, shape, device)
    Y = _randn32(rng, shape, device) if with_y else None
    before = kernels.LAUNCHES["pair_symmetrize_f32"]
    got = pair_sym.pair_symmetrize(X, Y)
    want = pair_sym.pair_symmetrize(X, Y, twin=True)
    assert kernels.LAUNCHES["pair_symmetrize_f32"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(TypeError):
        pair_sym.pair_symmetrize(X, torch.zeros_like(X, dtype=torch.float64))


@pytest.mark.parametrize("R1,n", [(121, 9000), (128, 9000), (21, 70004),
                                  (21, 70001)])
def test_arnoldi_cgs2_f32_kernel_matches_twin(device, R1, n):
    """K7 on an f32 basis (the wide 16-byte copies, and the one-float ones
    where n is odd): the f64 Hessenberg column and the f32 row against the
    twin at m = 1, lanes at uneven m on both sides of 16 (the register
    and the tile paths in one launch), m = R; reruns bit-equal; the f64
    K7 beside it on the same rows, bit-equal on a rerun and within its
    own tolerance; the fused combine."""
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(R1 + n)
    L = 4
    V0, w, lanes = _krylov(rng, L, R1, n, device)
    V64, w64 = V0.float().double(), w.float().double()
    V0, w = V0.float(), w.float()
    for ms in ([1, 1, 1, 1], [1, 7, R1 // 2, R1 - 1], [15, 16, 17, 16],
               [R1 - 1] * 4):
        ms = [min(k, R1 - 1) for k in ms]
        m = torch.as_tensor(ms, device=device)
        Vk, Vk2, Vt = V0.clone(), V0.clone(), V0.clone()
        before = kernels.LAUNCHES["arnoldi_cgs2_f32"]
        hk = arnoldi.arnoldi_cgs2(Vk, w.clone(), lanes, m)
        hk2 = arnoldi.arnoldi_cgs2(Vk2, w.clone(), lanes, m)
        ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
        assert kernels.LAUNCHES["arnoldi_cgs2_f32"] == before + 2
        torch.cuda.synchronize()
        assert hk.dtype == ht.dtype == torch.float64
        assert torch.equal(hk, hk2) and torch.equal(Vk, Vk2)
        err = float((hk - ht).abs().max())
        assert err <= F32_REL * float(ht.abs().max()), err
        _close32(Vk[lanes, m], Vt[lanes, m])
        # only row m of each active lane moved
        Vk[lanes, m] = V0[lanes, m]
        assert torch.equal(Vk, V0)
        # the f64 K7 on the same rows
        before = kernels.LAUNCHES["arnoldi_cgs2"]
        V1, V2, V3 = V64.clone(), V64.clone(), V64.clone()
        h1 = arnoldi.arnoldi_cgs2(V1, w64.clone(), lanes, m)
        h2 = arnoldi.arnoldi_cgs2(V2, w64.clone(), lanes, m)
        h3 = arnoldi.arnoldi_cgs2(V3, w64.clone(), lanes, m, twin=True)
        assert kernels.LAUNCHES["arnoldi_cgs2"] == before + 2
        torch.cuda.synchronize()
        assert torch.equal(h1, h2) and torch.equal(V1, V2)
        _close(h1, h3)
        _close(V1[lanes, m], V3[lanes, m])
    C = _randn(rng, (L, 2, R1), device)
    m = torch.as_tensor([1, R1, 60 % R1 + 1, 17], device=device)
    x0 = _randn32(rng, (L, n), device)
    got = arnoldi.krylov_combine_xr(V0, C, m, lanes, x0=x0)
    again = arnoldi.krylov_combine_xr(V0, C, m, lanes, x0=x0)
    want = arnoldi.krylov_combine_xr(V0, C, m, lanes, x0=x0, twin=True)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close32(a, c)
    for x in (None, x0):
        _close32(arnoldi.krylov_combine(V0, C[:, 0].contiguous(), m, lanes,
                                        x0=x),
                 arnoldi.krylov_combine(V0, C[:, 0].contiguous(), m, lanes,
                                        x0=x, twin=True))


@pytest.mark.parametrize("n,R1", [(4096, 21), (300_001, 21), (245_700, 121)])
def test_arnoldi_cgs2_f32_lane_groups(device, n, R1):
    """Many lanes at uneven m in one wave: 62 lanes of n = 4096 (several a
    block), at 300 001 (odd) and at the FEAST row length a few lanes of
    many blocks, shares crossing lanes; the lanes are a permuted subset of
    the bases.  Each lane against the twin, reruns bit-equal, the rows
    outside untouched."""
    from pymes_tpu_torch.kernels import arnoldi
    rng = np.random.default_rng(n)
    L = 64 if n < 100_000 else 8
    g = torch.Generator(device=device).manual_seed(n)
    V0 = torch.randn((L, R1, n), generator=g, dtype=torch.float32,
                     device=device) / float(np.sqrt(n))
    La = L - 2
    lanes = torch.as_tensor(rng.permutation(L)[:La], device=device)
    m = torch.as_tensor(rng.integers(1, R1, La), device=device)
    w = _randn32(rng, (La, n), device)
    plan = arnoldi.f32_plan(n, La, arnoldi.F32_BLOCKS_PER_SM
                            * torch.cuda.get_device_properties(device)
                            .multi_processor_count)
    # some blocks' shares end one lane and start the next
    assert plan.share % n != 0
    Vk, Vk2, Vt = V0.clone(), V0.clone(), V0.clone()
    hk = arnoldi.arnoldi_cgs2(Vk, w.clone(), lanes, m)
    hk2 = arnoldi.arnoldi_cgs2(Vk2, w.clone(), lanes, m)
    ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
    torch.cuda.synchronize()
    assert torch.equal(hk, hk2) and torch.equal(Vk, Vk2)
    for a in range(La):
        err = float((hk[a] - ht[a]).abs().max())
        assert err <= F32_REL * float(ht[a].abs().max()), (a, err)
    _close32(Vk[lanes, m], Vt[lanes, m])
    Vk[lanes, m] = V0[lanes, m]
    assert torch.equal(Vk, V0)


def test_arnoldi_cgs2_f32_int64_offsets(device):
    """L·(restart+1)·n > 2³¹ floats: the last lane's rows lie past the
    int32 range of elements (8.7 GB of f32 basis)."""
    from pymes_tpu_torch.kernels import arnoldi
    L, R1, n = 2, 121, 9_000_000
    assert L * R1 * n > 2 ** 31
    V = torch.zeros((L, R1, n), dtype=torch.float32, device=device)
    rng = np.random.default_rng(32)
    lanes = torch.as_tensor([1, 0], device=device)
    for mm in (3, 20):
        m = torch.as_tensor([mm, mm], device=device)
        V[:, :mm] = _randn32(rng, (L, mm, n), device) / 3000.0
        w = _randn32(rng, (L, n), device)
        Vt = V[:, :mm + 1].clone()
        hk = arnoldi.arnoldi_cgs2(V, w.clone(), lanes, m)
        ht = arnoldi.arnoldi_cgs2(Vt, w.clone(), lanes, m, twin=True)
        torch.cuda.synchronize()
        err = float((hk[:, :mm + 1] - ht).abs().max())
        assert err <= F32_REL * float(ht.abs().max()), err
        _close32(V[1, mm], Vt[1, mm])
        C = _randn(rng, (L, R1), device)
        _close32(arnoldi.krylov_combine(V, C, m, lanes),
                 arnoldi.krylov_combine(V, C, m, lanes, twin=True))


def test_arnoldi_cgs2_f32_breakdown_row(device):
    """A direction of norm 1e-20 in f32 is zeroed (the f32 guard 1e-18),
    as the twin zeroes it; in f64 the same row is normalised."""
    from pymes_tpu_torch.kernels import arnoldi
    L, R1, n = 2, 5, 4000
    V = _unit_basis(L, R1, n, device)
    w = torch.zeros((1, n), dtype=torch.float64, device=device)
    w[0, 1] = 1e-20
    lanes = torch.as_tensor([1], device=device)
    m = torch.as_tensor([1], device=device)
    for dtype, zero in ((torch.float32, True), (torch.float64, False)):
        Vk, Vt = V.to(dtype), V.to(dtype)
        hk = arnoldi.arnoldi_cgs2(Vk, w.to(dtype), lanes, m)
        ht = arnoldi.arnoldi_cgs2(Vt, w.to(dtype), lanes, m, twin=True)
        torch.cuda.synchronize()
        assert float(hk[0, 1]) == pytest.approx(1e-20, rel=1e-6)
        assert torch.equal(Vk[1, 1], Vt[1, 1])
        assert bool((Vk[1, 1] == 0).all()) == zero


@pytest.mark.parametrize("mode,rt", [("apply", False), ("apply", True),
                                     ("residual", False),
                                     ("residual", True),
                                     ("precond", False), ("precond", True)])
def test_shifted_precond_f32_kernel_matches_twin(device, mode, rt):
    """K8 in f32 (Triton, the element type a constexpr) in every mode."""
    from pymes_tpu_torch.kernels import shifted
    rng = np.random.default_rng(7 + len(mode) + rt)
    La, n1, n2 = 3, 84, 7056
    N = n1 + n2
    X = _randn32(rng, (La, 2 * N), device)
    H1 = _randn32(rng, (2 * La, n1), device)
    H2 = _randn32(rng, (2 * La, n2), device)
    zr = _randn32(rng, (La,), device, 0.1) + 0.5
    zi = _randn32(rng, (La,), device, 0.1) + 0.3
    diag = _randn32(rng, (N,), device) + 1.0
    B = _randn32(rng, (La, 2 * N), device) if mode == "residual" else None
    kw = dict(dt=0.1, rt=rt, mode=mode, B=B)
    before = dict(kernels.LAUNCHES)
    got = shifted.shifted_precond(H1, H2, X, zr, zi, diag, **kw)
    want = shifted.shifted_precond(H1, H2, X, zr, zi, diag, twin=True, **kw)
    assert kernels.LAUNCHES["shifted_precond_f32"] == \
        before["shifted_precond_f32"] + 1
    assert kernels.LAUNCHES["shifted_precond"] == before["shifted_precond"]
    if mode != "residual":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        _close32(a, b)
    with pytest.raises(TypeError):
        shifted.shifted_precond(H1, H2, X.double(), zr, zi, diag, **kw)


def test_mixed_feast_on_card_matches_cpu(device):
    """The mixed engine on the nP=19 no-ovvv operator (MP2 amplitudes):
    card (the f32 K1, K4, K5, K7, K8 and the f64 residual kernels) vs CPU
    (twins), the same roots to 1e-8, every honest residual at
    ls_conv_tol, and every f32 kernel launched."""
    from pymes_tpu_torch.solver import feast_eom_ccsd
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    out = {}
    for dev in (device, torch.device("cpu")):
        d = {k: v.to(dev) for k, v in part_2_body_int(NO, V).items()
             if k not in ("abcd", "abci", "iabc", "aibc", "abic")}
        d["abcd"] = None
        d["abcd_ladder"] = ueg_ladder.build_block_ladder(u, device=dev,
                                                         bra="all")
        d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device=dev)
        f = fock.to(dev)
        eps = torch.diagonal(f)
        _, T2 = mp2.solve(eps[:NO], eps[NO:], d["ijab"], d["abij"], 0.0)
        e0 = float(eom_ccsd.EOM_CCSD(NO, device=dev, n_excit=1).solve(
            f, d, T2)[0])
        kernels.reset_launches()
        s = feast_eom_ccsd.FEAST_EOM_CCSD(NO, device=dev, e_c=e0, e_r=0.3,
                                          n_trial=2, max_iter=3, tol=-1.0,
                                          seed=3, ls_conv_tol=1e-9,
                                          ls_precision="mixed")
        s.ls_restart, s.ls_max_iter, s.ls_refine_max = 40, 4, 8
        out[dev.type] = np.sort_complex(s.solve(f, d, T2))
        assert np.max(s.last_ls_residuals) <= 1e-9
        if dev.type == "cuda":
            launches = dict(kernels.LAUNCHES)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-8)
    for k in ("block_ladder_f32", "ovvv_gather_f32", "pair_symmetrize_f32",
              "arnoldi_cgs2_f32", "shifted_precond_f32", "shifted_precond",
              "block_ladder", "pair_symmetrize"):
        assert launches[k] > 0, launches
    assert launches["arnoldi_cgs2"] == 0


# ---- the f32 instantiations of the ground-state and Davidson precision
# modes (EOM precision="mixed", CCD/CCSD mixed_precision) ----------------

@pytest.mark.parametrize("m", [1, 9, 16])
def test_davidson_residual_f32_kernel_matches_twin(device, m):
    """K6 in f32 (Triton, the element type a constexpr) at the nP=57 EOM
    width with 16 buffer rows and 2 Ritz pairs; a mix of types is
    refused."""
    rng = np.random.default_rng(40 + m)
    nv = 50
    N = nv * NO + nv * nv * NO * NO
    U, W = (_randn32(rng, (16, N), device) for _ in range(2))
    v = _randn32(rng, (16, 2), device)
    e = torch.as_tensor([0.5, 0.7], dtype=torch.float32, device=device)
    diag = _randn32(rng, (N,), device) + 0.6
    before = dict(kernels.LAUNCHES)
    got = davidson.davidson_residual(U, W, v, e, diag, m)
    assert kernels.LAUNCHES["davidson_residual_f32"] == \
        before["davidson_residual_f32"] + 1
    assert kernels.LAUNCHES["davidson_residual"] == \
        before["davidson_residual"]
    _close32(got, davidson.davidson_residual(U, W, v, e, diag, m, twin=True))
    with pytest.raises(TypeError):
        davidson.davidson_residual(U, W.double(), v, e, diag, m)


def _tail_case(rng, device, nv, m=6):
    """nP=57-sized tail operands in f32: (R, T, V, Vx, T1 pieces, eps,
    rings, coefficients)."""
    shape = (NO, NO, nv, nv)
    eps = np.sort(rng.standard_normal(NO + nv))
    return dict(
        R=_randn32(rng, shape, device, 0.01), T=_randn32(rng, shape, device,
                                                          0.01),
        V=_randn32(rng, shape, device), Vx=_randn32(rng, shape, device),
        R1=_randn32(rng, (nv, NO), device, 0.01),
        T1=_randn32(rng, (nv, NO), device, 0.01),
        F1=_randn32(rng, (nv, NO), device),
        eps_i=torch.as_tensor(eps[:NO], dtype=torch.float32, device=device),
        eps_a=torch.as_tensor(eps[NO:], dtype=torch.float32, device=device),
        coeff=_randn32(rng, (m,), device), m=m)


@pytest.mark.parametrize("slot,n_valid,m", [(2, 5, 6), (16, 17, 17)])
def test_ccd_tail_f32_kernels_match_twins(device, slot, n_valid, m):
    """K2/K3 in f32 at the nP=57 T2 (float4 vectors): ring rows bit for bit,
    Gram row, mixed T and energies within 1e-5 of the f32 twins, a second
    launch bit for bit; launches under the _f32 names; a mix of types is
    refused."""
    x = _tail_case(np.random.default_rng(51), device, 50, m)
    n = x["T"].numel()
    rings = _randn32(np.random.default_rng(52), (2, m, n), device, 0.01)
    before = dict(kernels.LAUNCHES)
    _jacobi_runs(lambda e, a, tw: ccd_tail.jacobi_diis_insert(
        x["R"], x["T"], x["eps_i"], x["eps_a"], -1.0, e, a, slot, n_valid,
        twin=tw), (rings[0], rings[1]), "ccd_jacobi_diis_f32", _close32)
    _mix_runs(lambda o, tw: ccd_tail.diis_mix_energy(
        rings[1], x["coeff"], n_valid, o[0], x["V"], x["Vx"], twin=tw),
        (x["T"],), "ccd_mix_energy_f32", _close32)
    assert kernels.LAUNCHES["ccd_jacobi_diis"] == before["ccd_jacobi_diis"]
    with pytest.raises(TypeError):
        ccd_tail.jacobi_diis_insert(x["R"], x["T"], x["eps_i"], x["eps_a"],
                                    -1.0, rings[0].double(), rings[1], 2, 5)


@pytest.mark.parametrize("slot,n_valid,m", [(2, 5, 6), (16, 17, 17)])
def test_ccsd_tail_f32_kernels_match_twins(device, slot, n_valid, m):
    """K2′/K3′ in f32 over [T1 | T2] at nP=57 (N1 = 350: float2 vectors)
    against their f32 twins, as K2/K3; an f64 ring beside f32 amplitudes is
    refused."""
    x = _tail_case(np.random.default_rng(53), device, 50, m)
    n = x["T1"].numel() + x["T"].numel()
    rings = _randn32(np.random.default_rng(54), (2, m, n), device, 0.01)
    before = dict(kernels.LAUNCHES)
    _jacobi_runs(lambda e, a, tw: ccsd_tail.jacobi_diis_insert(
        x["R1"], x["T1"], x["R"], x["T"], x["eps_i"], x["eps_a"], -1.0, e, a,
        slot, n_valid, twin=tw), (rings[0], rings[1]),
        "ccsd_jacobi_diis_f32", _close32)
    _mix_runs(lambda o, tw: ccsd_tail.diis_mix_energy(
        rings[1], x["coeff"], n_valid, o[0], o[1], x["F1"], x["V"],
        x["Vx"], twin=tw), (x["T1"], x["T"]), "ccsd_mix_energy_f32",
        _close32)
    assert kernels.LAUNCHES["ccsd_jacobi_diis"] == \
        before["ccsd_jacobi_diis"]
    with pytest.raises(TypeError):
        ccsd_tail.jacobi_diis_insert(x["R1"], x["T1"], x["R"], x["T"],
                                     x["eps_i"], x["eps_a"], -1.0,
                                     rings[0].double(), rings[1], 2, 5)


@pytest.mark.parametrize("pat,axis", [("vov", 1), ("ovv", 0)])
def test_ovvv_gather_diag_f32_kernel_matches_twin(device, pat, axis):
    """K4's fused G_vv trace in f32 on the nP=57 plans (weights cast):
    within 1e-5 of the f32 twin; f32 T1 on f64 weights is refused."""
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    plan = ueg_ladder.build_ovvv_t1_plan(u, pat, device=device)
    W32 = plan.W.float()
    T1 = _randn32(np.random.default_rng(60 + axis), (u.n_spatial - NO, NO),
                  device, 0.05)
    before = dict(kernels.LAUNCHES)
    got = k4.ovvv_gather_diag(plan.S, W32, T1, axis)
    assert kernels.LAUNCHES["ovvv_gather_diag_f32"] == \
        before["ovvv_gather_diag_f32"] + 1
    assert kernels.LAUNCHES["ovvv_gather_diag"] == before["ovvv_gather_diag"]
    _close32(got, k4.ovvv_gather_diag(plan.S, W32, T1, axis, twin=True))
    with pytest.raises(TypeError):
        k4.ovvv_gather_diag(plan.S, plan.W, T1, axis)


def test_precision_modes_on_card_match_cpu(device):
    """LiH/3-21G on the card against the CPU: CCSD ``mixed_precision``
    (the f32 K2′/K3′ and K5, one each an f32 iteration) within 1e-10 of
    the CPU's, then the mixed EOM on the operator dressed by a tight f64
    CCSD (the f32 K6 and K5 in its seed phase) within 1e-8."""
    import os

    from pymes_tpu_torch.util import fcidump
    n_elec, _, _, _, h, V = fcidump.read(os.path.join(
        os.path.dirname(__file__), "data", "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, torch.as_tensor(h), torch.as_tensor(V))
    out = {}
    for dev in (torch.device("cpu"), device):
        f, Vd = fock.to(dev), torch.as_tensor(V).to(dev)
        kernels.reset_launches()
        s = ccsd.CCSD(no, device=dev)
        mixed = s.solve(f, Vd, mixed_precision=True)
        launches = dict(kernels.LAUNCHES)
        dress = s.solve(f, Vd, delta_e=1e-12, max_iter=200)
        dV = part_2_body_int(no, Vd)
        fd = s.get_T1_dressed_fock(f, dress["t1"], dV)
        Vdr = s.get_T1_dressed_V(dress["t1"], dV,
                                 {k: None for k in ccsd.EOM_DRESSED})
        eom = eom_ccsd.EOM_CCSD(no, device=dev, n_excit=2)
        eom.precision, eom.max_iter = "mixed", 1000
        kernels.reset_launches()
        roots = np.sort(eom.solve(fd, Vdr, dress["t2"]))
        out[dev.type] = (mixed["ccsd e"], dress["ccsd e"], roots)
        if dev.type == "cuda":
            n32, n64 = s.n_iterations_f32, len(mixed["e history"])
            assert {k: launches[k] for k in (
                "ccsd_jacobi_diis_f32", "ccsd_mix_energy_f32",
                "pair_symmetrize_f32", "ccsd_jacobi_diis")} == dict(
                ccsd_jacobi_diis_f32=n32, ccsd_mix_energy_f32=n32,
                pair_symmetrize_f32=n32, ccsd_jacobi_diis=n64)
            assert kernels.LAUNCHES["davidson_residual_f32"] > 0
            assert kernels.LAUNCHES["davidson_residual"] > 0
    (mc, dc, rc), (mg, dg, rg) = out["cpu"], out["cuda"]
    assert abs(mg - mc) <= 1e-10 and abs(dg - dc) <= 1e-10
    assert float(np.abs(rg - rc).max()) <= 1e-8


SCATTER_NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb",
                "ijka", "ijak", "iajk")


def _scatter_list(cutoff):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    return idx, vals, u.n_spatial


@pytest.mark.parametrize("names", [SCATTER_NEED, ("abcd",)],
                         ids=["need", "abcd"])
@pytest.mark.parametrize("cutoff", [2, 5, 14])
def test_block_scatter_kernel_bit_equal(device, cutoff, names):
    from pymes_tpu_torch.kernels import block_scatter as k10

    idx, vals, n_p = _scatter_list(cutoff)
    before = kernels.LAUNCHES["block_scatter"]
    got = ueg.sparse_to_blocks(idx, vals, n_p, NO, device=device, names=names)
    assert kernels.LAUNCHES["block_scatter"] == before + 1
    want = k10.block_scatter(idx, vals, n_p, NO, names, device, twin=True)
    assert kernels.LAUNCHES["block_scatter"] == before + 1
    assert tuple(got) == tuple(want) == names
    for name in names:
        assert got[name].shape == want[name].shape
        assert bool(want[name].any()), name
        _same(got[name], want[name])


def test_block_scatter_kernel_dense_np57(device):
    from pymes_tpu_torch.kernels import block_scatter as k10

    idx, vals, n_p = _scatter_list(5)
    got = ueg.sparse_to_dense(idx, vals, n_p, device=device)
    want = k10.block_scatter(idx, vals, n_p, 0, ("abcd",), device,
                             twin=True)["abcd"]
    assert got.shape == (n_p,) * 4
    _same(got, want)


def test_block_scatter_kernel_empty_and_bad_index(device):
    from pymes_tpu_torch.kernels import block_scatter as k10

    idx, vals, n_p = _scatter_list(2)
    before = kernels.LAUNCHES["block_scatter"]
    got = ueg.sparse_to_blocks(idx[:0], vals[:0], n_p, NO, device=device,
                               names=SCATTER_NEED)
    assert kernels.LAUNCHES["block_scatter"] == before
    for name, block in got.items():
        assert block.device.type == "cuda" and not bool(block.any()), name
    bad = idx.copy()
    bad[3, 2] = n_p
    with pytest.raises(ValueError, match="outside"):
        k10.block_scatter(bad, vals, n_p, NO, SCATTER_NEED, device)
