"""The port's hand-written kernels on the card, each against its plain twin.

K1 (CUDA C++ ladder) and K2/K3 (Triton CCD tail) run only on an NVIDIA
card: these tests carry the ``cuda`` marker and skip where torch sees no
card.  The card has no jax, so this file imports only the port; run it there
without the repository's conftest (which sets up jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: max|kernel − twin| ≤ 1e-12·max|twin| (both f64; only the
summation order differs).
"""

import numpy as np
import pytest
import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import ccd_tail
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccd, mp2

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
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device, names=NEED)
    eps_i = hf.calcOccupiedOrbE(u.kinetic_energies(), d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(u.kinetic_energies(), d["aibj"], d["aijb"],
                               NO, n_p - NO)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=ueg_ladder.build_block_ladder(u, device))
    return u, blocks, eps_i, eps_a


def _randn(rng, shape, device, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           device=device)


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_block_ladder_kernel_matches_twin(device, cutoff, bra):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    plan = ueg_ladder.build_block_ladder(u, device, bra=bra)
    nv = u.n_spatial - NO
    T = _randn(np.random.default_rng(cutoff), (NO, NO, nv, nv), device)
    before = kernels.LAUNCHES["block_ladder"]
    got = ueg_ladder.block_ladder_apply_ij(plan, T)
    assert kernels.LAUNCHES["block_ladder"] == before + 1
    want = ueg_ladder.block_ladder_apply_ij(plan, T, twin=True)
    assert kernels.LAUNCHES["block_ladder"] == before + 1
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("slot,n_valid", [(0, 1), (3, 4), (2, 6)])
def test_jacobi_diis_kernel_matches_twin(device, slot, n_valid):
    _, _, eps_i, eps_a = _problem(2, device)
    rng = np.random.default_rng(slot)
    nv = eps_a.shape[0]
    shape, n = (NO, NO, nv, nv), NO * NO * nv * nv
    R, T = _randn(rng, shape, device), _randn(rng, shape, device)
    ring = (_randn(rng, (6, n), device), _randn(rng, (6, n), device))
    rings = [tuple(r.clone() for r in ring) for _ in range(2)]
    before = kernels.LAUNCHES["ccd_jacobi_diis"]
    rows = [ccd_tail.jacobi_diis_insert(R, T, eps_i, eps_a, -1.0, e, a,
                                        slot, n_valid, twin=tw)
            for (e, a), tw in zip(rings, (False, True))]
    assert kernels.LAUNCHES["ccd_jacobi_diis"] == before + 1
    _close(rows[0], rows[1])
    assert bool((rows[0][n_valid:] == 0).all())
    _close(rings[0][0], rings[1][0])
    _close(rings[0][1], rings[1][1])


@pytest.mark.parametrize("n_valid", [1, 4, 6])
def test_mix_energy_kernel_matches_twin(device, n_valid):
    rng = np.random.default_rng(n_valid)
    nv, n = 12, NO * NO * 12 * 12
    amps = _randn(rng, (6, n), device)
    coeff = _randn(rng, (6,), device)
    V = _randn(rng, (NO, NO, nv, nv), device)
    Vx = V.transpose(2, 3).contiguous()
    Ts = [torch.zeros((NO, NO, nv, nv), dtype=torch.float64, device=device)
          for _ in range(2)]
    before = kernels.LAUNCHES["ccd_mix_energy"]
    es = [ccd_tail.diis_mix_energy(amps, coeff, n_valid, T, V, Vx, twin=tw)
          for T, tw in zip(Ts, (False, True))]
    assert kernels.LAUNCHES["ccd_mix_energy"] == before + 1
    _close(Ts[0], Ts[1])
    for a, b in zip(*es):
        _close(a, b)


def test_solve_on_card_matches_cpu(device):
    """The whole nP=19 solve: card (through the kernels) vs CPU (twins)."""
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
    assert all(launches[k] == n_it for k in launches), launches


def test_kernels_refuse_what_they_do_not_take(device):
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(2)
    plan = ueg_ladder.build_block_ladder(u, device)
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
