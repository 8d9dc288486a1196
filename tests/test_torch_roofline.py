"""The port's FLOP and roofline accounting (``util/flops.py``,
``util/roofline.py``) against the JAX package's on the same UEG plans, and
the H100 bounds that ``chip_smoke.py`` reports against hand-computed
numbers.

Tolerances: FLOP counts exactly (integers); bounds to 1e-12 relative.
"""

import pytest

from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.util import flops as jflops
from pymes_tpu.util import roofline as jroofline
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.util import flops, roofline

NO = 7


def _plans(cutoff, bra):
    uj, ut = jueg.UEG(14, NO, NO, 0.5), ueg.UEG(14, NO, NO, 0.5)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    return (jladder.build_block_ladder(uj, bra=bra, preslice=None),
            ueg_ladder.build_block_ladder(ut, "cpu", bra=bra),
            ut.n_spatial - NO)


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_flop_counts_equal_jax(cutoff, bra):
    pj, pt, nv = _plans(cutoff, bra)
    assert roofline.block_ladder_gemm_dims(pt) == \
        jroofline.block_ladder_gemm_dims(pj)
    assert roofline.block_ladder_flops(pt, NO * NO) == \
        jroofline.block_ladder_flops(pj, NO * NO)
    assert flops.block_ladder_flops(pt, NO) == \
        jflops.block_ladder_flops(pj, NO)
    assert flops.block_ladder_flops(pt, NO) == \
        roofline.block_ladder_flops(pt, NO * NO)
    assert flops.ccd_ij_iteration_flops(NO, nv, pt) == \
        jflops.ccd_ij_iteration_flops(NO, nv, pj)
    assert flops.ccd_ij_iteration_flops(NO, nv) == \
        jflops.ccd_ij_iteration_flops(NO, nv)
    assert flops.ccsd_ij_iteration_flops(NO, nv, pt) == \
        jflops.ccsd_ij_iteration_flops(NO, nv, pj)
    lf = roofline.block_ladder_flops(pt, NO * NO)
    for is_dcd in (False, True):
        assert roofline.ccd_iteration_flops(NO, nv, lf, is_dcd) == \
            jroofline.ccd_iteration_flops(NO, nv, lf, is_dcd)
    assert roofline.dense_ladder_flops(NO, nv) == \
        jroofline.dense_ladder_flops(NO, nv)
    assert lf < roofline.dense_ladder_flops(NO, nv)
    assert flops.achieved_tflops(4e12, 2.0) == \
        jflops.achieved_tflops(4e12, 2.0) == 2.0


def test_bound_hand_computed():
    # 3.35e9 bytes at 3.35 TB/s: 1 ms; 67e9 f64 flops at 67 TFLOP/s: 1 ms
    assert roofline.bound(3.35e9, 0) == (pytest.approx(1.0, rel=1e-12),
                                         "bytes")
    assert roofline.bound(0, 67e9) == (pytest.approx(1.0, rel=1e-12),
                                       "operations")
    t, by = roofline.bound(3.35e9, 2 * 67e9)
    assert (t, by) == (pytest.approx(2.0, rel=1e-12), "operations")
    # the CUDA-core FMA rate, about half the tensor-core rate
    t, by = roofline.bound(0, 34e9, flops_s=roofline.FP64_FMA_FLOPS_S)
    assert (t, by) == (pytest.approx(1.0, rel=1e-12), "operations")
    assert roofline.FP64_FMA_FLOPS_S / roofline.FP64_TENSOR_FLOPS_S == \
        pytest.approx(34 / 67)
    # K9 at the nP=219 ring step (M, N, K) = (49, 11236, 11236)
    ring = {"M": 49, "N": 11236, "K": 11236}
    nbytes = 8 * (11236 * 11236 + 49 * 11236 + 2 * 49 * 11236)
    assert roofline.ring_bound(ring) == (
        pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12), "bytes")
    # K7 at the FEAST nP=57 lane shape: 64 lanes, m = 60, n = 245 700
    kb = roofline.krylov_bounds(64, 60, 245700)
    assert kb["bound"][0] == pytest.approx(
        8 * (64 * 60 * 245700 + 2 * 64 * 245700) / 3.35e12 * 1e3, rel=1e-12)
    assert kb["floor_ms"] == pytest.approx(
        8 * 245700 * 64 * (3 * 60 + 5) / 3.35e12 * 1e3, rel=1e-12)


def test_report_states_h100_share():
    line = roofline.report("x", 0.002, 67e9)
    assert line.startswith("x: 2.000 ms, 33.500 f64 TFLOP/s = 50.00% of")
    assert "H100 FP64 tensor-core peak" in line


def test_kernel_bounds_from_plans():
    """The helpers behind chip_smoke's kernels line on a cutoff-2 problem,
    against the bytes counted by hand: K1's ladder (tensor cores), K4's
    gather and trace (CUDA cores) are all bound by bytes there."""
    ut = ueg.UEG(14, NO, NO, 0.5)
    ut.init_single_basis(2)
    nv = ut.n_spatial - NO
    plan = ueg_ladder.build_block_ladder(ut, "cpu")
    plans = ueg_ladder.build_ovvv_plans(ut, "cpu")
    pk = plan.packed
    assert roofline.ladder_bound(plan, 49) == (pytest.approx(
        (8 * (nv * nv * 49 + pk.n_rows * 49 + pk.blocks.numel())
         + 4 * (pk.perm.numel() + pk.bra_of_row.numel())) / 3.35e12 * 1e3,
        rel=1e-12), "bytes")
    for p in plans.values():
        n = p.S.numel()
        assert roofline.gather_bound(p, nv, NO) == (pytest.approx(
            (4 * n + 8 * p.W.numel() + 8 * nv * NO + 8 * NO * n) / 3.35e12
            * 1e3, rel=1e-12), "bytes")
        assert roofline.diag_bound(p, nv, NO) == (pytest.approx(
            (4 * n + 8 * p.W.numel() + 8 * nv * NO + 8 * nv * nv) / 3.35e12
            * 1e3, rel=1e-12), "bytes")


def test_cuda_core_helpers_use_the_fma_rate(monkeypatch):
    """With the HBM rate made endless, the K4 and K7 helpers are bound by
    operations at the CUDA-core FMA rate, K1 and K9 at the tensor-core
    rate."""
    monkeypatch.setattr(roofline, "HBM_BYTES_S", float("inf"))
    ut = ueg.UEG(14, NO, NO, 0.5)
    ut.init_single_basis(2)
    nv = ut.n_spatial - NO
    plan = ueg_ladder.build_block_ladder(ut, "cpu")
    ovvv = next(iter(ueg_ladder.build_ovvv_plans(ut, "cpu").values()))
    fma, tc = roofline.FP64_FMA_FLOPS_S, roofline.FP64_TENSOR_FLOPS_S
    n = ovvv.S.numel()
    assert roofline.gather_bound(ovvv, nv, NO) == (
        pytest.approx(NO * n / fma * 1e3, rel=1e-12), "operations")
    assert roofline.diag_bound(ovvv, nv, NO) == (
        pytest.approx(2 * n / fma * 1e3, rel=1e-12), "operations")
    kb = roofline.krylov_bounds(4, 3, 100)
    assert kb["bound"] == (pytest.approx(8 * 4 * 3 * 100 / fma * 1e3,
                                         rel=1e-12), "operations")
    assert kb["combine"] == (pytest.approx(4 * 4 * 3 * 100 / fma * 1e3,
                                           rel=1e-12), "operations")
    assert roofline.ladder_bound(plan, 49) == (pytest.approx(
        2 * plan.packed.blocks.numel() * 49 / tc * 1e3, rel=1e-12),
        "operations")
    assert roofline.ring_bound({"M": 2, "N": 3, "K": 5}) == (
        pytest.approx(2 * 2 * 3 * 5 / tc * 1e3, rel=1e-12), "operations")


def test_f32_bounds_count_four_bytes_and_the_fp32_rate(monkeypatch):
    """The f32 kernels of the mixed-precision engine: the helpers count 4
    bytes an element (K7's f32 floor is half its f64 one) and K1's and
    K4's f32 operations at the 67 TFLOP/s FP32 CUDA-core rate; K7 sums an
    f32 basis in f64, so its operations stay at the FP64 FMA rate."""
    assert roofline.FP32_FMA_FLOPS_S == 67e12
    kb8 = roofline.krylov_bounds(64, 60, 245700)
    kb4 = roofline.krylov_bounds(64, 60, 245700, elem=4)
    assert kb4["floor_ms"] == pytest.approx(kb8["floor_ms"] / 2, rel=1e-12)
    assert kb4["bound"][0] == pytest.approx(kb8["bound"][0] / 2, rel=1e-12)
    ut = ueg.UEG(14, NO, NO, 0.5)
    ut.init_single_basis(2)
    nv = ut.n_spatial - NO
    plan = ueg_ladder.build_block_ladder(ut, "cpu")
    ovvv = next(iter(ueg_ladder.build_ovvv_plans(ut, "cpu").values()))
    pk, n = plan.packed, ovvv.S.numel()
    assert roofline.ladder_bound(plan, 49, elem=4) == (pytest.approx(
        (4 * (nv * nv * 49 + pk.n_rows * 49 + pk.blocks.numel())
         + 4 * (pk.perm.numel() + pk.bra_of_row.numel())) / 3.35e12 * 1e3,
        rel=1e-12), "bytes")
    assert roofline.gather_bound(ovvv, nv, NO, elem=4) == (pytest.approx(
        (4 * n + 4 * (ovvv.W.numel() + nv * NO + NO * n)) / 3.35e12 * 1e3,
        rel=1e-12), "bytes")
    monkeypatch.setattr(roofline, "HBM_BYTES_S", float("inf"))
    fp32, fma = roofline.FP32_FMA_FLOPS_S, roofline.FP64_FMA_FLOPS_S
    assert roofline.gather_bound(ovvv, nv, NO, elem=4) == (
        pytest.approx(NO * n / fp32 * 1e3, rel=1e-12), "operations")
    assert roofline.ladder_bound(plan, 49, elem=4, flops_s=fp32)[0] == \
        pytest.approx(2 * pk.blocks.numel() * 49 / fp32 * 1e3, rel=1e-12)
    assert roofline.krylov_bounds(4, 3, 100, elem=4)["bound"] == (
        pytest.approx(8 * 4 * 3 * 100 / fma * 1e3, rel=1e-12), "operations")
