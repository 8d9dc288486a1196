"""K9 wrapper: one step of the ring-accumulated ladder and its plain twin.

Replaces the GEMM of one ring step of B7,
``pymes_tpu/parallel/ring_ladder.py:85-97`` (``_ring_kernel_ij``; the abij
form ``_ring_kernel``, :26-44).  The kernel is CUDA C++ on the f64 tensor
cores (``pymes_tpu_torch/csrc/ring_step.cu``, built with nvcc for sm_90a at
first use); its source says what bounds it and how the design answers.

``ring_step(R, T, V, c0)`` computes ``R += T @ V[:, c0:c0 + K].T`` in place:
``R`` (M, N) and ``T`` (M, K) are 2-D views with any strides (the ijab form
passes row-major views, the abij form the transposed views of its cd-major
tensors), ``V`` the (N, L) row-major matrix of the local V block whose
column window ``[c0, c0 + K)`` is the step's c-panel, read in place.

:func:`plan` chooses the kernel's output tile width and its split of the
contraction for a shape; it is plain Python so that the CPU tests reach it.
"""

import functools
import math

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

BM = 64            # rows of M a block holds (4 m16 DMMA tiles)
TK = 32            # contraction depth of one pipeline stage
TILES_N = (128, 64, 32)
MAX_SPLITS = 8
# blocks an SM holds at each tile width: 4 stages of (TN + 64) x 36 f64
# rows of shared memory (221 KB at 128, 147 KB at 64, 111 KB at 32)
BLOCKS_PER_SM = {128: 1, 64: 1, 32: 2}
# the cost model's H100 rates: HBM (per SM at most ~30 GB/s of 3.0 TB/s
# sustained), L2 to one SM, f64 tensor cores per SM, and the price of the
# second launch that adds the split partials
HBM = 3.0e12
HBM_SM = 3.0e10
L2_SM = 1.0e11
DMMA_SM = 67e12 / 132
REDUCE_S = 5e-6


def stages(K):
    return -(-K // TK)


def split_ranges(K, splits):
    """The contraction ranges [k_begin, k_end) of ``splits`` splits as the
    kernel cuts them: whole stages, ``ceil(stages / splits)`` a split, the
    last one short; empty splits are dropped."""
    sps = -(-stages(K) // splits)
    return [(z * sps * TK, min(K, (z + 1) * sps * TK))
            for z in range(-(-stages(K) // sps))]


@functools.lru_cache(maxsize=64)
def plan(M, N, K, sms):
    """(tile_n, splits) for one launch on ``sms`` SMs: the pair of least
    modelled time, waves x stages per split x time per stage (the larger
    of its DMMA time and its V bytes from HBM plus T bytes from L2), plus
    the reduction launch when there is more than one split.  Ties go to
    the wider tile and the fewer splits."""
    best, best_t = None, math.inf
    for tn in TILES_N:
        cps = BLOCKS_PER_SM[tn]
        tiles = -(-N // tn) * -(-M // BM)
        for s in range(1, min(MAX_SPLITS, stages(K)) + 1):
            nz = len(split_ranges(K, s))
            if nz < s:
                continue
            blocks = tiles * nz
            waves = -(-blocks // (sms * cps))
            per_sm = -(-min(blocks, sms * cps) // sms)
            active = min(blocks, sms)
            hbm = min(HBM / active, HBM_SM)
            t_stage = per_sm * max(2 * BM * tn * TK / DMMA_SM,
                                   tn * TK * 8 / hbm + BM * TK * 8 / L2_SM)
            t = waves * -(-stages(K) // nz) * t_stage
            if nz > 1:
                t += REDUCE_S + 16 * nz * M * N / HBM
            if t < best_t:
                best, best_t = (tn, s), t
    return best


def ring_step_twin(R, T, V, c0):
    """Plain PyTorch twin: ``addmm_`` on the strided panel view."""
    K = T.shape[1]
    return R.addmm_(T, V[:, c0:c0 + K].t())


def ring_step_kernel(R, T, V, c0):
    """Launch K9 on CUDA f64 tensors of one device; returns ``R``."""
    M, K = T.shape
    N, L = V.shape
    if not (R.dtype == T.dtype == V.dtype == torch.float64):
        raise TypeError("the ring-step kernel takes float64 operands")
    if not (R.device == T.device == V.device):
        raise ValueError("R, T and V lie on different devices")
    if R.dim() != 2 or tuple(R.shape) != (M, N):
        raise ValueError(f"R of shape {tuple(R.shape)} does not fit T "
                         f"{tuple(T.shape)} and V {tuple(V.shape)}")
    if V.stride(1) != 1 or V.stride(0) < L:
        raise ValueError("V must be row-major with unit column stride")
    if not 0 <= c0 <= L - K:
        raise ValueError(f"panel [{c0}, {c0 + K}) outside V's {L} columns")
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("dimensions past int32")
    lib = _build.library()
    dev = R.device
    tile_n, splits = plan(M, N, K, _build.sm_count(dev))
    # several splits (the plan leaves none empty) write their partial sums
    # to scratch, which a second launch adds into R in split order
    W = torch.empty(splits * M * N, dtype=R.dtype, device=dev) \
        if splits > 1 else None
    args = (T.data_ptr(), T.stride(0), T.stride(1),
            V.data_ptr() + 8 * c0, V.stride(0), R.data_ptr(), R.stride(0),
            R.stride(1), M, N, K, tile_n, splits,
            None if W is None else W.data_ptr())
    rc = _build.launch(dev, lib.pymes_ring_step, *args)
    if rc != 0:
        raise RuntimeError(f"ring_step launch failed: cudaError {rc}")
    kernels.LAUNCHES["ring_step"] += 1
    return R


def ring_step(R, T, V, c0, twin=False):
    """``R += T @ V[:, c0:c0 + K].T`` in place: K9 for CUDA tensors, the
    twin for CPU tensors (or with ``twin=True``, which the on-card
    comparisons use)."""
    if kernels.check_device(R) and not twin:
        return ring_step_kernel(R, T, V, c0)
    return ring_step_twin(R, T, V, c0)
