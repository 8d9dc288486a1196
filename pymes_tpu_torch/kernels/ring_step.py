"""K9 wrapper: one step of the ring-accumulated ladder and its plain twin.

Replaces the GEMM of one ring step of B7,
``pymes_tpu/parallel/ring_ladder.py:85-97`` (``_ring_kernel_ij``; the abij
form ``_ring_kernel``, :26-44).  The kernel is CUDA C++
(``pymes_tpu_torch/csrc/ring_step.cu``, built with nvcc for sm_90a at first
use); its source says what bounds it and how the design answers.

``ring_step(R, T, V, c0)`` computes ``R += T @ V[:, c0:c0 + K].T`` in place:
``R`` (M, N) and ``T`` (M, K) are 2-D views with any strides (the ijab form
passes row-major views, the abij form the transposed views of its cd-major
tensors), ``V`` the (N, L) row-major matrix of the local V block whose
column window ``[c0, c0 + K)`` is the step's c-panel, read in place.
"""

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build


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
    with torch.cuda.device(R.device):
        # the kernel splits K over several blocks when the output tiles
        # alone would leave SMs idle; the splits' partial sums go to scratch
        splits = lib.pymes_ring_step_splits(M, N, K)
        W = (torch.empty(splits * M * N, dtype=R.dtype, device=R.device)
             if splits > 1 else None)
        rc = lib.pymes_ring_step(
            T.data_ptr(), T.stride(0), T.stride(1), V[:, c0:].data_ptr(),
            V.stride(0), R.data_ptr(), R.stride(0), R.stride(1), M, N, K,
            splits, None if W is None else W.data_ptr(),
            torch.cuda.current_stream(R.device).cuda_stream)
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
