"""K6: the preconditioned Davidson residual pass, in Triton.

Replaces B9, ``pymes_tpu/solver/eom_ccsd.py:697`` ``_residual_precond``
(run inside ``_davidson_fused_step``, :732):

    R[n, :] = (Σ_l W[l, :] v[l, n] − e_n Σ_l U[l, :] v[l, n]) / c(e_n − diag)

for the k selected Ritz pairs, with the clamp c of the JAX package
(|x| < 1e-5 → ±1e-5 by the sign of x, +1e-5 at 0).  U and W are the
(max_dim, N) Davidson buffers; only their first m rows are valid, and v
(max_dim, k) is zero past them.

What bounds it on an H100: memory bandwidth.  At UEG nP=219 N = 2 203 740,
so the m ≤ 16 valid rows of U and W are up to 564 MB, against k·N·8 bytes
of output and no matrix work worth the tensor cores (K = m ≤ 16).  The
twin makes two skinny GEMMs (each reads its buffer once) and four
elementwise passes over (k, N); the kernel reads each valid row of U and W
once, in one pass: a program owns a column block of N, loops over the m
rows, accumulates Σ U·v and Σ W·v for all k columns in registers, and
writes the k preconditioned residuals.  ``m`` is a runtime argument, so the
zero rows past it are never read.

Every operand is float64, or every one float32 for the f32 seed phase of
the mixed-precision Davidson (``EOM_CCSD.precision="mixed"``,
``pymes_tpu/solver/eom_ccsd.py:969-1002``): the element type is the
kernel's ``DT`` constexpr, and the sums, the clamp and the divide follow
it, as the JAX f32 phase computes them.  The f32 launches count under
``davidson_residual_f32``.  In f32 the pass moves half the bytes: 35·N·4
bytes at nP=219 (m = 16, k = 2).

Triton is imported inside the launching function: the module must import
where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels

BLOCK = 512
CLAMP = 1e-5

_K6 = None


def _kernel():
    global _K6
    if _K6 is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["m"])
        def davidson_residual_kernel(U, W, v, e, diag, clamp, R, N, m, k,
                                     KP: tl.constexpr, BLOCK: tl.constexpr,
                                     DT: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            cmask = offs < N
            kk = tl.arange(0, KP)
            kmask = kk < k
            acc_u = tl.zeros([KP, BLOCK], dtype=DT)
            acc_w = tl.zeros([KP, BLOCK], dtype=DT)
            for l in range(m):
                vl = tl.load(v + l * k + kk, mask=kmask, other=0.0)
                u = tl.load(U + l * N + offs, mask=cmask, other=0.0)
                w = tl.load(W + l * N + offs, mask=cmask, other=0.0)
                acc_u += vl[:, None] * u[None, :]
                acc_w += vl[:, None] * w[None, :]
            en = tl.load(e + kk, mask=kmask, other=0.0)
            dg = tl.load(diag + offs, mask=cmask, other=0.0)
            den = en[:, None] - dg[None, :]
            c = tl.load(clamp)
            den = tl.where(tl.abs(den) < c, tl.where(den < 0, -c, c), den)
            res = (acc_w - en[:, None] * acc_u) / den
            tl.store(R + kk[:, None] * N + offs[None, :], res,
                     mask=kmask[:, None] & cmask[None, :])

        _K6 = davidson_residual_kernel
    return _K6


def davidson_residual_twin(U, W, v, e, diag, m):
    """Plain twin (the JAX algorithm): ``Uv``/``Wv`` as two products over
    the m valid rows, then the clamped denominator and the divide."""
    Uv = v[:m].t() @ U[:m]
    Wv = v[:m].t() @ W[:m]
    denom = e[:, None] - diag[None, :]
    c = torch.full_like(denom, CLAMP)   # denom's type (a bare scalar pair
    #                                     is f32)
    denom = torch.where(denom.abs() < CLAMP, torch.where(denom < 0, -c, c),
                        denom)
    return (Wv - e[:, None] * Uv) / denom


def davidson_residual(U, W, v, e, diag, m: int, twin=False):
    """Preconditioned residuals (k, N) of the k Ritz pairs ``v`` (max_dim,
    k) with values ``e`` (k,) against the H̄ diagonal ``diag`` (N,), reading
    the first ``m`` rows of ``U`` and ``W`` (max_dim, N), all float64 or
    all float32: K6 on a CUDA tensor, the twin on a CPU tensor or with
    ``twin=True``."""
    if not kernels.check_device(U) or twin:
        return davidson_residual_twin(U, W, v, e, diag, m)
    sfx = kernels.type_suffix("the Davidson residual", U, W, v, e, diag)
    for t in (U, W, v, e, diag):
        if not t.is_contiguous():
            raise TypeError("the Davidson residual takes contiguous "
                            "tensors")
    if len({t.device for t in (U, W, v, e, diag)}) != 1:
        raise ValueError("tensors lie on different devices")
    max_dim, N = U.shape
    k = v.shape[1]
    if (W.shape != U.shape or v.shape[0] != max_dim or e.shape != (k,)
            or diag.shape != (N,) or not 0 < m <= max_dim
            or max(max_dim, k) * N >= 2 ** 31):
        raise ValueError("Davidson buffer shapes do not fit the kernel")
    R = torch.empty((k, N), dtype=U.dtype, device=U.device)
    KP = max(1 << (k - 1).bit_length(), 2)
    # the clamp goes in as a tensor of U's type: Triton takes a float
    # literal as f32
    clamp = torch.full((1,), CLAMP, dtype=U.dtype, device=U.device)
    _kernel()[(-(-N // BLOCK),)](U, W, v, e, diag, clamp, R, N, int(m), k,
                                 KP=KP, BLOCK=BLOCK,
                                 DT=kernels.tl_type(U.dtype))
    kernels.LAUNCHES["davidson_residual" + sfx] += 1
    return R
