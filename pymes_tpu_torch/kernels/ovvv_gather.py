"""K4: the ovvv T1 gather of the matrix-free CCSD dressing, in Triton.

Replaces B4, ``pymes_tpu/ops/ueg_ladder.py:150`` ``ovvv_t1_apply_j``:

    out[j, p, q, r] = W[p, r] · T1[S[p, q, r], j]    (0 where S < 0)

the contraction ``Σ_s V[p,q,r,s] T1[s,j]`` of a momentum-structured block
whose last axis is virtual: momentum conservation fixes s from (p, q, r), so
the nv³·no-sized ovvv blocks never exist.  Each output element is one
masked gather from T1 and one multiply, with no matrix work and no reuse
beyond what L2 gives for free, so a fused elementwise Triton pass serves as
well as CUDA C++ would.

What bounds it on an H100: the output write.  At nP=219 a plan has
n = 212·212·7 ≈ 315 k (p, q, r) entries and the output no·n ≈ 2.2 M f64
(17.6 MB); S (1.3 MB int32) is read once for all j, W[p, r] (0.36 MB) and
T1ᵀ (12 KB) stay in L2.  The design: one program per tile of the flat
(p, q, r) index; it loads S and W once and loops over j inside, so
consecutive threads store consecutive (p, q, r) of out[j, ·].  T1 goes in
as T1ᵀ (no, nv), contiguous, and W as an f64 tensor.  The j loop runs to a
runtime count: the EOM and FEAST sigmas pass a batch of k trials as k·no
columns (896 for 64 FEAST lanes), and a loop unrolled to that many
iterations takes Triton minutes to compile.

Triton is imported inside the launching function: the module must import
where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels

BLOCK = 1024

_K4 = None


def _kernel():
    global _K4
    if _K4 is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["ncol"])
        def ovvv_gather_kernel(S, W, T1t, out, n, n12, n2, nv, ncol,
                               BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            s = tl.load(S + offs, mask=mask, other=-1)
            p = offs // n12
            r = offs % n2
            w = tl.load(W + p * n2 + r, mask=mask, other=0.0)
            live = mask & (s >= 0)
            for j in range(ncol):
                t = tl.load(T1t + j * nv + s, mask=live, other=0.0)
                tl.store(out + j * n + offs, t * w, mask=mask)

        _K4 = ovvv_gather_kernel
    return _K4


def ovvv_gather_twin(S, W, T1):
    """Plain twin (the JAX algorithm): a gather of T1ᵀ columns, a mask and
    a multiply.  Returns (no,) + S.shape."""
    nv, no = T1.shape
    flat = S.clamp(0, nv - 1).reshape(-1).long()
    Tg = T1.t().index_select(1, flat).reshape((no,) + tuple(S.shape))
    Tg = torch.where((S >= 0)[None], Tg, torch.zeros((), dtype=Tg.dtype,
                                                     device=Tg.device))
    return Tg * W[None, :, None, :]


def ovvv_gather(S, W, T1, twin=False):
    """``out[j,p,q,r] = W[p,r] · T1[S[p,q,r], j]`` (0 where S < 0): K4 on a
    CUDA tensor, the twin on a CPU tensor or with ``twin=True``.  ``S``
    (n0, n1, n2) int32, ``W`` (n0, n2) f64, ``T1`` (nv, no) f64."""
    if not kernels.check_device(T1) or twin:
        return ovvv_gather_twin(S, W, T1)
    if T1.dtype != torch.float64 or W.dtype != torch.float64:
        raise TypeError("the ovvv gather takes float64 T1 and weights")
    if S.dtype != torch.int32 or not S.is_contiguous():
        raise TypeError("the ovvv gather takes a contiguous int32 index S")
    if len({S.device, W.device, T1.device}) != 1:
        raise ValueError("plan and T1 lie on different devices")
    n0, n1, n2 = S.shape
    nv, no = T1.shape
    if W.shape != (n0, n2) or no * S.numel() >= 2 ** 31:
        raise ValueError("plan and T1 shapes do not fit the kernel")
    T1t = T1.t().contiguous()
    Wc = W.contiguous()
    out = torch.empty((no, n0, n1, n2), dtype=T1.dtype, device=T1.device)
    n = S.numel()
    _kernel()[(-(-n // BLOCK),)](S, Wc, T1t, out, n, n1 * n2, n2, nv, no,
                                 BLOCK=BLOCK)
    kernels.LAUNCHES["ovvv_gather"] += 1
    return out
