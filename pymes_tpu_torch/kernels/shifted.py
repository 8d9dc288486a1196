"""K8: the shifted-operator assembly and diagonal preconditioner, in Triton.

Replaces B6′, the matvec and preconditioner of one contour node,
``pymes_tpu/solver/feast_eom_ccsd.py:67-106`` ``_node_ops``, and the
honest-residual pass ``_residual_impl`` (:360-391).  A complex system is
kept in its real embedding, the (Re x, Im x) pair of length 2N, and the
real H̄ is applied to Re x and Im x as two rows of one batched sigma.  From
that sigma output (hr, hi), the pair (xr, xi), the lane's shift
z = zr + i·zi and the H̄ diagonal, one pass over (La, N) computes one of

* FEAST  ``M(z x − H x)``, with M = 1/(z − diag + 0.01);
* RT     ``M(z x − i·dt·H x)``, with M = 1/(z + 0.01 − i·dt·diag);
* residual mode ``r = b − (z − H)x`` (or the RT operator) and per-lane
  partial sums of ‖r‖² and ‖b‖², no preconditioner;
* preconditioner mode ``M x`` alone (the first ``Mb`` of a GMRES solve and
  the Richardson update), no sigma.

What bounds it on an H100: memory bandwidth — per element it reads hr,
hi, xr, xi (and br, bi in residual mode) and writes the pair, with ~20
flops.  The JAX package materialises the preconditioner planes m_r, m_i
(2·L·N·8 bytes, 1 GB at nP=123 with 32 lanes) and applies the operator
and M in separate passes; here M is recomputed in registers from z and
the diagonal (one (N,) read shared by all lanes, from L2), so the pass
moves 4 (La, N) planes in and 2 out.  The sigma's output is read in place
as its singles and doubles parts, so it is never concatenated.  The formulas
are the JAX package's, in its order; the twin materialises them as the
JAX package does.  Triton is imported inside the launching function: the
module must import where there is no Triton.

Every operand is float64, or every one float32 for the f32 Krylov solves
of the FEAST/RT mixed-precision engine: the element type is the kernel's
``DT`` constexpr, and everything follows it, the shift and dt constants and
the residual mode's norm sums included, as the JAX f32 solve computes them
(its f32 Richardson takes its ‖b − A x‖ in f32).
"""

import torch

from pymes_tpu_torch import kernels

BLOCK = 1024
RED_ROWS = 32  # partials a row-sum step adds
SHIFT = 0.01   # feast_eom_ccsd.py:96-99, the preconditioner's real shift
MODES = ("apply", "residual", "precond")

_K8 = None
_ROW_SUM = None


def _kernel():
    global _K8
    if _K8 is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["N", "n1", "nblk"])
        def shifted_kernel(H1, H2, X, B, zr_p, zi_p, diag, consts, out, P,
                           N, n1, nblk, RT: tl.constexpr, MODE: tl.constexpr,
                           BLOCK: tl.constexpr, DT: tl.constexpr):
            pid = tl.program_id(0).to(tl.int64)
            a = tl.program_id(1).to(tl.int64)
            offs = pid * BLOCK + tl.arange(0, BLOCK).to(tl.int64)
            mask = offs < N
            zr = tl.load(zr_p + a)
            zi = tl.load(zi_p + a)
            dt = tl.load(consts).to(DT)
            xr = tl.load(X + a * 2 * N + offs, mask=mask, other=0.0)
            xi = tl.load(X + a * 2 * N + N + offs, mask=mask, other=0.0)
            if MODE == 2:
                ar = xr
                ai = xi
            else:
                # H x of rows 2a (Re) and 2a+1 (Im), read from the sigma's
                # singles (n1 columns) or doubles (N − n1 columns) part
                n2 = N - n1
                s1 = mask & (offs < n1)
                s2 = mask & (offs >= n1)
                hr = (tl.load(H1 + 2 * a * n1 + offs, mask=s1, other=0.0)
                      + tl.load(H2 + 2 * a * n2 + offs - n1, mask=s2,
                                other=0.0))
                hi = (tl.load(H1 + (2 * a + 1) * n1 + offs, mask=s1,
                              other=0.0)
                      + tl.load(H2 + (2 * a + 1) * n2 + offs - n1, mask=s2,
                                other=0.0))
                if RT:
                    ar = zr * xr - zi * xi + dt * hi
                    ai = zr * xi + zi * xr - dt * hr
                else:
                    ar = zr * xr - zi * xi - hr
                    ai = zr * xi + zi * xr - hi
            if MODE == 1:
                br = tl.load(B + a * 2 * N + offs, mask=mask, other=0.0)
                bi = tl.load(B + a * 2 * N + N + offs, mask=mask, other=0.0)
                rr = br - ar
                ri = bi - ai
                tl.store(out + a * 2 * N + offs, rr, mask=mask)
                tl.store(out + a * 2 * N + N + offs, ri, mask=mask)
                # partials of ‖r‖² (row 2a) and ‖b‖² (row 2a + 1)
                tl.store(P + 2 * a * nblk + pid,
                         tl.sum(rr * rr + ri * ri, axis=0).to(DT))
                tl.store(P + (2 * a + 1) * nblk + pid,
                         tl.sum(br * br + bi * bi, axis=0).to(DT))
            else:
                # the shift 0.01 comes in as DT (a float literal is f32)
                eps = tl.load(consts + 1).to(DT)
                dg = tl.load(diag + offs, mask=mask, other=0.0)
                if RT:
                    den_r = tl.zeros_like(dg) + (zr + eps)
                    den_i = zi - dt * dg
                else:
                    den_r = zr - dg + eps
                    den_i = tl.zeros_like(dg) + zi
                den2 = den_r * den_r + den_i * den_i
                m_r = den_r / den2
                m_i = -den_i / den2
                tl.store(out + a * 2 * N + offs, m_r * ar - m_i * ai,
                         mask=mask)
                tl.store(out + a * 2 * N + N + offs, m_r * ai + m_i * ar,
                         mask=mask)

        _K8 = shifted_kernel
    return _K8


def _row_sum_kernel():
    global _ROW_SUM
    if _ROW_SUM is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["nch"])
        def row_sum_kernel(P, out, nch, RC: tl.constexpr,
                           DT: tl.constexpr):
            # out[a] = Σ_c P[a, c], RC partials a step in chunk order, in
            # the partials' type DT
            a = tl.program_id(0).to(tl.int64)
            acc = tl.zeros([RC], dtype=DT)
            for c0 in range(0, nch, RC):
                r = c0 + tl.arange(0, RC).to(tl.int64)
                acc += tl.load(P + a * nch + r, mask=r < nch, other=0.0)
            tl.store(out + a, tl.sum(acc, axis=0))

        _ROW_SUM = row_sum_kernel
    return _ROW_SUM


def row_sums(P):
    """Σ over the columns of each row of the partials P (La, nch) in a
    fixed order (the residual mode's norms), on the card."""
    La, nch = P.shape
    out = torch.empty((La,), dtype=P.dtype, device=P.device)
    _row_sum_kernel()[(La,)](P, out, nch, RC=RED_ROWS,
                             DT=kernels.tl_type(P.dtype))
    return out


def _planes(H1, H2, La):
    hs = torch.cat([H1, H2], dim=1).view(La, 2, -1)
    return hs[:, 0], hs[:, 1]


def shifted_precond_twin(H1, H2, X, zr, zi, diag, dt=0.0, rt=False,
                         mode="apply", B=None):
    """Plain twin: the JAX package's ``_node_ops`` matvec and
    preconditioner (``feast_eom_ccsd.py:67-106``) with the preconditioner
    planes materialised, and its residual (:383-388)."""
    La, N = X.shape[0], X.shape[1] // 2
    xr, xi = X[:, :N], X[:, N:]
    zr, zi = zr[:, None], zi[:, None]
    if mode == "precond":
        ar, ai = xr, xi
    else:
        hr, hi = _planes(H1, H2, La)
        if rt:
            ar, ai = zr * xr - zi * xi + dt * hi, zr * xi + zi * xr - dt * hr
        else:
            ar, ai = zr * xr - zi * xi - hr, zr * xi + zi * xr - hi
    if mode == "residual":
        br, bi = B[:, :N], B[:, N:]
        rr, ri = br - ar, bi - ai
        res = torch.sqrt((rr * rr).sum(dim=1) + (ri * ri).sum(dim=1))
        bnorm = torch.sqrt((br * br).sum(dim=1) + (bi * bi).sum(dim=1))
        return torch.cat([rr, ri], dim=1), res, bnorm
    if rt:
        den_r = (zr + SHIFT).expand(La, N)
        den_i = zi - dt * diag[None, :]
    else:
        den_r = zr - diag[None, :] + SHIFT
        den_i = zi.expand(La, N)
    den2 = den_r ** 2 + den_i ** 2
    m_r, m_i = den_r / den2, -den_i / den2
    return torch.cat([m_r * ar - m_i * ai, m_r * ai + m_i * ar], dim=1)


def shifted_precond(H1, H2, X, zr, zi, diag, dt=0.0, rt=False, mode="apply",
                    B=None, twin=False):
    """One K8 pass over the La active lanes.  ``X`` (La, 2N) holds each
    lane's (Re, Im) pair; ``H1`` (2La, n1) and ``H2`` (2La, N − n1) the
    singles and doubles of the sigma of the rows (Re_0, Im_0, Re_1, ...);
    ``zr``, ``zi`` (La,) the shifts; ``diag`` (N,) the H̄ diagonal; ``dt``
    the RT step (``rt=True``).  ``mode``: "apply" → M(A x) (La, 2N);
    "precond" → M x (H1/H2 unused); "residual" → (b − A x, ‖b − A x‖,
    ‖b‖) with ``B`` (La, 2N).  All float64 or all float32.  K8 on a CUDA
    tensor, the twin on a CPU tensor or with ``twin=True``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if not kernels.check_device(X) or twin:
        return shifted_precond_twin(H1, H2, X, zr, zi, diag, dt, rt, mode, B)
    La, N = X.shape[0], X.shape[1] // 2
    ts = [X, zr, zi, diag] + ([] if mode == "precond" else [H1, H2]) \
        + ([B] if mode == "residual" else [])
    sfx = kernels.type_suffix("K8", *ts)
    for t in ts:
        if not t.is_contiguous():
            raise TypeError("K8 takes contiguous tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("tensors lie on different devices")
    n1 = N if mode == "precond" else H1.shape[1]
    if (X.shape[1] != 2 * N or zr.shape != (La,) or zi.shape != (La,)
            or diag.shape != (N,)
            or (mode != "precond" and (H1.shape != (2 * La, n1)
                                       or H2.shape != (2 * La, N - n1)))
            or (mode == "residual" and B.shape != X.shape)):
        raise ValueError("K8 operand shapes do not fit")
    if mode == "precond":
        H1 = H2 = X
    nblk = -(-N // BLOCK)
    out = torch.empty_like(X)
    P = torch.empty((2 * La, nblk) if mode == "residual" else (1,),
                    dtype=X.dtype, device=X.device)
    consts = torch.tensor([float(dt), SHIFT], dtype=X.dtype, device=X.device)
    _kernel()[(nblk, La)](H1, H2, X, X if B is None else B, zr, zi, diag,
                          consts, out, P, N, n1, nblk, RT=bool(rt),
                          MODE=MODES.index(mode), BLOCK=BLOCK,
                          DT=kernels.tl_type(X.dtype))
    kernels.LAUNCHES["shifted_precond" + sfx] += 1
    if mode != "residual":
        return out
    sums = row_sums(P)
    return out, torch.sqrt(sums[0::2]), torch.sqrt(sums[1::2])
