"""K7: the CGS2 Arnoldi projection and the Krylov row combines, in Triton.

Replaces B6, the body of ``pymes_tpu/ops/gmres.py:87-131`` ``gmres``
(the projection at :101-108) and its two Krylov combines, the solution
update ``x = x0 + Σ y_i V_i`` (:162) and the reconstructed restart residual
``Σ u_i V_i`` (:179), for L independent GMRES systems ("lanes") at once.
For each active lane a with ``m_a`` valid basis rows V[ℓ_a, :m_a]:

    h = V w;  w ← w − Vᵀh;  h += V w;  w ← w − Vᵀ(V w);  ‖w‖

then the new row V[ℓ_a, m_a] = w/‖w‖, or zero when ‖w‖ ≤ 1e-140 (the JAX
``_BREAK`` guard: a near-zero direction is noise and must not be
normalised).  The returned Hessenberg column is (h₁ + h₂, ‖w‖) in rows
0..m_a, zero past them.

What bounds it on an H100: memory bandwidth.  The Krylov basis is
(L, restart+1, 2N) f64 — 15.2 GB at UEG nP=57 with 64 lanes of GMRES(120)
— and CGS2 has to read the m valid rows three times (each pass needs the
finished sums of the one before), against ~4 flops per element read: far
below the tensor-core balance point, and the product is too skinny
(K = m ≤ 121) for them anyway.  The design reads only what it must:

* only the m_a valid rows; ``m`` is a per-lane runtime tensor (not
  specialised), so one compile serves every Arnoldi step.  The JAX version
  reads all restart+1 rows and relies on the rows past j being zero; here
  the stale rows of earlier cycles are never read, so nothing is zeroed;
* three passes over V.  A program owns a chunk of columns of one lane and
  holds, per sub-block, the whole [RP, SUB] tile of valid rows in
  registers, so each pass reads each valid element once:
  (1) partial V·w; (2) w₁ = w − Vᵀh₁ (stored in place of w) fused with the
  partial V·w₁; (3) w₂ = w₁ − Vᵀh₂ stored into row m, fused with the
  partial ‖w₂‖²;
* the per-chunk partials are reduced between passes by a small kernel in a
  fixed order, with no atomics, so reruns give the same bits;
* all offsets are int64: L·(restart+1)·2N is 1.90e9 at nP=57 with 64
  lanes, 94 % of the int32 range.

``krylov_combine`` is the same tile walk once: x0 + Σ_{i<m} c_i V_i per
lane.  The twins (``*_twin``) loop over the lanes with ``torch.mv``
products in the JAX order; a lane's twin result does not depend on the
other lanes, so the lane-batched GMRES on the CPU equals one-lane solves
bit for bit.  Triton is imported inside the launching function: the module
must import where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels

BREAK = 1e-140     # ops/gmres.py:69, the f64 breakdown guard
SUB_ELEMS = 4096   # elements of one [RP, SUB] register tile
CHUNK = 2048       # columns of one program
RED_ROWS = 32      # partial rows reduced per step

_K7 = None


def _kernels():
    global _K7
    if _K7 is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["n", "nch"])
        def proj_kernel(V, W, lanes, m, Hin, P, n, stride_lane, nch,
                        PASS: tl.constexpr, RP: tl.constexpr,
                        SUB: tl.constexpr, NSUB: tl.constexpr):
            c = tl.program_id(0).to(tl.int64)
            a = tl.program_id(1).to(tl.int64)
            lane = tl.load(lanes + a)
            mm = tl.load(m + a)
            rows = tl.arange(0, RP).to(tl.int64)
            rmask = rows < mm
            vbase = V + lane * stride_lane
            wbase = W + a * n
            h = tl.zeros([RP], dtype=tl.float64)
            if PASS > 0:
                h = tl.load(Hin + a * RP + rows, mask=rmask, other=0.0)
            acc = tl.zeros([RP], dtype=tl.float64)
            nacc = tl.zeros([SUB], dtype=tl.float64)
            for s in range(NSUB):
                cols = (c * NSUB + s) * SUB + tl.arange(0, SUB).to(tl.int64)
                cmask = cols < n
                w = tl.load(wbase + cols, mask=cmask, other=0.0)
                tile = tl.load(vbase + rows[:, None] * n + cols[None, :],
                               mask=rmask[:, None] & cmask[None, :],
                               other=0.0)
                if PASS == 0:
                    acc += tl.sum(tile * w[None, :], axis=1)
                elif PASS == 1:
                    w = w - tl.sum(tile * h[:, None], axis=0)
                    tl.store(wbase + cols, w, mask=cmask)
                    acc += tl.sum(tile * w[None, :], axis=1)
                else:
                    w = w - tl.sum(tile * h[:, None], axis=0)
                    tl.store(vbase + mm * n + cols, w, mask=cmask)
                    nacc += w * w
            if PASS == 2:
                tl.store(P + a * nch + c, tl.sum(nacc, axis=0))
            else:
                tl.store(P + (a * nch + c) * RP + rows, acc)

        @triton.jit(do_not_specialize=["nch"])
        def reduce_kernel(P, Hprev, Hout, Hsum, nch, RP: tl.constexpr,
                          RC: tl.constexpr, ACC: tl.constexpr):
            # Hout[a] = Σ_c P[a, c, :] in chunk order; with ACC also
            # Hsum[a] = Hprev[a] + Hout[a] (h = h₁ + h₂, the JAX order)
            a = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, RP)
            acc = tl.zeros([RP], dtype=tl.float64)
            for c0 in range(0, nch, RC):
                r = c0 + tl.arange(0, RC).to(tl.int64)
                tile = tl.load(P + (a * nch + r[:, None]) * RP + cols[None, :],
                               mask=(r < nch)[:, None], other=0.0)
                acc += tl.sum(tile, axis=0)
            tl.store(Hout + a * RP + cols, acc)
            if ACC:
                prev = tl.load(Hprev + a * RP + cols)
                tl.store(Hsum + a * RP + cols, prev + acc)

        @triton.jit(do_not_specialize=["nch"])
        def norm_kernel(P, m, H, nch, RP: tl.constexpr, RC: tl.constexpr,
                        SQRT: tl.constexpr):
            # H[a, m_a] = Σ_c P[a, c] in chunk order (its sqrt with SQRT)
            a = tl.program_id(0).to(tl.int64)
            acc = tl.zeros([RC], dtype=tl.float64)
            for c0 in range(0, nch, RC):
                r = c0 + tl.arange(0, RC).to(tl.int64)
                acc += tl.load(P + a * nch + r, mask=r < nch, other=0.0)
            tot = tl.sum(acc, axis=0)
            if SQRT:
                tot = tl.sqrt(tot)
            mm = tl.load(m + a)
            tl.store(H + a * RP + mm, tot)

        @triton.jit(do_not_specialize=["n"])
        def scale_kernel(V, lanes, m, H, n, stride_lane, brk,
                         RP: tl.constexpr, BLOCK: tl.constexpr):
            # V[ℓ_a, m_a] *= 1/max(‖w‖, BREAK) where ‖w‖ > BREAK, else 0
            c = tl.program_id(0).to(tl.int64)
            a = tl.program_id(1).to(tl.int64)
            lane = tl.load(lanes + a)
            mm = tl.load(m + a)
            hn = tl.load(H + a * RP + mm)
            b = tl.load(brk)
            scale = tl.where(hn > b, 1.0 / tl.maximum(hn, b), 0.0)
            cols = c * BLOCK + tl.arange(0, BLOCK).to(tl.int64)
            ptr = V + lane * stride_lane + mm * n + cols
            v = tl.load(ptr, mask=cols < n, other=0.0)
            tl.store(ptr, scale * v, mask=cols < n)

        @triton.jit(do_not_specialize=["n"])
        def combine_kernel(V, lanes, m, C, X0, out, n, stride_lane,
                           HAS_X0: tl.constexpr, RP: tl.constexpr,
                           SUB: tl.constexpr, NSUB: tl.constexpr):
            c = tl.program_id(0).to(tl.int64)
            a = tl.program_id(1).to(tl.int64)
            lane = tl.load(lanes + a)
            mm = tl.load(m + a)
            rows = tl.arange(0, RP).to(tl.int64)
            rmask = rows < mm
            coef = tl.load(C + a * RP + rows, mask=rmask, other=0.0)
            vbase = V + lane * stride_lane
            for s in range(NSUB):
                cols = (c * NSUB + s) * SUB + tl.arange(0, SUB).to(tl.int64)
                cmask = cols < n
                tile = tl.load(vbase + rows[:, None] * n + cols[None, :],
                               mask=rmask[:, None] & cmask[None, :],
                               other=0.0)
                acc = tl.sum(tile * coef[:, None], axis=0)
                if HAS_X0:
                    acc = tl.load(X0 + a * n + cols, mask=cmask,
                                  other=0.0) + acc
                tl.store(out + a * n + cols, acc, mask=cmask)

        _K7 = (proj_kernel, reduce_kernel, norm_kernel, scale_kernel,
               combine_kernel)
    return _K7


def _rp(n_rows):
    return max(1 << (int(n_rows) - 1).bit_length(), 2)


def _tiles(RP):
    sub = max(16, min(256, SUB_ELEMS // RP))
    return sub, max(1, CHUNK // sub)


def _check(V, lanes, m, *rows):
    for t in (V,) + rows:
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise TypeError("K7 takes contiguous float64 tensors")
    for t in (lanes, m):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError("K7 takes int64 lane and row counts")
    if len({t.device for t in (V, lanes, m) + rows}) != 1:
        raise ValueError("tensors lie on different devices")
    if V.dim() != 3 or lanes.shape != m.shape or lanes.dim() != 1:
        raise ValueError("K7 takes V (L, rows, n) and per-lane lanes, m")
    for t in rows:
        if t.shape[0] != lanes.shape[0]:
            raise ValueError("one row per active lane")


def arnoldi_cgs2_twin(V, w, lanes, m):
    """Plain twin: per lane, two CGS passes as ``torch.mv`` products in the
    JAX order (h = V w; w − Vᵀh; h summed over both), the norm, and the
    guarded normalised row written into V."""
    H = torch.zeros((w.shape[0], V.shape[1]), dtype=w.dtype, device=w.device)
    w = w.clone()
    for a, (lane, mm) in enumerate(zip(lanes.tolist(), m.tolist())):
        Vl = V[lane, :mm]
        wa = w[a]
        for _ in range(2):
            hp = torch.mv(Vl, wa)
            wa = wa - torch.mv(Vl.t(), hp)
            H[a, :mm] += hp
        hn = torch.sqrt(torch.dot(wa, wa))
        H[a, mm] = hn
        V[lane, mm] = torch.where(hn > BREAK, 1.0 / torch.clamp(hn, min=BREAK),
                                  torch.zeros_like(hn)) * wa
    return H


def arnoldi_cgs2(V, w, lanes, m, twin=False):
    """One CGS2 Arnoldi projection for each active lane: ``V`` (L, R+1, n)
    the Krylov bases, ``w`` (La, n) the new operator images of the active
    lanes ``lanes`` (La,) int64, whose first ``m`` (La,) int64 rows are
    valid.  Writes the guarded normalised row V[lanes, m] in place and
    returns the Hessenberg columns (La, R+1) (rows < m: h₁ + h₂, row m:
    ‖w‖).  ``w`` is consumed.  K7 on a CUDA tensor, the twin on a CPU
    tensor or with ``twin=True``."""
    if not kernels.check_device(V) or twin:
        return arnoldi_cgs2_twin(V, w, lanes, m)
    _check(V, lanes, m, w)
    L, R1, n = V.shape
    La = lanes.shape[0]
    if w.shape != (La, n):
        raise ValueError("w must be (active lanes, n)")
    RP = _rp(R1)
    SUB, NSUB = _tiles(RP)
    nch = -(-n // (SUB * NSUB))
    proj, red, nrm, scale, _ = _kernels()
    dev = V.device
    P = torch.empty((La, nch, RP), dtype=V.dtype, device=dev)
    h1 = torch.empty((La, RP), dtype=V.dtype, device=dev)
    h2 = torch.empty_like(h1)
    H = torch.empty_like(h1)
    stride = R1 * n
    grid = (nch, La)
    proj[grid](V, w, lanes, m, h1, P, n, stride, nch, PASS=0, RP=RP,
               SUB=SUB, NSUB=NSUB)
    red[(La,)](P, h1, h1, h1, nch, RP=RP, RC=RED_ROWS, ACC=False)
    proj[grid](V, w, lanes, m, h1, P, n, stride, nch, PASS=1, RP=RP,
               SUB=SUB, NSUB=NSUB)
    red[(La,)](P, h1, h2, H, nch, RP=RP, RC=RED_ROWS, ACC=True)
    proj[grid](V, w, lanes, m, h2, P, n, stride, nch, PASS=2, RP=RP,
               SUB=SUB, NSUB=NSUB)
    nrm[(La,)](P, m, H, nch, RP=RP, RC=RED_ROWS, SQRT=True)
    brk = torch.full((1,), BREAK, dtype=V.dtype, device=dev)
    scale[(-(-n // 1024), La)](V, lanes, m, H, n, stride, brk, RP=RP,
                               BLOCK=1024)
    kernels.LAUNCHES["arnoldi_cgs2"] += 1
    return H[:, :R1]


def krylov_combine_twin(V, coeffs, m, lanes, x0=None):
    out = []
    for a, (lane, mm) in enumerate(zip(lanes.tolist(), m.tolist())):
        s = torch.mv(V[lane, :mm].t(), coeffs[a, :mm])
        out.append(s if x0 is None else x0[a] + s)
    return torch.stack(out)


def krylov_combine(V, coeffs, m, lanes, x0=None, twin=False):
    """``x0 + Σ_{i<m_a} coeffs[a, i]·V[lanes[a], i]`` per active lane (the
    GMRES solution update and the reconstructed residual, ``x0=None``);
    ``coeffs`` (La, R+1).  K7 on a CUDA tensor, the twin on a CPU tensor
    or with ``twin=True``."""
    if not kernels.check_device(V) or twin:
        return krylov_combine_twin(V, coeffs, m, lanes, x0)
    rows = (coeffs,) if x0 is None else (coeffs, x0)
    _check(V, lanes, m, *rows)
    L, R1, n = V.shape
    La = lanes.shape[0]
    RP = _rp(R1)
    C = torch.zeros((La, RP), dtype=V.dtype, device=V.device)
    C[:, :coeffs.shape[1]] = coeffs
    SUB, NSUB = _tiles(RP)
    out = torch.empty((La, n), dtype=V.dtype, device=V.device)
    _kernels()[4][(-(-n // (SUB * NSUB)), La)](
        V, lanes, m, C, out if x0 is None else x0, out, n, R1 * n,
        HAS_X0=x0 is not None, RP=RP, SUB=SUB, NSUB=NSUB)
    kernels.LAUNCHES["arnoldi_cgs2"] += 1
    return out


def row_sums(P):
    """Σ over the columns of each row of the partials P (La, nch), in K7's
    fixed chunk order (K8's residual norms use it)."""
    La, nch = P.shape
    out = torch.empty((La,), dtype=P.dtype, device=P.device)
    zero = torch.zeros((La,), dtype=torch.int64, device=P.device)
    _kernels()[2][(La,)](P, zero, out, nch, RP=1, RC=RED_ROWS, SQRT=False)
    return out
