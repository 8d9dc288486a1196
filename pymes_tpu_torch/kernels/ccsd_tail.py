"""K2′/K3′: the per-iteration tail of the CCSD fixed point, in Triton.

Replace B3 of the JAX package for the CCSD carry: the Jacobi step of
``ccsd_iteration`` (``pymes_tpu/solver/ccsd.py:615-618``), ``diis.mix`` over
the flat vector [T1 | T2] (``ccsd.py:620-625``,
``pymes_tpu/mixer/diis.py:107-161``) and ``ccsd_energy_ij``
(``ccsd.py:393``).  The DIIS rings hold the flat vector in the JAX order,
T1 (nv, no) first, then T2 (no, no, nv, nv); each kernel covers both
segments in one launch, split around the tiny bordered DIIS solve that
runs in torch:

* K2′ (:func:`jacobi_diis_insert`): dT = R / (D + shift) with D built in
  the kernel from ``eps_i``, ``eps_a`` and the flat index (eps_i[i] −
  eps_a[a] on the T1 segment, at index (a, i); the pair sum on the T2
  segment); writes dT into the error-ring slot and T + dT into the
  amplitude-ring slot, in place; per-block partials of Re⟨errs[k], dT⟩
  over the whole vector.
* K3′ (:func:`diis_mix_energy`): T1, T2 ← Σ_k c_k · amps[k], fused with
  the energy partials Σ f_ia·T1[a,i], Σ T_eff·V_ijab and Σ T_eff·V_ijba,
  T_eff = T2 + T1[a,i]·T1[b,j] built in the kernel.  A program may not read
  T1 values that another program of the same launch is mixing, so each T2
  element recomputes its two T1 factors from the ring and the coefficients
  (2·m loads, L2-resident: the T1 segment is 12 KB at nP=219) in the same
  order as the T1 segment is mixed, which gives the same bits.

What bounds them on an H100: memory bandwidth, as for K2/K3
(:mod:`.ccd_tail`); the T1 segment adds 0.07 % of the elements at nP=219.
Cross-block sums are per-block partials summed in torch (deterministic).

Element types.  Every operand is float64, or every one float32 for the f32
bulk of the mixed-precision CCSD (``CCSD.solve(mixed_precision=True)``,
``pymes_tpu/solver/ccsd.py:803-816``): the element type is the kernels'
``DT`` constexpr and all arithmetic follows it, the partials included
(launches counted under ``ccsd_jacobi_diis_f32`` and
``ccsd_mix_energy_f32``).  Triton is imported inside the launching
functions: the module must import where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels.ccd_tail import _check

BLOCK = 1024

_K2 = None
_K3 = None


def _kernels():
    """Compile-on-first-use Triton kernels (JIT at the first launch)."""
    global _K2, _K3
    if _K2 is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["slot", "n_valid"])
        def ccsd_jacobi_insert_kernel(R1, T1, R2, T2, eps_i, eps_a, shift,
                                      errs, amps, part, N1, N, no, nv, slot,
                                      n_valid, M: tl.constexpr,
                                      BLOCK: tl.constexpr,
                                      DT: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < N
            seg1 = offs < N1
            m1 = mask & seg1
            m2 = mask & (offs >= N1)
            # T1 segment: flat (a, i) of T1 (nv, no)
            a1 = offs // no
            i1 = offs % no
            D1 = (tl.load(eps_i + i1, mask=m1, other=0.0)
                  - tl.load(eps_a + a1, mask=m1, other=0.0))
            # T2 segment: flat (i, j, a, b) of T2 (no, no, nv, nv)
            o2 = offs - N1
            b = o2 % nv
            a = (o2 // nv) % nv
            j = (o2 // (nv * nv)) % no
            i = o2 // (nv * nv * no)
            D2 = (tl.load(eps_i + i, mask=m2, other=0.0)
                  + tl.load(eps_i + j, mask=m2, other=0.0)
                  - tl.load(eps_a + a, mask=m2, other=0.0)
                  - tl.load(eps_a + b, mask=m2, other=0.0))
            r = tl.where(seg1, tl.load(R1 + offs, mask=m1, other=0.0),
                         tl.load(R2 + o2, mask=m2, other=0.0))
            t = tl.where(seg1, tl.load(T1 + offs, mask=m1, other=0.0),
                         tl.load(T2 + o2, mask=m2, other=0.0))
            D = tl.where(seg1, D1, D2)
            dT = tl.where(mask, r / (D + tl.load(shift)), 0.0)
            tl.store(errs + slot * N + offs, dT, mask=mask)
            tl.store(amps + slot * N + offs, t + dT, mask=mask)
            for k in tl.static_range(M):
                e = tl.load(errs + k * N + offs,
                            mask=mask & (k < n_valid) & (k != slot),
                            other=0.0)
                e = tl.where(k == slot, dT, e)
                tl.store(part + pid * M + k, tl.sum(e * dT, axis=0))

        @triton.jit(do_not_specialize=["n_valid"])
        def ccsd_mix_energy_kernel(amps, coeff, T1, T2, F1, V, Vx, part, N1,
                                   N, no, nv, n_valid, M: tl.constexpr,
                                   BLOCK: tl.constexpr, DT: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < N
            seg1 = offs < N1
            m1 = mask & seg1
            m2 = mask & (offs >= N1)
            o2 = offs - N1
            b = o2 % nv
            a = (o2 // nv) % nv
            j = (o2 // (nv * nv)) % no
            i = o2 // (nv * nv * no)
            ai = a * no + i      # flat index of T1[a, i]
            bj = b * no + j      # flat index of T1[b, j]
            acc = tl.zeros([BLOCK], dtype=DT)
            t1a = tl.zeros([BLOCK], dtype=DT)
            t1b = tl.zeros([BLOCK], dtype=DT)
            for k in tl.static_range(M):
                c = tl.load(coeff + k)
                live = k < n_valid
                acc += c * tl.load(amps + k * N + offs, mask=mask & live,
                                   other=0.0)
                t1a += c * tl.load(amps + k * N + ai, mask=m2 & live,
                                   other=0.0)
                t1b += c * tl.load(amps + k * N + bj, mask=m2 & live,
                                   other=0.0)
            tl.store(T1 + offs, acc, mask=m1)
            tl.store(T2 + o2, acc, mask=m2)
            f = tl.load(F1 + offs, mask=m1, other=0.0)
            teff = tl.where(m2, acc + t1a * t1b, 0.0)
            v = tl.load(V + o2, mask=m2, other=0.0)
            vx = tl.load(Vx + o2, mask=m2, other=0.0)
            tl.store(part + pid * 3, tl.sum(acc * f, axis=0))
            tl.store(part + pid * 3 + 1, tl.sum(teff * v, axis=0))
            tl.store(part + pid * 3 + 2, tl.sum(teff * vx, axis=0))

        _K2, _K3 = ccsd_jacobi_insert_kernel, ccsd_mix_energy_kernel
    return _K2, _K3


def _fits(T1, T2, m, N):
    nv, no = T1.shape
    if (T2.shape != (no, no, nv, nv) or N != T1.numel() + T2.numel()
            or m * N >= 2 ** 31):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    return no, nv


def jacobi_twin(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps, slot,
                n_valid):
    """Plain twin of K2′; returns the Gram row (m,), zero past n_valid."""
    dT1 = R1 / (eps_i[None, :] - eps_a[:, None] + shift)
    D2 = (eps_i[:, None, None, None] + eps_i[None, :, None, None]
          - eps_a[None, None, :, None] - eps_a[None, None, None, :])
    dT2 = R2 / (D2 + shift)
    dT = torch.cat([dT1.reshape(-1), dT2.reshape(-1)])
    errs[slot] = dT
    amps[slot] = torch.cat([T1.reshape(-1), T2.reshape(-1)]) + dT
    row = errs.new_zeros(errs.shape[0])
    row[:n_valid] = (errs[:n_valid] * dT[None, :]).sum(dim=1)
    return row


def jacobi_diis_insert(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps,
                       slot: int, n_valid: int, twin=False):
    """Jacobi step + DIIS ring insertion over [T1 | T2] (K2′ on a CUDA
    tensor, its twin on a CPU tensor or with ``twin=True``).  ``R1``,
    ``T1``: (nv, no); ``R2``, ``T2``: (no, no, nv, nv); rings (m, N) with
    N = nv·no + no²nv².  Writes ``errs[slot] = dT``,
    ``amps[slot] = T + dT`` and returns the Gram row Re⟨errs[k], dT⟩ (m,),
    zero past ``n_valid``; all float64 or all float32."""
    if not kernels.check_device(R2) or twin:
        return jacobi_twin(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps,
                           slot, n_valid)
    R1, R2 = R1.contiguous(), R2.contiguous()
    sfx = _check(R1, T1, R2, T2, eps_i, eps_a, errs, amps)
    m, N = errs.shape
    no, nv = _fits(T1, T2, m, N)
    if (R1.shape != T1.shape or R2.shape != T2.shape
            or eps_i.numel() != no or eps_a.numel() != nv
            or amps.shape != errs.shape):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    k2, _ = _kernels()
    n_blocks = -(-N // BLOCK)
    part = torch.empty((n_blocks, m), dtype=R2.dtype, device=R2.device)
    # the shift goes in as a tensor of R2's type: Triton passes a Python
    # float as f32
    shift_t = torch.full((1,), float(shift), dtype=R2.dtype,
                         device=R2.device)
    k2[(n_blocks,)](R1, T1, R2, T2, eps_i, eps_a, shift_t, errs, amps, part,
                    T1.numel(), N, no, nv, int(slot), int(n_valid), M=m,
                    BLOCK=BLOCK, DT=kernels.tl_type(R2.dtype))
    kernels.LAUNCHES["ccsd_jacobi_diis" + sfx] += 1
    return part.sum(dim=0)


def mix_energy_twin(amps, coeff, n_valid, T1, T2, F1, V, Vx):
    """Plain twin of K3′; returns (Σ T1·F1, Σ T_eff·V, Σ T_eff·Vx) after
    T1, T2 ← Σ c_k amps[k]."""
    mixed = (coeff[:n_valid, None] * amps[:n_valid]).sum(dim=0)
    n1 = T1.numel()
    T1.copy_(mixed[:n1].reshape(T1.shape))
    T2.copy_(mixed[n1:].reshape(T2.shape))
    T1t = T1.t()
    T_eff = T2 + T1t[:, None, :, None] * T1t[None, :, None, :]
    return (T1 * F1).sum(), (T_eff * V).sum(), (T_eff * Vx).sum()


def diis_mix_energy(amps, coeff, n_valid: int, T1, T2, F1, V, Vx,
                    twin=False):
    """T1, T2 ← Σ_k coeff[k] amps[k] (in place) and the CCSD energy pieces
    ``(e_1b, e_dir, e_exc) = (2 Σ f_ia T1[a,i], 2 Σ T_eff·V_ijab,
    −Σ T_eff·V_ijba)`` with ``F1 = f_ovᵀ`` (nv, no) and
    T_eff[i,j,a,b] = T2 + T1[a,i]·T1[b,j] (K3′ on a CUDA tensor, its twin
    on a CPU tensor or with ``twin=True``); all float64 or all float32."""
    if not kernels.check_device(T2) or twin:
        s_1b, s_dir, s_exc = mix_energy_twin(amps, coeff, n_valid, T1, T2,
                                             F1, V, Vx)
    else:
        sfx = _check(amps, coeff, T1, T2, F1, V, Vx)
        m, N = amps.shape
        no, nv = _fits(T1, T2, m, N)
        if (F1.shape != T1.shape or V.shape != T2.shape
                or Vx.shape != T2.shape or coeff.numel() != m):
            raise ValueError("ring/amplitude sizes do not fit the kernel")
        _, k3 = _kernels()
        n_blocks = -(-N // BLOCK)
        part = torch.empty((n_blocks, 3), dtype=T2.dtype, device=T2.device)
        k3[(n_blocks,)](amps, coeff, T1, T2, F1, V, Vx, part, T1.numel(), N,
                        no, nv, int(n_valid), M=m, BLOCK=BLOCK,
                        DT=kernels.tl_type(T2.dtype))
        kernels.LAUNCHES["ccsd_mix_energy" + sfx] += 1
        s_1b, s_dir, s_exc = part.sum(dim=0)
    return 2.0 * s_1b, 2.0 * s_dir, -1.0 * s_exc
