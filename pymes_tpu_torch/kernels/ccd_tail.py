"""K2/K3: the per-iteration tail of the CCD fixed point, in Triton.

Replace B3 of the JAX package: the Jacobi step of the ``ccd_solve_jit``
body (``pymes_tpu/solver/ccd.py:525-537``), ``diis.mix``
(``pymes_tpu/mixer/diis.py:107-161``) and ``ccd_energy_ij``
(``pymes_tpu/solver/ccd.py:353-359``).  Two fused passes over T2 and the
DIIS rings, split around the tiny bordered DIIS solve that runs in torch:

* K2 (:func:`jacobi_diis_insert`): dT = R / (D + shift) with D built in the
  kernel from ``eps_i``, ``eps_a`` and the flat (i, j, a, b) index (no D
  tensor exists); writes dT into the error-ring slot and T + dT into the
  amplitude-ring slot, in place; and per-block partials of
  Re⟨errs[k], dT⟩ for the valid slots k.
* K3 (:func:`diis_mix_energy`): T ← Σ_k c_k · amps[k], in place, fused with
  the energy partials Σ T·V_ijab and Σ T·V_ijba.

What bounds them on an H100: memory bandwidth — per element K2 moves 2
reads + 2 writes + up to 5 ring reads, K3 up to 6 ring reads + 2 block
reads + 1 write, and neither does any matrix work (hence Triton).
Cross-block sums are per-block partials summed in torch, not atomics, so
runs are deterministic.

Every operand is float64, or every one float32 for the f32 bulk of the
mixed-precision CCD (``CCD.solve(mixed_precision=True)``,
``pymes_tpu/solver/ccd.py:639-656``): the element type is the kernels'
``DT`` constexpr, and all arithmetic follows it, the per-block partials of
the Gram row and the energy included (the JAX f32 pass takes its sums in
f32 too); the f32 launches count under ``ccd_jacobi_diis_f32`` and
``ccd_mix_energy_f32``.

Triton is imported inside the launching functions: the module must import
where there is no Triton.
"""

import torch

from pymes_tpu_torch import kernels

BLOCK = 1024

_K2 = None
_K3 = None


def _kernels():
    """Compile-on-first-use Triton kernels (JIT at the first launch)."""
    global _K2, _K3
    if _K2 is None:
        import triton
        import triton.language as tl

        # slot/n_valid stay runtime values: Triton would otherwise turn a
        # value of 1 into a compile-time constant
        @triton.jit(do_not_specialize=["slot", "n_valid"])
        def jacobi_insert_kernel(R, T, eps_i, eps_a, shift, errs, amps,
                                 part, N, no, nv, slot, n_valid,
                                 M: tl.constexpr, BLOCK: tl.constexpr,
                                 DT: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < N
            b = offs % nv
            a = (offs // nv) % nv
            j = (offs // (nv * nv)) % no
            i = offs // (nv * nv * no)
            D = (tl.load(eps_i + i, mask=mask, other=0.0)
                 + tl.load(eps_i + j, mask=mask, other=0.0)
                 - tl.load(eps_a + a, mask=mask, other=0.0)
                 - tl.load(eps_a + b, mask=mask, other=0.0))
            r = tl.load(R + offs, mask=mask, other=0.0)
            t = tl.load(T + offs, mask=mask, other=0.0)
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
        def mix_energy_kernel(amps, coeff, T, V, Vx, part, N, n_valid,
                              M: tl.constexpr, BLOCK: tl.constexpr,
                              DT: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < N
            acc = tl.zeros([BLOCK], dtype=DT)
            for k in tl.static_range(M):
                c = tl.load(coeff + k)
                amp = tl.load(amps + k * N + offs,
                              mask=mask & (k < n_valid), other=0.0)
                acc += c * amp
            tl.store(T + offs, acc, mask=mask)
            v = tl.load(V + offs, mask=mask, other=0.0)
            vx = tl.load(Vx + offs, mask=mask, other=0.0)
            tl.store(part + pid * 2, tl.sum(acc * v, axis=0))
            tl.store(part + pid * 2 + 1, tl.sum(acc * vx, axis=0))

        _K2, _K3 = jacobi_insert_kernel, mix_energy_kernel
    return _K2, _K3


def _check(*tensors):
    """The shared refusals of the tail kernels: contiguous tensors of one
    float type (float64 or float32) on one device.  Returns the type's
    :data:`~pymes_tpu_torch.kernels.SUFFIX`."""
    sfx = kernels.type_suffix("the tail kernels", *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise TypeError("the tail kernels take contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tensors lie on different devices")
    return sfx


def jacobi_twin(R, T, eps_i, eps_a, shift, errs, amps, slot, n_valid):
    """Plain twin of K2; returns the Gram row (m,), zero past n_valid."""
    D = (eps_i[:, None, None, None] + eps_i[None, :, None, None]
         - eps_a[None, None, :, None] - eps_a[None, None, None, :])
    dT = (R / (D + shift)).reshape(-1)
    errs[slot] = dT
    amps[slot] = T.reshape(-1) + dT
    row = errs.new_zeros(errs.shape[0])
    row[:n_valid] = (errs[:n_valid] * dT[None, :]).sum(dim=1)
    return row


def jacobi_diis_insert(R, T, eps_i, eps_a, shift, errs, amps, slot: int,
                       n_valid: int, twin=False):
    """Jacobi step + DIIS ring insertion (K2 on a CUDA tensor, its twin on
    a CPU tensor or with ``twin=True``).  ``R``, ``T``: (no, no, nv, nv);
    rings (m, N), all float64 or all float32.  Writes ``errs[slot] = dT``,
    ``amps[slot] = T + dT`` and returns the Gram row Re⟨errs[k], dT⟩ (m,),
    zero past ``n_valid``."""
    if not kernels.check_device(R) or twin:
        return jacobi_twin(R, T, eps_i, eps_a, shift, errs, amps, slot,
                           n_valid)
    R = R.contiguous()  # a sum with the ladder's strided view may not be
    sfx = _check(R, T, eps_i, eps_a, errs, amps)
    k2, _ = _kernels()
    m, N = errs.shape
    no, nv = eps_i.shape[0], eps_a.shape[0]
    if (R.numel() != N or T.numel() != N or no * no * nv * nv != N
            or amps.shape != errs.shape or m * N >= 2 ** 31):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    n_blocks = -(-N // BLOCK)
    part = torch.empty((n_blocks, m), dtype=R.dtype, device=R.device)
    # the shift goes in as a tensor of R's type: Triton passes a Python
    # float as f32
    shift_t = torch.full((1,), float(shift), dtype=R.dtype, device=R.device)
    k2[(n_blocks,)](R, T, eps_i, eps_a, shift_t, errs, amps, part, N,
                    no, nv, int(slot), int(n_valid), M=m, BLOCK=BLOCK,
                    DT=kernels.tl_type(R.dtype))
    kernels.LAUNCHES["ccd_jacobi_diis" + sfx] += 1
    return part.sum(dim=0)


def mix_energy_twin(amps, coeff, n_valid, T, V, Vx):
    """Plain twin of K3; returns (Σ T·V, Σ T·Vx) after T ← Σ c_k amps[k]."""
    mixed = (coeff[:n_valid, None] * amps[:n_valid]).sum(dim=0)
    T.copy_(mixed.reshape(T.shape))
    return (T * V).sum(), (T * Vx).sum()


def diis_mix_energy(amps, coeff, n_valid: int, T, V, Vx, twin=False):
    """T ← Σ_k coeff[k] amps[k] (in place) and the CCD energy pieces
    ``(e_dir, e_exc) = (2 Σ T·V_ijab, −Σ T·V_ijba)`` (K3 on a CUDA tensor,
    its twin on a CPU tensor or with ``twin=True``); all float64 or all
    float32."""
    if not kernels.check_device(T) or twin:
        s_dir, s_exc = mix_energy_twin(amps, coeff, n_valid, T, V, Vx)
    else:
        sfx = _check(amps, coeff, T, V, Vx)
        _, k3 = _kernels()
        m, N = amps.shape
        if (T.numel() != N or V.numel() != N or Vx.numel() != N
                or coeff.numel() != m or m * N >= 2 ** 31):
            raise ValueError("ring/amplitude sizes do not fit the kernel")
        n_blocks = -(-N // BLOCK)
        part = torch.empty((n_blocks, 2), dtype=T.dtype, device=T.device)
        k3[(n_blocks,)](amps, coeff, T, V, Vx, part, N, int(n_valid),
                        M=m, BLOCK=BLOCK, DT=kernels.tl_type(T.dtype))
        kernels.LAUNCHES["ccd_mix_energy" + sfx] += 1
        s_dir, s_exc = part.sum(dim=0)
    return 2.0 * s_dir, -1.0 * s_exc
