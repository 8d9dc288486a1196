"""K2/K3: the per-iteration tail of the CCD fixed point, in CUDA C++.

Replace B3 of the JAX package: the Jacobi step of the ``ccd_solve_jit``
body (``pymes_tpu/solver/ccd.py:525-537``), ``diis.mix``
(``pymes_tpu/mixer/diis.py:107-161``) and ``ccd_energy_ij``
(``pymes_tpu/solver/ccd.py:353-359``).  Two passes over T2 and the DIIS
rings, split around the tiny bordered DIIS solve that runs in torch:

* K2 (:func:`jacobi_diis_insert`): dT = R / (D + shift) with D built in the
  kernel from ``eps_i`` and ``eps_a`` (no D tensor exists); writes dT into
  the error-ring slot and T + dT into the amplitude-ring slot, in place
  (bit for bit the twin's rows); returns the Gram row Re⟨errs[k], dT⟩ for
  the valid slots k.
* K3 (:func:`diis_mix_energy`): T ← Σ_k c_k · amps[k], in place, fused with
  the energy sums Σ T·V_ijab and Σ T·V_ijba.

They are the kernels of K2′/K3′ (``pymes_tpu_torch/csrc/cc_tail.cu``,
:mod:`.ccsd_tail`) called with an empty T1 segment, for which those
passes do exactly what the CCD passes do; their launches count under
``ccd_jacobi_diis`` and ``ccd_mix_energy`` (``_f32`` for the f32 bulk of
the mixed-precision CCD, ``CCD.solve(mixed_precision=True)``,
``pymes_tpu/solver/ccd.py:639-656``: all operands float32, all arithmetic
in f32, as the JAX f32 pass).  What bounds them on an H100 is memory
bandwidth (:mod:`.ccsd_tail`).
"""

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import ccsd_tail


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
    return ccsd_tail.launch_jacobi(None, None, R, T, eps_i, eps_a, shift,
                                   errs, amps, slot, n_valid,
                                   "ccd_jacobi_diis")


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
        return 2.0 * s_dir, -1.0 * s_exc
    e = ccsd_tail.launch_mix(amps, coeff, n_valid, None, T, None, V, Vx,
                             "ccd_mix_energy")
    return e[1], e[2]
