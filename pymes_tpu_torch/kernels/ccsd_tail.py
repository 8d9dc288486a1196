"""K2′/K3′: the per-iteration tail of the CCSD fixed point, in CUDA C++.

Replace B3 of the JAX package for the CCSD carry: the Jacobi step of
``ccsd_iteration`` (``pymes_tpu/solver/ccsd.py:615-618``), ``diis.mix`` over
the flat vector [T1 | T2] (``ccsd.py:620-625``,
``pymes_tpu/mixer/diis.py:107-161``) and ``ccsd_energy_ij``
(``ccsd.py:393``).  The DIIS rings hold the flat vector in the JAX order,
T1 (nv, no) first, then T2 (no, no, nv, nv).  Two passes over it, split
around the tiny bordered DIIS solve that runs in torch:

* K2′ (:func:`jacobi_diis_insert`): dT = R / (D + shift) with D built in
  the kernel from ``eps_i`` and ``eps_a`` (eps_i[i] − eps_a[a] on the T1
  segment, the pair sum on the T2 segment, each in the twin's order);
  writes dT into the error-ring slot and T + dT into the amplitude-ring
  slot, in place (bit for bit the twin's rows), and returns the Gram row
  Re⟨errs[k], dT⟩ over the whole vector.
* K3′ (:func:`diis_mix_energy`): T1, T2 ← Σ_k c_k · amps[k] in place, and
  the energy pieces from Σ f_ia·T1[a,i], Σ T_eff·V_ijab and Σ T_eff·V_ijba,
  T_eff = T2 + T1[a,i]·T1[b,j]: the T1 segment is mixed first, in a small
  launch of the same library call, and the T2 elements read the two mixed
  T1 factors.

The kernels (``pymes_tpu_torch/csrc/cc_tail.cu``, built with nvcc for
sm_90a at first use by :mod:`._build`) serve K2/K3 too (:mod:`.ccd_tail`):
CCD is the case of an empty T1 segment (N1 = 0), for which these passes do
exactly what the CCD passes do.  The public wrappers here take ``R1``,
``T1`` and ``F1`` as None for that case.  Each wrapper call on a CUDA tensor
is one library call (a counter reset and one or two launches on the current
stream) into one output tensor; its launch geometry comes from
:func:`plan`.  What bounds the passes on an H100 is memory bandwidth: 9
rows of N at a 6-slot ring, no matrix work; cross-block sums are taken by
the last block in block order, so runs are deterministic (the source says
how).

Element types.  Every operand is float64, or every one float32 for the f32
bulk of the mixed-precision CCSD (``CCSD.solve(mixed_precision=True)``,
``pymes_tpu/solver/ccsd.py:803-816``) and CCD: the kernels are templates
on the element type, and all arithmetic follows it, the sums included
(launches counted under the name + ``"_f32"``).
"""

import functools
from typing import NamedTuple

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

# THREADS, BLOCKS_PER_SM (MIN_BLOCKS there) and SLOTS are those of
# csrc/cc_tail.cu
THREADS = 256        # threads of a block
BLOCKS_PER_SM = 2    # the persistent grid's blocks an SM: one wave
SLOTS = 8            # ring rows a thread loads at once: a Gram group
T1_BLOCKS = 32       # at most this many blocks mix the T1 segment
VECTOR_BYTES = 16    # the widest load, double2 / float4


class Plan(NamedTuple):
    """The launch geometry of a tail pass: the T2 segment's ``vec``-wide
    vectors (``nvec`` of them after a scalar ``head``, then a scalar
    ``tail``), the blocks of the grid-stride pass and of the T1 mix, and
    the slot groups (first slot, slot count) of the Gram sums."""
    vec: int
    head: int
    nvec: int
    tail: int
    grid: int
    grid1: int
    groups: tuple


@functools.lru_cache(maxsize=256)
def plan(n1, n, n_valid, elem, phases, sms):
    """The geometry of a pass over the flat vector [T1 (n1) | T2 (n − n1)]
    of ``elem``-byte elements.  ``phases``: the element offset, modulo
    ``VECTOR_BYTES // elem``, of each T2-segment operand at its first T2
    element (a ring row's offset counts its T1 segment).  The vector width
    is the widest whose every operand, every ring row included (n a
    multiple of it), sits at one phase; the head brings that phase to an
    aligned vector.  The grid takes ``BLOCKS_PER_SM`` blocks an SM, fewer
    when the work is smaller."""
    n2 = n - n1
    vec = VECTOR_BYTES // elem
    while vec > 1 and (n % vec or len({p % vec for p in phases}) > 1):
        vec //= 2
    head = min(-phases[0] % vec, n2)
    nvec = (n2 - head) // vec
    tail = n2 - head - nvec * vec
    work = max(nvec, n1 + head + tail)
    grid = max(1, min(-(-work // THREADS), BLOCKS_PER_SM * sms))
    grid1 = min(-(-n1 // THREADS), T1_BLOCKS)
    groups = tuple((g, min(SLOTS, n_valid - g))
                   for g in range(0, n_valid, SLOTS))
    return Plan(vec, head, nvec, tail, grid, grid1, groups)


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


def _fits(T1, T2, m, N):
    if T2.dim() != 4:
        raise ValueError("T2 must be (no, no, nv, nv)")
    no, nv = T2.shape[0], T2.shape[2]
    n1 = 0 if T1 is None else T1.numel()
    if (T2.shape != (no, no, nv, nv) or N != n1 + T2.numel()
            or (T1 is not None and T1.shape != (nv, no))
            or m * N >= 2 ** 31):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    return no, nv, n1


def _phases(elem, n1, rings, flats):
    w = VECTOR_BYTES // elem
    return tuple([(t.data_ptr() // elem + n1) % w for t in rings]
                 + [(t.data_ptr() // elem) % w for t in flats])


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_jacobi(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps, slot,
                  n_valid, name):
    """K2′ (K2 with ``R1``, ``T1`` None) on CUDA tensors: checks, plans and
    makes the library call; counts the launch under ``name`` + the type's
    suffix.  Returns the Gram row (m,)."""
    R2 = R2.contiguous()  # a sum with the ladder's strided view may not be
    R1 = None if R1 is None else R1.contiguous()
    sfx = _check(*(t for t in (R1, T1, R2, T2, eps_i, eps_a, errs, amps)
                   if t is not None))
    m, N = errs.shape
    no, nv, n1 = _fits(T1, T2, m, N)
    if ((R1 is None) != (T1 is None) or R2.shape != T2.shape
            or (R1 is not None and R1.shape != T1.shape)
            or eps_i.numel() != no or eps_a.numel() != nv
            or amps.shape != errs.shape):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    slot, n_valid = int(slot), int(n_valid)
    if not (0 <= slot < m and 1 <= n_valid <= m):
        raise ValueError(f"slot {slot}, n_valid {n_valid} outside a ring of "
                         f"{m}")
    elem = R2.element_size()
    p = plan(n1, N, n_valid, elem,
             _phases(elem, n1, (errs, amps), (R2, T2)),
             _build.sm_count(R2.device))
    out = torch.empty(m + p.grid * m + 1, dtype=R2.dtype, device=R2.device)
    rc = _build.launch(R2.device, getattr(_build.library(),
                                          "pymes_cc_jacobi" + sfx),
                       _ptr(R1), _ptr(T1), R2.data_ptr(), T2.data_ptr(),
                       eps_i.data_ptr(), eps_a.data_ptr(), float(shift),
                       errs.data_ptr(), amps.data_ptr(), out.data_ptr(), n1,
                       N, no, nv, m, slot, n_valid, p.vec, p.head, p.nvec,
                       p.tail, p.grid)
    if rc != 0:
        raise RuntimeError(f"cc_tail Jacobi launch failed: cudaError {rc}")
    kernels.LAUNCHES[name + sfx] += 1
    return out[:m]


def launch_mix(amps, coeff, n_valid, T1, T2, F1, V, Vx, name):
    """K3′ (K3 with ``T1``, ``F1`` None) on CUDA tensors: checks, plans and
    makes the library call; counts the launch under ``name`` + the type's
    suffix.  Returns the (3,) tensor (2 e_1b, 2 e_dir, −e_exc)."""
    sfx = _check(*(t for t in (amps, coeff, T1, T2, F1, V, Vx)
                   if t is not None))
    m, N = amps.shape
    no, nv, n1 = _fits(T1, T2, m, N)
    if ((F1 is None) != (T1 is None)
            or (F1 is not None and F1.shape != T1.shape)
            or V.shape != T2.shape or Vx.shape != T2.shape
            or coeff.numel() != m):
        raise ValueError("ring/amplitude sizes do not fit the kernel")
    n_valid = int(n_valid)
    if not 0 <= n_valid <= m:
        raise ValueError(f"n_valid {n_valid} outside a ring of {m}")
    elem = T2.element_size()
    p = plan(n1, N, n_valid, elem, _phases(elem, n1, (amps,), (T2, V, Vx)),
             _build.sm_count(T2.device))
    out = torch.empty(3 + 2 * p.grid + p.grid1 + 1, dtype=T2.dtype,
                      device=T2.device)
    rc = _build.launch(T2.device, getattr(_build.library(),
                                          "pymes_cc_mix" + sfx),
                       amps.data_ptr(), coeff.data_ptr(), _ptr(T1),
                       T2.data_ptr(), _ptr(F1), V.data_ptr(), Vx.data_ptr(),
                       out.data_ptr(), n1, N, no, nv, n_valid, p.vec, p.head,
                       p.nvec, p.tail, p.grid, p.grid1)
    if rc != 0:
        raise RuntimeError(f"cc_tail mix launch failed: cudaError {rc}")
    kernels.LAUNCHES[name + sfx] += 1
    return out[:3]


def jacobi_twin(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps, slot,
                n_valid):
    """Plain twin of K2′ (``R1``, ``T1`` None: no T1 segment); returns the
    Gram row (m,), zero past n_valid."""
    D2 = (eps_i[:, None, None, None] + eps_i[None, :, None, None]
          - eps_a[None, None, :, None] - eps_a[None, None, None, :])
    dT = [(R2 / (D2 + shift)).reshape(-1)]
    T = [T2.reshape(-1)]
    if T1 is not None:
        dT.insert(0, (R1 / (eps_i[None, :] - eps_a[:, None] + shift))
                  .reshape(-1))
        T.insert(0, T1.reshape(-1))
    dT = torch.cat(dT)
    errs[slot] = dT
    amps[slot] = torch.cat(T) + dT
    row = errs.new_zeros(errs.shape[0])
    row[:n_valid] = (errs[:n_valid] * dT[None, :]).sum(dim=1)
    return row


def jacobi_diis_insert(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps,
                       slot: int, n_valid: int, twin=False):
    """Jacobi step + DIIS ring insertion over [T1 | T2] (K2′ on a CUDA
    tensor, its twin on a CPU tensor or with ``twin=True``).  ``R1``,
    ``T1``: (nv, no), or both None for an empty T1 segment; ``R2``, ``T2``:
    (no, no, nv, nv); rings (m, N) with N = nv·no + no²nv².  Writes
    ``errs[slot] = dT``, ``amps[slot] = T + dT`` and returns the Gram row
    Re⟨errs[k], dT⟩ (m,), zero past ``n_valid``; all float64 or all
    float32."""
    if not kernels.check_device(R2) or twin:
        return jacobi_twin(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps,
                           slot, n_valid)
    return launch_jacobi(R1, T1, R2, T2, eps_i, eps_a, shift, errs, amps,
                         slot, n_valid, "ccsd_jacobi_diis")


def mix_energy_twin(amps, coeff, n_valid, T1, T2, F1, V, Vx):
    """Plain twin of K3′ (``T1``, ``F1`` None: no T1 segment); returns
    (Σ T1·F1, Σ T_eff·V, Σ T_eff·Vx) after T1, T2 ← Σ c_k amps[k]."""
    mixed = (coeff[:n_valid, None] * amps[:n_valid]).sum(dim=0)
    if T1 is None:
        T2.copy_(mixed.reshape(T2.shape))
        return T2.new_zeros(()), (T2 * V).sum(), (T2 * Vx).sum()
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
    on a CPU tensor or with ``twin=True``); ``T1``, ``F1`` both None for an
    empty T1 segment (e_1b = 0, T_eff = T2); all float64 or all float32."""
    if not kernels.check_device(T2) or twin:
        s_1b, s_dir, s_exc = mix_energy_twin(amps, coeff, n_valid, T1, T2,
                                             F1, V, Vx)
        return 2.0 * s_1b, 2.0 * s_dir, -1.0 * s_exc
    e = launch_mix(amps, coeff, n_valid, T1, T2, F1, V, Vx,
                   "ccsd_mix_energy")
    return e[0], e[1], e[2]
