"""DIIS (Pulay) convergence acceleration on torch tensors.

Counterpart of ``pymes_tpu/mixer/diis.py`` with the same formulas: a ring of
the last ``dim_space`` (error, amplitude) pairs, the Gram row of the inserted
error against the ring after insertion, masking to the valid window,
normalisation by the largest diagonal entry, a 1e-14 ridge, and the bordered
system with an identity on invalid rows.  The bordered system is solved with
``torch.linalg.solve_ex`` (the JAX package's hand-rolled ``_gauss_solve`` is
a TPU workaround): it does not synchronise with the host, and the caller
checks the returned ``info`` once, at the end of a solve.

Unlike the JAX state, the rings are updated in place (a copy of the 6×N
ring per iteration would double the tail's memory traffic); ``count`` is a
host integer, so no device value is read to find the slot.  Every ring
takes the amplitudes' type (``init_state``'s ``dtype``): float64, or
float32 in the f32 bulk of the mixed-precision CCD/CCSD.  The JAX
package's f32 error ring beside f64 amplitudes (``err_dtype``) serves its
f32 dressing carriers, which the port leaves out with the Ozaki modes.
"""

from typing import NamedTuple

import torch


class DIISState(NamedTuple):
    """Ring buffers of flattened amplitudes/errors, the insertion count and
    the carried Gram matrix ``B[i,j] = Re<err_i, err_j>`` of the ring."""

    amps: torch.Tensor   # (m, N)
    errs: torch.Tensor   # (m, N)
    count: int           # total number of insertions so far
    B: torch.Tensor      # (m, m) real Gram matrix of errs


def init_state(dim_space: int, n_flat: int, dtype, device) -> DIISState:
    return DIISState(
        amps=torch.zeros((dim_space, n_flat), dtype=dtype, device=device),
        errs=torch.zeros((dim_space, n_flat), dtype=dtype, device=device),
        count=0,
        B=torch.zeros((dim_space, dim_space), dtype=dtype, device=device))


def gram_from_errs(errs):
    """Rebuild the carried Gram matrix ``Re(errs^* errsᵀ)`` from the error
    ring (the restore path; ``pymes_tpu/mixer/diis.py:102``)."""
    return (errs.conj() @ errs.T).real


def coefficients(B_prev, row, slot: int, n_valid: int):
    """DIIS coefficients after inserting an error in ``slot``: its Gram
    ``row`` (m,) against the ring (zero past ``n_valid``) refreshes row and
    column ``slot`` of ``B_prev``.  Returns ``(B_raw, c, info)`` with ``c``
    (m,) zero on invalid slots and ``info`` from ``solve_ex``.

    The ring fills slots 0, 1, … in order, so the valid window is the
    leading ``n_valid`` slots and the masked, bordered (m+1)² system of the
    JAX package decouples into the (n_valid+1)² system solved here plus an
    identity block whose coefficients are exactly 0."""
    m = B_prev.shape[0]
    B_raw = B_prev.clone()
    B_raw[slot, :] = row
    B_raw[:, slot] = row
    n = n_valid
    B = B_raw[:n, :n]
    beta = torch.diagonal(B).max().clamp_min(1e-300)
    L = B.new_zeros((n + 1, n + 1))
    L[:n, :n] = B / beta
    torch.diagonal(L)[:n] += 1e-14
    L[:n, n] = -1.0
    L[n, :n] = -1.0
    rhs = B.new_zeros(n + 1)
    rhs[n] = -1.0
    sol, info = torch.linalg.solve_ex(L, rhs)
    c = B.new_zeros(m)
    c[:n] = sol[:n]
    return B_raw, c, info


def mix(state: DIISState, err_flat, amp_flat):
    """Insert (err, amp), solve the DIIS system, return (new_state, mixed).

    Updates the rings of ``state`` in place; raises if the bordered system
    is singular (this entry point syncs; the CCD loop uses
    :func:`coefficients` and checks ``info`` once)."""
    m = state.amps.shape[0]
    slot = state.count % m
    n_valid = min(state.count + 1, m)
    state.amps[slot] = amp_flat
    state.errs[slot] = err_flat
    row = state.amps.new_zeros(m)
    row[:n_valid] = (state.errs[:n_valid] * err_flat[None, :]).sum(dim=1)
    B_raw, c, info = coefficients(state.B, row, slot, n_valid)
    if int(info) != 0:
        raise RuntimeError(f"DIIS system singular (info={int(info)})")
    mixed = (c[:n_valid, None] * state.amps[:n_valid]).sum(dim=0)
    return DIISState(amps=state.amps, errs=state.errs,
                     count=state.count + 1, B=B_raw), mixed


class DIIS:
    """Stateful wrapper with the reference list-of-tensors API:
    ``mix(errors, amplitudes)`` takes lists of tensors and returns the mixed
    amplitudes as a list with the original shapes."""

    def __init__(self, dim_space: int = 5):
        self.dim_space = dim_space
        self._state = None
        self._shapes = None

    def reset(self):
        self._state = None

    def mix(self, error, amplitude):
        err_flat = torch.cat([e.reshape(-1) for e in error])
        amp_flat = torch.cat([a.reshape(-1) for a in amplitude])
        if self._state is None:
            self._shapes = [a.shape for a in amplitude]
            self._state = init_state(self.dim_space, amp_flat.numel(),
                                     amp_flat.dtype, amp_flat.device)
        self._state, mixed = mix(self._state, err_flat, amp_flat)
        out, off = [], 0
        for shape in self._shapes:
            size = shape.numel()
            out.append(mixed[off:off + size].reshape(shape))
            off += size
        return out
