"""Plane-wave single-particle basis, array-native.

The reference (``pymes/basis_set/planewave.py:3``) represents the basis as a
Python list of per-orbital ``BasisFunc`` objects (spin-duplicated, sorted by
kinetic energy).  Vectorized integral generation wants the basis as dense
integer/float arrays, so the primary object here is :class:`PlaneWaveBasis`
holding ``(nP, 3)`` arrays; a per-orbital :class:`BasisFunc` shim is kept for
API compatibility with reference scripts.

A numpy copy of ``pymes_tpu/basis_set/planewave.py`` (the JAX package imports
jax on import, the port must not); ``tests/test_torch_import.py`` holds the
integrals built on the two copies identical.
"""

from dataclasses import dataclass, field

import numpy as np


class BasisFunc:
    """One plane wave exp(i kp·r) with wavevector ``kp = 2π(k+shift)/L``.

    API-compatible with the reference ``BasisFunc`` (attributes ``k``, ``kp``,
    ``kinetic``, ``spin``, ``L``; ordering by kinetic energy).
    """

    def __init__(self, i, j, k, L, spin, k_shift=(0.0, 0.0, 0.0)):
        self.k = np.array([i, j, k], dtype=int)
        self.L = L
        self.kp = (self.k + np.asarray(k_shift, dtype=float)) * 2.0 * np.pi / L
        self.kinetic = float(np.dot(self.kp, self.kp)) / 2.0
        if spin not in (-1, 1):
            raise RuntimeError("spin not +1 or -1")
        self.spin = spin

    def __repr__(self):
        return (tuple(self.k), self.kinetic, self.spin).__repr__()

    def __lt__(self, other):
        return self.kinetic < other.kinetic


@dataclass
class PlaneWaveBasis:
    """Closed-shell plane-wave basis as arrays over spatial orbitals.

    Attributes
    ----------
    k_int : (nP, 3) int array — integer wavevectors, sorted by kinetic energy
        (stable in the reference generation order: i, j, k loops ascending).
    kp : (nP, 3) float array — physical wavevectors ``2π(k+shift)/L``.
    kinetic : (nP,) float array — ``|kp|²/2``.
    L : box length; k_shift : twist in units of 2π/L; imax : max |k_i|.
    """

    k_int: np.ndarray
    kp: np.ndarray
    kinetic: np.ndarray
    L: float
    k_shift: np.ndarray
    imax: int
    _index_map: np.ndarray = field(default=None, repr=False)

    @property
    def n_spatial(self) -> int:
        return self.k_int.shape[0]

    @property
    def index_map(self) -> np.ndarray:
        """Flattened k-vector -> orbital-index lookup table.

        Entry ``map[(kx+imax)*(2imax+1)² + (ky+imax)*(2imax+1) + (kz+imax)]``
        is the orbital index of integer wavevector ``(kx,ky,kz)``, or −1 if
        that wavevector is outside the basis (mirrors the reference
        ``UEG.init_basis_indices_map``, ``pymes/model/ueg.py:105``).
        """
        if self._index_map is None:
            n = 2 * self.imax + 1
            m = -np.ones(n**3, dtype=np.int64)
            flat = ((self.k_int[:, 0] + self.imax) * n**2
                    + (self.k_int[:, 1] + self.imax) * n
                    + (self.k_int[:, 2] + self.imax))
            m[flat] = np.arange(self.n_spatial)
            self._index_map = m
        return self._index_map

    def lookup(self, k_int: np.ndarray) -> np.ndarray:
        """Map integer wavevectors (…, 3) to orbital indices (−1 = outside).

        Vectorized momentum-conservation lookup: out-of-range components are
        clipped into the table and masked to −1 afterwards.
        """
        n = 2 * self.imax + 1
        shifted = k_int + self.imax
        in_range = np.all((shifted >= 0) & (shifted < n), axis=-1)
        clipped = np.clip(shifted, 0, n - 1)
        flat = clipped[..., 0] * n**2 + clipped[..., 1] * n + clipped[..., 2]
        idx = self.index_map[flat]
        return np.where(in_range, idx, -1)

    def spin_orbitals(self):
        """Reference-style spin-duplicated sorted list of BasisFunc objects."""
        fns = []
        for kv in self.k_int:
            fns.append(BasisFunc(kv[0], kv[1], kv[2], self.L, 1, self.k_shift))
            fns.append(BasisFunc(kv[0], kv[1], kv[2], self.L, -1, self.k_shift))
        return tuple(fns)


def build_basis(cutoff: float, L: float, k_shift=(0.0, 0.0, 0.0)) -> PlaneWaveBasis:
    """Vectorized plane-wave basis generation within an energy cutoff.

    ``cutoff`` is in units of ``(2π/L)²/2`` exactly as in the reference
    (``pymes/model/ueg.py:128``); the twist ``k_shift`` is in units of 2π/L.
    Replaces the reference's O(imax³) Python loop with a meshgrid + mask and a
    stable argsort, preserving the reference's orbital ordering (the loop
    order i→j→k is the tie-break of the stable sort by kinetic energy).
    """
    k_shift = np.asarray(k_shift, dtype=float)
    imax = int(np.ceil(np.sqrt(cutoff + k_shift.dot(k_shift)))) + 1
    rng = np.arange(-imax, imax + 1)
    ki, kj, kk = np.meshgrid(rng, rng, rng, indexing="ij")
    k_int = np.stack([ki.ravel(), kj.ravel(), kk.ravel()], axis=-1)

    kp = (k_int + k_shift) * 2.0 * np.pi / L
    kinetic = 0.5 * np.einsum("ni,ni->n", kp, kp)
    keep = kinetic <= cutoff * (2.0 * np.pi / L) ** 2 / 2.0

    k_int, kp, kinetic = k_int[keep], kp[keep], kinetic[keep]
    order = np.argsort(kinetic, kind="stable")
    return PlaneWaveBasis(k_int=k_int[order], kp=kp[order],
                          kinetic=kinetic[order], L=L, k_shift=k_shift,
                          imax=imax)
