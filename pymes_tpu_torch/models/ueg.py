"""3D uniform electron gas (UEG): host integral generation + device upload.

Host part: a numpy copy of the Coulomb slice of ``pymes_tpu/models/ueg.py``
(``UEG`` basis set-up, the per-component-bounds momentum lookup, the
momentum-conserving index lists and ``eval_2b_integrals`` with
``correlator=None``).  The port carries its own copy because importing
``pymes_tpu`` imports jax; ``tests/test_torch_import.py`` holds the integral
lists of the two copies identical.  The transcorrelated integral classes
(correlators, 3-body terms) are not ported yet and raise.

Device part: :func:`sparse_to_dense` / :func:`sparse_to_blocks` scatter the
momentum-sparse (indices, values) list onto the device with one flat
``index_put_`` per block.  The indices are unique, so no accumulate is
needed, and int64 indices are fine (the JAX package's int32 guard existed
only for a TPU scatter miscompile).
"""

import numpy as np
import torch

from pymes_tpu_torch.basis_set import planewave
from pymes_tpu_torch.config import DTYPE, resolve_device
from pymes_tpu_torch.integral.partition import BLOCK_NAMES, OCC_LETTERS


class UEG:
    """Closed-shell 3D uniform electron gas in a cubic box."""

    def __init__(self, n_ele, n_alpha, n_beta, rs):
        if n_ele % 2 != 0:
            import warnings
            warnings.warn("Only closed-shell (even electron) systems are "
                          "supported.")
        self.n_ele = int(n_ele)
        self.n_alpha = int(n_alpha)
        self.n_beta = int(n_beta)
        self.rs = rs
        self.L = rs * ((4 * np.pi * self.n_ele) / 3) ** (1.0 / 3.0)
        self.Omega = self.L ** 3

        self.basis = None           # PlaneWaveBasis (array-native)
        self.basis_fns = None       # reference-style spin-orbital tuple
        self.imax = 0
        self.cutoff = 0.0
        self.basis_indices_map = None

    # --- basis -----------------------------------------------------------
    def init_single_basis(self, cutoff, k_shift=(0.0, 0.0, 0.0)):
        """Build the plane-wave basis within the kinetic-energy cutoff
        (units of (2π/L)²/2) with an optional twist shift (units 2π/L)."""
        self.cutoff = cutoff
        self.basis = planewave.build_basis(cutoff, self.L, k_shift)
        self.imax = self.basis.imax
        self.basis_indices_map = self.basis.index_map
        self.basis_fns = self.basis.spin_orbitals()
        return self.basis_fns

    @property
    def n_spatial(self):
        return self.basis.n_spatial

    def _lookup_flat(self, k_int):
        """k-vector → orbital lookup with PER-COMPONENT bounds checking
        (−1 = outside the basis).  The reference checks only the flattened
        index range and aliases out-of-range components into neighbouring
        rows; the JAX package fixed that (``pymes_tpu/models/ueg.py:81-98``)
        and this copy keeps the fix."""
        n = 2 * self.imax + 1
        off = k_int + self.imax
        valid = np.all((off >= 0) & (off < n), axis=-1)
        loc = (n * n * off[..., 0] + n * off[..., 1] + off[..., 2])
        idx = self.basis_indices_map[np.clip(loc, 0, n ** 3 - 1)]
        return np.where(valid, idx, -1)

    # --- kinetic ---------------------------------------------------------
    def kinetic_energies(self):
        """(nP,) kinetic energies |kp|²/2 of the spatial orbitals."""
        return self.basis.kinetic.copy()

    # --- 2-body integrals ------------------------------------------------
    def eval_2b_integrals(self, correlator=None, sp=1, **integral_flags):
        """Coulomb 2-body integrals V[p,q,r,s] = 4π/|k_r − k_p|²/Ω on the
        momentum-conserving set (host numpy).

        ``sp=2`` returns the sparse ``(indices (nnz, 4), values)`` list;
        otherwise the dense (nP,)*4 array.  Transcorrelated classes
        (``correlator`` or any class flag) are not ported yet."""
        if correlator is not None or any(integral_flags.values()):
            raise NotImplementedError(
                "only the Coulomb integral class is ported; the "
                "transcorrelated classes are on the ROADMAP (queue A)")
        if self.basis is None:
            raise ValueError("Basis functions not initialized!")

        n_p = self.n_spatial
        k_int = self.basis.k_int           # (nP, 3) ints
        kp = self.basis.kp                 # (nP, 3) floats

        # momentum transfers for all (p, r)
        d_int = k_int[None, :, :] - k_int[:, None, :]      # (p, r, 3)
        d_kvec = kp[None, :, :] - kp[:, None, :]           # (p, r, 3)
        dk2 = np.einsum("prx,prx->pr", d_kvec, d_kvec)     # (p, r)
        has_dk = np.abs(dk2) > 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            w_pr = np.where(has_dk, 4.0 * np.pi / np.where(has_dk, dk2, 1.0)
                            / self.Omega, 0.0)

        pq, qq, rq, sq, pr_flat = self._conserving_index_lists(d_int)
        vals = w_pr.ravel()[pr_flat]
        idx = np.stack([pq, qq, rq, sq], axis=1)
        if sp == 2:
            return idx, vals
        V = np.zeros([n_p] * 4)
        V[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]] = vals
        return V

    def _conserving_index_lists(self, d_int):
        """The momentum-conserving (p, q, r, s) tuples, grouped by
        transfer, without any O(nP³) temporary.

        ``s = lookup(k_q − d)`` depends on (p, r) only through the transfer
        ``d = k_r − k_p``; with ``n_d = O((4·imax+1)³)`` distinct transfers
        the lookup table is (n_d, nP) instead of (nP, nP, nP).  The tuple
        list is then the per-transfer product of the (p,r)-group and the
        valid (q,s)-list, expanded with O(nnz) repeats.

        Returns ``(p, q, r, s, pr_flat)`` with ``pr_flat = p·nP + r`` for
        gathering (p,r)-grid weights."""
        n_p = self.n_spatial
        k_int = self.basis.k_int
        d_flat = d_int.reshape(-1, 3)
        uniq_d, inv_pr = np.unique(d_flat, axis=0, return_inverse=True)
        inv_pr = inv_pr.reshape(-1)

        s_dq = self._lookup_flat(k_int[None, :, :] - uniq_d[:, None, :])
        valid_dq = s_dq >= 0
        counts_qs = valid_dq.sum(axis=1).astype(np.int64)   # per transfer
        dq_q = np.nonzero(valid_dq)[1]                      # grouped by d
        dq_s = s_dq[valid_dq]
        qs_starts = np.concatenate(([0], np.cumsum(counts_qs)[:-1]))

        order_pr = np.argsort(inv_pr, kind="stable")        # group pairs by d
        d_of_pr = inv_pr[order_pr]
        nqs_per_pr = counts_qs[d_of_pr]                     # block lengths
        ends = np.cumsum(nqs_per_pr)
        total = int(ends[-1]) if len(ends) else 0
        starts = ends - nqs_per_pr
        intra = np.arange(total, dtype=np.int64) - np.repeat(starts,
                                                             nqs_per_pr)
        qs_sel = np.repeat(qs_starts[d_of_pr], nqs_per_pr) + intra
        pr_flat = np.repeat(order_pr, nqs_per_pr)
        return (pr_flat // n_p, dq_q[qs_sel], pr_flat % n_p, dq_s[qs_sel],
                pr_flat)


def sparse_to_dense(idx, vals, n_p, device):
    """Scatter a sparse (indices, values) integral set to the dense
    (nP,)*4 tensor on ``device`` (one flat ``index_put_``)."""
    dev = resolve_device(device)
    idx = np.asarray(idx, dtype=np.int64)
    flat = ((idx[:, 0] * n_p + idx[:, 1]) * n_p + idx[:, 2]) * n_p + idx[:, 3]
    V = torch.zeros(n_p ** 4, dtype=DTYPE, device=dev)
    V.index_put_((torch.as_tensor(flat, device=dev),),
                  torch.as_tensor(np.asarray(vals), dtype=DTYPE, device=dev))
    return V.reshape((n_p,) * 4)


def sparse_to_blocks(idx, vals, n_p, no, device, names=None):
    """Scatter a sparse integral set directly into the named o/v blocks on
    ``device``, never building the dense nP⁴ tensor.  Returns a dict
    name → tensor (the block of ``V[p,q,r,s]`` whose slots follow the
    letters of the name: i..l occupied, a..d virtual)."""
    dev = resolve_device(device)
    if names is None:
        names = BLOCK_NAMES
    idx = np.asarray(idx, dtype=np.int64)
    vals = np.asarray(vals)
    is_occ = idx < no
    out = {}
    for name in names:
        want = [c in OCC_LETTERS for c in name]
        mask = np.ones(len(vals), dtype=bool)
        for slot, w in enumerate(want):
            mask &= (is_occ[:, slot] == w)
        sub = idx[mask]
        dims = [no if w else n_p - no for w in want]
        flat = np.zeros(len(sub), dtype=np.int64)
        for slot, w in enumerate(want):
            flat = flat * dims[slot] + (sub[:, slot] if w
                                        else sub[:, slot] - no)
        block = torch.zeros(int(np.prod(dims)), dtype=DTYPE, device=dev)
        block.index_put_((torch.as_tensor(flat, device=dev),),
                         torch.as_tensor(vals[mask], dtype=DTYPE, device=dev))
        out[name] = block.reshape(dims)
    return out
