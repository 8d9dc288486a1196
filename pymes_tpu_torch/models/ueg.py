"""3D uniform electron gas (UEG): host integral generation + device upload.

Host part: a numpy copy of ``pymes_tpu/models/ueg.py`` — the ``UEG`` basis
set-up, the per-component-bounds momentum lookup, the momentum-conserving
index lists, ``eval_2b_integrals`` with every integral class (Coulomb, the
transcorrelated pure 2-body, hermitian and non-hermitian splits, RPA-type
and exchange-type single contractions of the 3-body term, effective
2-body), the 6-index 3-body tensor ``eval_3b_integrals``, the double and
triple 3-body contractions (mean-field corrections), the eight correlators
and ``calcGamma``.  The port carries its own copy because importing
``pymes_tpu`` imports jax; ``tests/test_torch_import.py`` and
``tests/test_torch_tc_ueg.py`` hold the two copies' results identical.

Device part: :func:`sparse_to_dense` / :func:`sparse_to_blocks` scatter the
momentum-sparse (indices, values) list into the named blocks (the dense
tensor is the one block of no occupied orbitals) through
:func:`pymes_tpu_torch.kernels.block_scatter.block_scatter`: on the card
K10, one upload of the list and one launch that sorts each entry into its
block; on the CPU its twin, host masks and one flat ``index_put_`` a
block.  The indices are unique, so no accumulate is needed, and offsets
are int64 (the JAX package's int32 guard existed only for a TPU scatter
miscompile).

Notes carried over from the JAX package:

* momentum lookups check every component against ``[−imax, imax]``; the
  reference checks only the flattened index range and aliases
  out-of-range components into neighbouring rows.
* correlator cutoff comparisons: the 2-body evaluator calls the
  correlators with ``scalar_path=True``, the contraction helpers without;
  for ``gaskell`` (and ``gaskell_modified``) the two paths differ at the
  cutoff boundary (strict ``<`` against ``<=``).
"""

import numpy as np
from scipy import special

from pymes_tpu_torch.basis_set import planewave
from pymes_tpu_torch.config import check_f64, resolve_device
from pymes_tpu_torch.kernels.block_scatter import block_scatter
from pymes_tpu_torch.log import print_logging_info


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
        self.kPrime = None
        self.correlator = None
        self.k_cutoff = None
        self.gamma = None

    # --- basis -----------------------------------------------------------
    def is_k_in_basis(self, ke):
        return ke <= self.cutoff * (2 * np.pi / self.L) ** 2 / 2.0

    def init_single_basis(self, cutoff, k_shift=(0.0, 0.0, 0.0)):
        """Build the plane-wave basis within the kinetic-energy cutoff
        (units of (2π/L)²/2) with an optional twist shift (units 2π/L)."""
        self.cutoff = cutoff
        self.basis = planewave.build_basis(cutoff, self.L, k_shift)
        self.imax = self.basis.imax
        self.basis_indices_map = self.basis.index_map
        self.basis_fns = self.basis.spin_orbitals()
        return self.basis_fns

    def init_basis_indices_map(self):
        self.basis_indices_map = self.basis.index_map

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
    def eval_2b_integrals(self, correlator=None,
                          is_rpa_approx=False,
                          is_only_2b=False,
                          is_only_non_hermi_2b=False,
                          is_only_hermi_2b=False,
                          is_effect_2b=False,
                          is_exchange_1=False,
                          is_exchange_2=False,
                          is_exchange_3=False,
                          dtype=np.float64,
                          sp=1):
        """Vectorized 2-body integral generation V[p,q,r,s].

        Same integral classes and flags as ``pymes/model/ueg.py:265``; the
        momentum transfer is q1 = k_r − k_p and s is fixed by momentum
        conservation k_s = k_q − q1 through the flat lookup.
        """
        if self.basis is None:
            raise ValueError("Basis functions not initialized!")
        if correlator is not None:
            self.correlator = correlator
            print_logging_info("Using TC method", level=1)
            print_logging_info("Using correlator: ", correlator.__name__,
                               level=1)

        n_p = self.n_spatial
        k_int = self.basis.k_int           # (nP, 3) ints
        kp = self.basis.kp                 # (nP, 3) floats

        # momentum transfers for all (p, r)
        d_int = k_int[None, :, :] - k_int[:, None, :]      # (p, r, 3)
        d_kvec = kp[None, :, :] - kp[:, None, :]           # (p, r, 3)
        dk2 = np.einsum("prx,prx->pr", d_kvec, d_kvec)     # (p, r)

        has_dk = np.abs(dk2) > 0.0
        w_pr = np.zeros((n_p, n_p), dtype=dtype)     # (p,r)-only weights
        need_nh = False                              # add the (p,q,r) term

        def corr(x):
            return _call_correlator(self.correlator, x, scalar_path=True)

        if correlator is None:
            with np.errstate(divide="ignore", invalid="ignore"):
                w_pr = np.where(has_dk, 4.0 * np.pi / np.where(has_dk, dk2, 1.0)
                                / self.Omega, 0.0)
        elif is_rpa_approx:
            u = corr(dk2)
            w_pr = np.where(has_dk,
                            -self.n_ele * dk2 * u ** 2 / self.Omega ** 2, 0.0)
        elif is_only_2b or is_only_hermi_2b or is_only_non_hermi_2b:
            u_dk = corr(dk2)
            coul = np.where(has_dk, 4.0 * np.pi
                            / np.where(has_dk, dk2, 1.0), 0.0)
            if is_only_non_hermi_2b:
                herm = np.zeros_like(dk2)
                u_mat = np.zeros_like(dk2)
            else:
                u_mat = self._sum_nabla_u_squared(d_int, d_kvec)
                herm = dk2 * u_dk
            base = coul + u_mat + herm                       # (p, r)
            if is_only_hermi_2b:
                w_pr = np.where(has_dk, base / self.Omega,
                                u_mat / self.Omega)
            elif is_only_non_hermi_2b:
                w_pr = np.where(has_dk, coul / self.Omega, 0.0)
                need_nh = True
            else:
                w_pr = np.where(has_dk, base / self.Omega,
                                u_mat / self.Omega)
                need_nh = True
        elif is_effect_2b or is_exchange_1 or is_exchange_2 or is_exchange_3:
            # Σ_i u(k²) u((p−i)²) (p−i)·k at p_vec = kp_r (ex1), kp_p (ex2)
            ex1 = self._contract_exchange_3b_vec(kp[None, :, :], d_kvec)
            ex2 = self._contract_exchange_3b_vec(kp[:, None, :], d_kvec)
            ex3 = self._contract_pk_with_q_vec(kp[None, :, :], d_kvec)
            if is_exchange_1:
                w_pr = np.where(has_dk, 2.0 * ex1 / self.Omega, 0.0)
            elif is_exchange_2:
                w_pr = np.where(has_dk, -2.0 * ex2 / self.Omega, 0.0)
            elif is_exchange_3:
                w_pr = 2.0 * ex3 / self.Omega
            else:
                u = corr(dk2)
                rpa = -self.n_ele * dk2 * u ** 2 / self.Omega
                w_pr = np.where(has_dk,
                                (rpa + 2.0 * ex1 - 2.0 * ex2 + 2.0 * ex3)
                                / self.Omega,
                                2.0 * ex3 / self.Omega)
        else:
            raise ValueError("No integral class selected for correlator run")

        # momentum-conserving nonzero set WITHOUT any O(nP³) temporary (the
        # reference loops over tuples in Python, ``pymes/model/ueg.py:384-
        # 507``): s is fixed by the transfer d = k_r − k_p, of which only
        # O((4·imax+1)³) ≪ nP² are distinct — look up s once per (d, q),
        # then expand the (p,r)-groups × (q,s)-lists per transfer with
        # O(nnz) vectorized index arithmetic.
        pq, qq, rq, sq, pr_flat = self._conserving_index_lists(d_int)
        vals = w_pr.ravel()[pr_flat]
        if need_nh:
            # non-hermitian term −(kp_r − kp_s)·dk·u(dk²)/Ω on the
            # expanded entries (same per-element arithmetic as the dense
            # construction; O(nnz))
            rs_dk = kp[rq] - kp[sq]
            dv = d_kvec.reshape(-1, 3)[pr_flat]
            u_e = corr(dk2).ravel()[pr_flat]
            vals = vals + np.where(
                has_dk.ravel()[pr_flat],
                -np.einsum("nx,nx->n", rs_dk, dv) * u_e / self.Omega, 0.0)
        vals = vals.astype(dtype, copy=False)
        idx = np.stack([pq, qq, rq, sq], axis=1)

        if sp == 2:
            # sparse return: (indices (nnz, 4), values) — only ~1/nP of the
            # dense tensor is nonzero by momentum conservation; the form to
            # ship to the card (sparse_to_blocks / sparse_to_dense).  The
            # effective class goes through a dense nP⁴ scatter here: small
            # bases only
            if is_effect_2b:
                V = _scatter_dense(idx, vals, n_p, dtype)
                V = 0.5 * (V + V.transpose(1, 0, 3, 2))
                nz = np.nonzero(V)
                return np.stack(nz, axis=1), V[nz]
            return idx, vals

        V = _scatter_dense(idx, vals, n_p, dtype)
        if is_effect_2b:
            V = 0.5 * (V + V.transpose(1, 0, 3, 2))
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

    # --- single-contraction kernels (vectorized over (p, r)) -------------
    def _occ_kp(self):
        return self.basis.kp[: self.n_ele // 2]

    def _contract_exchange_3b_vec(self, p_vec, k_vec):
        """Vectorized ``contract_exchange_3_body`` (``ueg.py:518``):
        Σ_i (p−i)·k u(k²) u((p−i)²) / Ω over occupied i, for (p,r) grids."""
        occ = self._occ_kp()                                  # (no, 3)
        pv = p_vec[..., None, :] - occ                        # (..., no, 3)
        k2 = np.einsum("...x,...x->...", k_vec, k_vec)
        pv2 = np.einsum("...nx,...nx->...n", pv, pv)
        pk = np.einsum("...nx,...x->...n", pv, k_vec)
        u_k = _call_correlator(self.correlator, k2)
        u_p = _call_correlator(self.correlator, pv2)
        return np.einsum("...n,...n->...", pk, u_p) * u_k / self.Omega

    def _contract_pk_with_q_vec(self, p_vec, k_vec):
        """Vectorized ``contractP_KWithQ`` (``ueg.py:545``):
        Σ_i (p−k−i)·(p−i) u((p−k−i)²) u((p−i)²) / Ω."""
        occ = self._occ_kp()
        v1 = p_vec[..., None, :] - k_vec[..., None, :] - occ
        v2 = p_vec[..., None, :] - occ
        dot = np.einsum("...nx,...nx->...n", v1, v2)
        v1s = np.einsum("...nx,...nx->...n", v1, v1)
        v2s = np.einsum("...nx,...nx->...n", v2, v2)
        u1 = _call_correlator(self.correlator, v1s)
        u2 = _call_correlator(self.correlator, v2s)
        return np.einsum("...n,...n->...", dot * u1, u2) / self.Omega

    # reference-signature scalar versions
    def contract_exchange_3_body(self, p_vec, kVec):
        return float(self._contract_exchange_3b_vec(np.asarray(p_vec),
                                                    np.asarray(kVec)))

    def contractP_KWithQ(self, pVec, kVec):
        return float(self._contract_pk_with_q_vec(np.asarray(pVec),
                                                  np.asarray(kVec)))

    def _sum_nabla_u_squared(self, d_int, d_kvec, cutoff=30):
        """Σ_{k'} k1·k2 u(k1²) u(k2²) / Ω with k2 = k − k1 (``ueg.py:581``),
        deduplicated over the distinct integer momentum transfers."""
        if self.kPrime is None:
            rng = np.arange(-cutoff, cutoff + 1)
            gi, gj, gk = np.meshgrid(rng, rng, rng, indexing="ij")
            self.kPrime = np.stack([gi.ravel(), gj.ravel(), gk.ravel()],
                                   axis=-1)
        k1 = 2 * np.pi * self.kPrime / self.L                 # (M, 3)
        k1sq = np.einsum("mx,mx->m", k1, k1)
        u1 = _call_correlator(self.correlator, k1sq)

        flat_int = d_int.reshape(-1, 3)
        uniq, inverse = np.unique(flat_int, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        uniq_kvec = uniq * 2 * np.pi / self.L
        out = np.zeros(len(uniq))
        # vectorized over blocks of transfers (the per-transfer Python loop
        # re-walked the 226k-point k' grid once per transfer); block size
        # bounds the (B, M) temporaries to ~150 MB
        n_grid = k1.shape[0]
        block = max(1, int(8e6) // n_grid)
        for lo in range(0, len(uniq), block):
            kv = uniq_kvec[lo:lo + block]                       # (B, 3)
            k1dk2 = kv @ k1.T - k1sq[None, :]                   # (B, M)
            # k2² via the exact difference (the expanded |kv|²−2kv·k1+k1²
            # form leaves ~1e-17 negatives where k1 = kv, flipping the
            # correlators' k² = 0 guards)
            k2 = kv[:, None, :] - k1[None, :, :]                # (B, M, 3)
            k2sq = np.einsum("bmx,bmx->bm", k2, k2)
            u2 = _call_correlator(self.correlator, k2sq)
            out[lo:lo + block] = np.einsum(
                "bm,m,bm->b", k1dk2, u1, u2) / self.Omega
        return out[inverse].reshape(d_int.shape[:-1])

    def sumNablaUSquare(self, k, cutoff=30):
        """Reference-signature scalar version (``ueg.py:581``)."""
        k = np.asarray(k, dtype=float)
        if self.kPrime is None:
            rng = np.arange(-cutoff, cutoff + 1)
            gi, gj, gk = np.meshgrid(rng, rng, rng, indexing="ij")
            self.kPrime = np.stack([gi.ravel(), gj.ravel(), gk.ravel()],
                                   axis=-1)
        k1 = 2 * np.pi * self.kPrime / self.L
        k2 = k[None, :] - k1
        k1sq = np.einsum("mx,mx->m", k1, k1)
        k2sq = np.einsum("mx,mx->m", k2, k2)
        k1dk2 = np.einsum("mx,mx->m", k1, k2)
        u1 = _call_correlator(self.correlator, k1sq)
        u2 = _call_correlator(self.correlator, k2sq)
        return float(np.sum(k1dk2 * u1 * u2) / self.Omega)

    # --- 3-body integrals ------------------------------------------------
    def eval_3b_integrals(self, correlator=None, dtype=np.float64, sp=1):
        """Full 6-index TC 3-body tensor L[o,p,q,r,s,t] (physicists' slot
        order as in ``ueg.py:174``), vectorized over the 5 free indices.

        w = −u(k1²) u(k2²) k1·k2 / (2Ω²) with k1 = kp_r − kp_o,
        k2 = kp_p − kp_s and t fixed by momentum conservation.
        """
        if self.basis is None:
            raise ValueError("Basis functions not initialized!")
        if correlator is None:
            self.correlator = self.trunc
        else:
            self.correlator = correlator

        n_p = self.n_spatial
        k_int = self.basis.k_int
        kp = self.basis.kp

        d1_int = k_int[None, :, :] - k_int[:, None, :]    # (o, r, 3) = k_r−k_o
        d2_int = k_int[:, None, :] - k_int[None, :, :]    # (p, s, 3) = k_p−k_s
        k1 = kp[None, :, :] - kp[:, None, :]              # (o, r, 3)
        k2 = kp[:, None, :] - kp[None, :, :]              # (p, s, 3)

        u1 = _call_correlator(self.correlator,
                              np.einsum("orx,orx->or", k1, k1))
        u2 = _call_correlator(self.correlator,
                              np.einsum("psx,psx->ps", k2, k2))
        k1_dot_k2 = np.einsum("orx,psx->orps", k1, k2)
        w = -(u1[:, :, None, None] * u2[None, None, :, :] * k1_dot_k2) \
            / 2.0 / self.Omega ** 2                        # (o, r, p, s)

        # t(o,r,p,s,q): k_t = −d1 + d2 + k_q; chunk over (o, r) to bound
        # the (r,p,s,q,3) index workspace at ~200 MB instead of nP⁴·24 B.
        # L itself is dense nP⁶: small bases only
        L = np.zeros([n_p] * 6, dtype=dtype)
        r_chunk = max(1, int(8e6) // max(1, n_p ** 3))
        for o in range(n_p):
            for r0 in range(0, n_p, r_chunk):
                r1 = min(r0 + r_chunk, n_p)
                t_int = (-d1_int[o, r0:r1, None, None, None, :]
                         + d2_int[None, :, :, None, :]
                         + k_int[None, None, None, :, :])  # (rc,p,s,q,3)
                t_idx = self._lookup_flat(t_int)           # (rc,p,s,q)
                rr, pp, ss, qq = np.nonzero(t_idx >= 0)
                tt = t_idx[rr, pp, ss, qq]
                L[o, pp, qq, rr + r0, ss, tt] = w[o, rr + r0, pp, ss]
        return L

    def contract3BodyIntegralsTo2Body(self, integrals):
        return 2 * np.einsum("opqrsq->oprs", integrals)

    # --- mean-field 3-body contractions ----------------------------------
    def triple_contractions_in_3_body(self):
        """Scalar TC energy shift from the triply-contracted 3-body term
        (direct + exchange diagrams; ``ueg.py:598``)."""
        occ = self._occ_kp()
        diff = occ[:, None, :] - occ[None, :, :]             # (p, q, 3)
        d2 = np.einsum("pqx,pqx->pq", diff, diff)
        u = _call_correlator(self.correlator, d2)

        dirE = np.sum(u ** 2 * d2) * self.n_ele / 2 / self.Omega ** 2 * 2

        po_dot_pq = np.einsum("pox,pqx->pqo", diff, diff)
        u_pq_u_po = np.einsum("pq,po->pqo", u, u)
        excE = -2 * 2 * np.einsum("pqo,pqo->", po_dot_pq, u_pq_u_po) \
            / 2.0 / self.Omega ** 2
        print_logging_info("Direct E = {:.8f}".format(dirE), level=2)
        print_logging_info("Exchange E = {:.8f}".format(excE), level=2)
        return dirE + excE

    def double_contractions_in_3_body(self):
        """One-particle energy corrections from doubly-contracted 3-body
        terms: perl, wave, shield and frog diagrams (``ueg.py:632``)."""
        num_p = self.n_spatial
        kp = self.basis.kp
        occ = self._occ_kp()

        diff_pi = kp[:, None, :] - occ[None, :, :]           # (p, i, 3)
        diff_pi2 = np.einsum("pix,pix->pi", diff_pi, diff_pi)
        u_pi = _call_correlator(self.correlator, diff_pi2)

        # perl: Σ_i u² (p−i)²
        e_perl = np.einsum("pi,pi->p", u_pi ** 2, diff_pi2)
        e_perl = 2.0 * self.n_ele / self.Omega ** 2 / 2 * e_perl

        # wave: −Σ_ij (p−i)·(p−j) u_pi u_pj
        dot_ij = np.einsum("pix,pjx->pij", diff_pi, diff_pi)
        u_ij = np.einsum("pi,pj->pij", u_pi, u_pi)
        e_wave = -np.einsum("pij,pij->p", dot_ij, u_ij) * 2 / self.Omega ** 2 / 2

        # shield: p-independent Σ_ij u(i−j)² (i−j)²
        diff_ij = occ[:, None, :] - occ[None, :, :]
        diff_ij2 = np.einsum("ijx,ijx->ij", diff_ij, diff_ij)
        u_oij = _call_correlator(self.correlator, diff_ij2)
        e_shield = np.einsum("ij,ij->", u_oij ** 2, diff_ij2) \
            * np.ones(num_p) * 2 / 2 / self.Omega ** 2

        # frog: Σ_ij (i−j)·(i−p) u_ij u_pi  (two equal diagram types → ×4)
        dot_frog = np.einsum("ijx,pix->ijp", diff_ij, -diff_pi)
        u_frog = np.einsum("ij,pi->ijp", u_oij, u_pi)
        e_frog = -np.einsum("ijp,ijp->p", dot_frog, u_frog) * 4 \
            / self.Omega ** 2 / 2

        return e_perl + e_wave + e_shield + e_frog

    # --- correlators -----------------------------------------------------
    def yukawa(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        rho = self.n_ele / self.Omega
        gamma_0 = np.sqrt(rho / 4.0 * np.pi)
        gamma = gamma_0 if self.gamma is None else self.gamma * gamma_0
        a = -4.0 * np.pi
        if self.k_cutoff is not None:
            k_cutoff_sq = self.k_cutoff * ((2 * np.pi / self.L) ** 2)
            denom = k_cutoff_sq + gamma
        else:
            denom = 1e-12
        kSquare = np.asarray(kSquare, dtype=float)
        b = kSquare + gamma
        return np.divide(a, b, out=np.zeros_like(b), where=np.abs(b) > denom)

    def trunc(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        """−4π/k⁴ above the correlator cutoff k_c, 0 below (``ueg.py:772``)."""
        if self.k_cutoff is None:
            self.k_cutoff = int(np.ceil(np.sqrt(self.cutoff)))
        if self.gamma is None:
            self.gamma = 1.0
        k_cutoff_sq = (self.k_cutoff * 2 * np.pi / self.L) ** 2
        kSquare = np.array(kSquare, dtype=float, copy=True)
        kSquare[kSquare <= k_cutoff_sq * (1 + 0.00001)] = 0.0
        result = np.divide(-4.0 * np.pi, kSquare ** 2,
                           out=np.zeros_like(kSquare),
                           where=(kSquare > 1e-12))
        return result * self.gamma

    def gaskell(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        """Gaskell/Bonev RPA-form correlator −μ/k² below the cutoff
        (``ueg.py:836``).  ``scalar_path=True`` applies the strict ``<``
        cutoff of the reference's scalar branch (used by the 2-body loop)."""
        rho = self.n_ele / self.Omega
        mu = np.sqrt(4.0 * np.pi / rho)
        k_fermi = self.basis.kp[self.n_ele // 2]
        delta_k_sq = k_fermi.dot(k_fermi)
        gamma = 1.0 if self.gamma is None else self.gamma
        mu *= gamma
        if self.k_cutoff is not None:
            k_cutoff_sq = self.k_cutoff ** 2 * delta_k_sq
        else:
            k_cutoff_sq = 4.0 * delta_k_sq
        kSquare = np.asarray(kSquare, dtype=float)
        result = np.divide(mu, kSquare, out=np.zeros_like(kSquare),
                           where=(kSquare > 1e-12))
        if scalar_path:
            result = np.where(kSquare >= k_cutoff_sq, 0.0, result)
        else:
            result = np.where(kSquare > k_cutoff_sq, 0.0, result)
        return -result

    def gaskell_modified(self, kSquare, multiply_by_k_square=False,
                         scalar_path=False):
        if self.k_cutoff is not None:
            k_cutoff_sq = (self.k_cutoff * (2 * np.pi / self.L)) ** 2
        else:
            k_cutoff_sq = 2
        mu = np.pi
        kSquare = np.asarray(kSquare, dtype=float)
        result = np.divide(4 * mu, kSquare ** 2, out=np.zeros_like(kSquare),
                           where=(kSquare >= k_cutoff_sq))
        return -result

    def smooth(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        if self.k_cutoff is None:
            self.k_cutoff = int(np.ceil(np.sqrt(self.cutoff)))
        if self.gamma is None:
            self.gamma = 0.01
        kc = self.k_cutoff * 2 * np.pi / self.L
        kSquare = np.asarray(kSquare, dtype=float)
        k = np.sqrt(kSquare)
        return np.divide(
            -4.0 * np.pi * (1.0 + special.erf((k - kc) / (kc * self.gamma)))
            / 2.0, kSquare ** 2, out=np.zeros_like(kSquare),
            where=kSquare > (kc * self.gamma) ** 2)

    def coulomb(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        gamma = 1.0 if self.gamma is None else self.gamma
        kSquare = np.asarray(kSquare, dtype=float)
        return np.divide(-4.0 * np.pi * gamma, kSquare,
                         out=np.zeros_like(kSquare), where=kSquare > 1e-12)

    def stg(self, kSquare, multiply_by_k_square=False, scalar_path=False):
        if self.gamma is None:
            rho = self.n_ele / self.Omega
            gamma = np.sqrt(4.0 * np.pi * rho)
        else:
            gamma = self.gamma
        a = -4.0 * np.pi / gamma
        if self.k_cutoff is not None:
            k_cutoff_sq = self.k_cutoff * ((2 * np.pi / self.L) ** 2)
            denom = (k_cutoff_sq + gamma ** 2) ** 2
        else:
            denom = 1e-12
        kSquare = np.asarray(kSquare, dtype=float)
        b = (kSquare + gamma ** 2) ** 2
        return np.divide(a, b, out=np.zeros_like(b), where=np.abs(b) > denom)

    def yukawa_coulomb(self, kSquare, multiply_by_k_square=False,
                       scalar_path=False):
        gamma = 1.5 if self.gamma is None else self.gamma
        A = np.sqrt(self.Omega / (4.0 * np.pi * self.n_ele))
        A = 1.0 / A * gamma
        a = -4.0 * np.pi
        if self.k_cutoff is not None:
            k_cutoff_sq = self.k_cutoff * ((2 * np.pi / self.L) ** 2)
            denom = k_cutoff_sq + A
        else:
            denom = 1e-12
        kSquare = np.asarray(kSquare, dtype=float)
        b = (kSquare + A) * kSquare
        return np.divide(a, b, out=np.zeros_like(b), where=np.abs(b) > denom)

    # --- CC4S density-fitting vertex -------------------------------------
    def calcGamma(self, overlap_basis, nP):
        """Fourier-transformed overlap densities Γ^p_q(G) (``ueg.py:970``;
        fixes the reference's ``self.basis``/``self.basis_fns`` attribute
        bug)."""
        if self.basis_fns is None:
            raise ValueError("Basis functions not initialized!")
        nG = int(len(overlap_basis) / 2)
        gamma_pqG = np.zeros((nP, nP, nG))
        k_int = self.basis.k_int
        G_int = np.array([overlap_basis[2 * g].k for g in range(nG)])
        G_kp = np.array([overlap_basis[2 * g].kp for g in range(nG)])
        G_sq = np.einsum("gx,gx->g", G_kp, G_kp)
        diff = k_int[:nP, None, :] - k_int[None, :nP, :]     # (p, q, 3)
        match = (diff[:, :, None, :] == G_int[None, None, :, :]).all(axis=-1)
        vals = np.where(np.abs(G_sq) > 1e-12,
                        np.sqrt(np.divide(4.0 * np.pi, G_sq,
                                          out=np.ones_like(G_sq),
                                          where=np.abs(G_sq) > 1e-12)
                                / self.Omega), 0.0)
        gamma_pqG = match * vals[None, None, :]
        return gamma_pqG


def _scatter_dense(idx, vals, n_p, dtype):
    V = np.zeros([n_p, n_p, n_p, n_p], dtype=dtype)
    V[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]] = vals
    return V


def sparse_to_dense(idx, vals, n_p, dtype=None, *, device=None):
    """Scatter a sparse (indices, values) integral set to the dense
    (nP,)*4 tensor on ``device`` (None: the card): :func:`sparse_to_blocks`
    with no occupied orbitals, whose one block ``abcd`` is the whole
    tensor.  ``dtype`` other than f64 raises ValueError."""
    check_f64(dtype, "sparse_to_dense")
    return block_scatter(idx, vals, n_p, 0, ("abcd",),
                         resolve_device(device))["abcd"]


def sparse_to_blocks(idx, vals, n_p, no, names=None, dtype=None, *,
                     device=None):
    """Scatter a sparse integral set directly into the named o/v blocks on
    ``device`` (None: the card), never building the dense nP⁴ tensor.
    Returns a dict name → tensor (the block of ``V[p,q,r,s]`` whose slots
    follow the letters of the name: i..l occupied, a..d virtual).
    ``dtype`` other than f64 raises ValueError."""
    check_f64(dtype, "sparse_to_blocks")
    return block_scatter(idx, vals, n_p, no, names, resolve_device(device))


def _call_correlator(correlator, kSquare, scalar_path=False):
    """Invoke a correlator; pass scalar_path only if it accepts the kwarg
    (user-supplied correlators need not)."""
    try:
        return correlator(kSquare, scalar_path=scalar_path)
    except TypeError:
        return correlator(kSquare)
