"""Plain reference of the closed-shell uniform electron gas in a plane-wave
basis: the basis of the nP lowest plane waves at a twist, the Hartree-Fock
orbital energies and the Coulomb integral blocks, worked out from the
physics alone (plain PyTorch; nothing of the program under test).

Units: the box is cubic with side L = rs·(4π·n_ele/3)^(1/3); a plane wave
has integer vector n and wave vector k = 2π(n + k_s)/L at the twist k_s.
The two-electron integral in physicists' order is

    <pq|rs> = 4π / (Ω |k_p − k_r|²)   if n_p + n_q = n_r + n_s, n_p ≠ n_r,

and 0 otherwise (the twist cancels in the transfer).  Orbitals are ordered
by kinetic energy, ties by the lexicographic order of n; the lowest n_ele/2
are occupied.  The particle-particle ladder acts through the virtual
⟨ab|cd⟩ as a sparse matrix over pairs, block-diagonal in the pair momentum.
"""

import math
import warnings

import numpy as np
import torch


def box(n_ele, rs):
    """(L, Ω) of the closed-shell gas."""
    L = rs * (4.0 * math.pi * n_ele / 3.0) ** (1.0 / 3.0)
    return L, L ** 3


def sorted_waves(twist, count):
    """Integer vectors (count + 1, 3) of the lowest |n + k_s|², in the
    order of the basis, and their |n + k_s|² (one more than asked for, so
    a caller can see the gap above the last)."""
    ks = np.asarray(twist, dtype=np.float64)
    r = 1
    while (2 * r - 1) ** 3 * math.pi / 6.0 < 2 * (count + 1):
        r += 1
    r += 2
    g = np.arange(-r, r + 1)
    n = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    e = ((n + ks) ** 2).sum(1)
    order = np.argsort(e, kind="stable")[: count + 1]
    return n[order], e[order]


class Gas:
    """The gas of ``n_ele`` electrons at ``rs`` in the basis of the ``n_p``
    lowest plane waves at ``twist``, on ``device`` in ``dtype``."""

    def __init__(self, n_ele, rs, n_p, twist, device, dtype=torch.float64):
        self.no = n_ele // 2
        self.n_p = n_p
        self.nv = n_p - self.no
        self.L, self.Omega = box(n_ele, rs)
        n, _ = sorted_waves(twist, n_p)
        self.n_int = n[:n_p]
        self.device, self.dtype = device, dtype
        self.n = torch.as_tensor(self.n_int, dtype=torch.int64, device=device)
        kp = (torch.as_tensor(self.n_int, dtype=torch.float64)
              + torch.as_tensor(np.asarray(twist, np.float64)))
        self.kinetic = (0.5 * (2 * math.pi / self.L) ** 2
                        * (kp ** 2).sum(1)).to(device)
        # 4π/Ω over (2π/L)², times 1/|Δn|²
        self.pref = 4 * math.pi / self.Omega / (2 * math.pi / self.L) ** 2
        span = int(np.abs(self.n_int).max())
        self.base = 4 * span + 1
        c = self.n + span
        self.code = (c[:, 0] * self.base + c[:, 1]) * self.base + c[:, 2]

    def orbital_energies(self):
        """ε_p = |k_p|²/2 + Σ_j (2<pj|pj> − <pj|jp>) over the occupied j;
        <pj|pj> is a zero transfer, so ε_p = |k_p|²/2 − Σ_{j≠p} <pj|jp>."""
        occ = self.n[: self.no]
        d2 = ((self.n[:, None, :] - occ[None, :, :]) ** 2).sum(-1)
        d2 = d2.to(torch.float64)
        x = torch.where(d2 > 0, self.pref / d2.clamp(min=1),
                        torch.zeros_like(d2)).sum(1)
        return (self.kinetic - x).to(self.device, self.dtype)

    def _range(self, letter):
        return slice(0, self.no) if letter in "ijkl" else slice(self.no,
                                                                 self.n_p)

    def block(self, name):
        """Dense <pq|rs> over the index ranges of ``name`` (i..l occupied,
        a..d virtual), built in slices of its first index."""
        sl = [self._range(x) for x in name]
        cp, cq, cr, cs = (self.code[s] for s in sl)
        npv, nq, nr, ns = (self.n[s] for s in sl)
        out = torch.empty((len(cp), len(cq), len(cr), len(cs)),
                          dtype=self.dtype, device=self.device)
        for p0 in range(len(cp)):
            d2 = ((npv[p0][None, :] - nr) ** 2).sum(-1).to(torch.float64)
            w = torch.where(d2 > 0, self.pref / d2.clamp(min=1),
                            torch.zeros_like(d2))                # (r,)
            same = (cp[p0] + cq[:, None, None]
                    == cr[None, :, None] + cs[None, None, :])      # (q,r,s)
            out[p0] = (same * w[None, :, None]).to(self.dtype)
        return out

    def ladder_matrix(self):
        """The virtual <ab|cd> as a sparse CSR matrix (nv², nv²) over
        flat pairs a·nv + b, holding the entries of equal pair momentum
        and nonzero transfer."""
        nv = self.nv
        cv = self.code[self.no:]
        K = (cv[:, None] + cv[None, :]).reshape(-1)
        order = torch.argsort(K, stable=True)
        _, counts = torch.unique_consecutive(K[order], return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        m = torch.repeat_interleave(counts, counts)       # per sorted pair
        s = torch.repeat_interleave(starts, counts)
        rows = torch.repeat_interleave(order, m)
        first = torch.repeat_interleave(torch.cumsum(m, 0) - m, m)
        cols = order[torch.repeat_interleave(s, m)
                     + torch.arange(int(m.sum()), device=K.device) - first]
        nvv = self.n[self.no:]
        d2 = ((nvv[rows // nv] - nvv[cols // nv]) ** 2).sum(-1)
        keep = d2 > 0
        rows, cols, d2 = rows[keep], cols[keep], d2[keep]
        vals = (self.pref / d2.to(torch.float64)).to(self.dtype)
        V = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                    (nv * nv, nv * nv),
                                    check_invariants=False)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            return V.coalesce().to_sparse_csr()


def ladder(V, X):
    """Σ_cd <ab|cd> X[c,d,...] for X of shape (nv, nv, ...)."""
    nv = X.shape[0]
    rest = X.shape[2:]
    Y = torch.sparse.mm(V, X.reshape(nv * nv, -1))
    return Y.reshape((nv, nv) + tuple(rest))
