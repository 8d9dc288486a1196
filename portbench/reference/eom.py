"""Plain reference of closed-shell singlet EOM-CCSD on a CCD ground state
(T1 = 0, as momentum conservation makes it for canonical HF orbitals of
the gas): the sigma H̄·(u1, u2) term by term as the closed-shell
quantwo-generated equations of pymes' ``eom_ccsd.py`` list them (singles
block; the doubles' 18 u1 and 22 u2 terms under P(ijab, jiba), then the
four unsymmetrised ones), contracted pairwise in a cheap order, and a
Davidson eigensolver with maximum-overlap root tracking from unit-vector
guesses at the lowest ε_a − ε_i gaps, taken far past the program's
stopping test.  u1 is [a,i], u2 and T are [a,b,i,j].
"""

import numpy as np
import torch

from portbench.reference import ueg

EOM_BLOCKS = ("klij", "ijab", "abij", "iajb", "iabj", "ijka", "ijak",
              "iajk", "iabc", "abic")


class Hbar:
    """The pieces of H̄ that do not depend on the trial vector."""

    def __init__(self, p, T):
        es = torch.einsum
        V = p.V
        Vo = V["ijab"]
        self.p, self.T = p, T
        self.f_oo, self.f_vv = torch.diag(p.eps_i), torch.diag(p.eps_a)
        # singles: u1-on-(i/a) intermediates of the V·T·u1 terms
        self.Y_ca = (-2.0 * es("jkbc,bajk->ca", Vo, T)
                     + es("jkbc,abjk->ca", Vo, T))
        self.Z_ki = (-2.0 * es("jkbc,bcji->ki", Vo, T)
                     + es("jkcb,bcji->ki", Vo, T))
        # doubles, u2 terms: ring intermediates [l,d,a,i]
        self.A1 = es("klcd,caki->ldai", Vo, T)
        self.A2 = es("klcd,acki->ldai", Vo, T)
        self.A3 = es("kldc,caki->ldai", Vo, T)
        self.A4 = es("kldc,acki->ldai", Vo, T)
        self.B1 = es("klcd,cakl->da", Vo, T)
        self.B2 = es("klcd,ackl->da", Vo, T)
        self.C1 = es("klcd,cdki->li", Vo, T)
        self.C2 = es("kldc,cdki->li", Vo, T)
        self.W_lkij = es("lkcd,cdij->lkij", Vo, T)
        # doubles, u1 term 16: Σ_cd <la|cd> T[c,d,j,i]
        self.W_laji = es("lacd,cdji->laji", V["iabc"], T)


def sigma(h, u1, u2):
    """(σ1 [a,i], σ2 [a,b,i,j]) = H̄·(u1, u2)."""
    es = torch.einsum
    p, T, V = h.p, h.T, h.p.V
    Vo = V["ijab"]

    w = es("ab,bi->ai", h.f_vv, u1) - es("ji,aj->ai", h.f_oo, u1)
    w = w + 2.0 * es("jabi,bj->ai", V["iabj"], u1)
    w = w - es("jaib,bj->ai", V["iajb"], u1)
    w = w - 2.0 * es("jkib,abjk->ai", V["ijka"], u2)
    w = w + 2.0 * es("jabc,bcji->ai", V["iabc"], u2)
    w = w + es("jkib,bajk->ai", V["ijka"], u2)
    w = w - es("jacb,bcji->ai", V["iabc"], u2)
    X_jb = 2.0 * es("jkbc,ck->jb", Vo, u1) - es("jkcb,ck->jb", Vo, u1)
    w = w + 2.0 * es("jb,baji->ai", X_jb, T) - es("jb,abji->ai", X_jb, T)
    w = w + es("ca,ci->ai", h.Y_ca, u1) + es("ak,ki->ai", u1, h.Z_ki)

    # doubles, linear in u1
    x_ki = es("klid,dl->ki", V["ijka"], u1)
    d = -2.0 * es("ki,abkj->abij", x_ki, T)
    d = d - 2.0 * es("kcia,cbkj->abij", es("klci,al->kcia", V["ijak"], u1),
                     T)
    x_kaci = es("kacd,di->kaci", V["iabc"], u1)
    d = d + 2.0 * es("kaci,cbkj->abij", x_kaci, T)
    x_ac = es("ladc,dl->ac", V["iabc"], u1)
    d = d + 2.0 * es("ac,cbij->abij", x_ac, T)
    d = d + es("klij,abkl->abij", es("klid,dj->klij", V["ijka"], u1), T)
    d = d + es("kica,cbkj->abij", es("klic,al->kica", V["ijka"], u1), T)
    d = d + es("kidb,adkj->abij", es("klid,bl->kidb", V["ijka"], u1), T)
    d = d - es("ak,kbij->abij", u1, V["iajk"])
    d = d + es("kdia,bdkj->abij", es("kldi,al->kdia", V["ijak"], u1), T)
    d = d - es("kaci,bckj->abij", x_kaci, T)
    d = d + es("ki,abkj->abij", es("kldi,dl->ki", V["ijak"], u1), T)
    y_kaci = es("kadc,di->kaci", V["iabc"], u1)
    d = d - es("kaci,cbkj->abij", y_kaci, T)
    d = d - es("kacj,bcki->abij", y_kaci, T)
    d = d - es("bl,laji->abij", u1, h.W_laji)
    d = d - es("ac,cbij->abij", es("lacd,dl->ac", V["iabc"], u1), T)
    d = d + es("abic,cj->abij", V["abic"], u1)

    # doubles, linear in u2
    d = d + 4.0 * es("ldai,dblj->abij", h.A1, u2)
    d = d - 2.0 * es("da,dbij->abij", h.B1, u2)
    d = d - 2.0 * es("li,ablj->abij", h.C1, u2)
    d = d - 2.0 * es("ldai,bdlj->abij", h.A1, u2)
    d = d + 2.0 * es("kaci,cbkj->abij", V["iabj"], u2)
    d = d - 2.0 * es("ldai,dblj->abij", h.A2, u2)
    d = d - 2.0 * es("ldai,dblj->abij", h.A3, u2)
    d = d - 2.0 * es("ki,abkj->abij", es("kldc,dcil->ki", Vo, u2), T)
    d = d - 2.0 * es("ca,cbij->abij", es("lkcd,adlk->ca", Vo, u2), T)
    d = d - es("ki,abkj->abij", h.f_oo, u2)
    d = d + es("ac,cbij->abij", h.f_vv, u2)
    d = d - es("kaic,cbkj->abij", V["iajb"], u2)
    d = d - es("kbic,ackj->abij", V["iajb"], u2)
    d = d + es("da,dbij->abij", h.B2, u2)
    d = d + es("li,ablj->abij", h.C2, u2)
    d = d + es("ldai,bdlj->abij", h.A2, u2)
    d = d - es("kaci,bckj->abij", V["iabj"], u2)
    d = d + es("ldai,dblj->abij", h.A4, u2)
    d = d + es("ki,abkj->abij", es("kldc,dcli->ki", Vo, u2), T)
    d = d + es("ldai,dbjl->abij", h.A3, u2)
    d = d + es("ldaj,dbil->abij", h.A4, u2)
    d = d + es("ca,cbij->abij", es("lkcd,dalk->ca", Vo, u2), T)

    d = d + d.permute(1, 0, 3, 2)
    d = d + es("klij,abkl->abij", V["klij"], u2)
    d = d + es("klij,abkl->abij", es("kldc,dcij->klij", Vo, u2), T)
    d = d + es("lkij,ablk->abij", h.W_lkij, u2)
    d = d + ueg.ladder(p.ladder, u2)
    return w, d


def davidson(h, n_roots, tol=1e-11, res_tol=1e-6, max_iter=300,
             max_dim=24):
    """The ``n_roots`` roots tracked from unit guesses at the lowest
    ε_a − ε_i gaps (sorted), converged until the roots move by less than
    ``tol`` and every residual norm is below ``res_tol``; returns
    (roots, iterations, Ritz vectors (n_roots, N)), in the roots' order."""
    p = h.p
    no, nv = p.no, p.nv
    n1 = nv * no
    dt, dev = p.eps_a.dtype, p.eps_a.device
    # as far as the type allows: float32 stops at its rounding floor
    eps = torch.finfo(dt).eps
    tol, res_tol = max(tol, 1e3 * eps), max(res_tol, 1e3 * eps)
    gaps = (p.eps_a[:, None] - p.eps_i[None, :]).reshape(-1)
    diag = torch.cat([gaps, (-p.denominators()).reshape(-1)])
    N = diag.shape[0]
    guesses = torch.argsort(gaps.cpu(), stable=True)[:n_roots]

    def apply(x):
        s1, s2 = sigma(h, x[:n1].reshape(nv, no), x[n1:].reshape(nv, nv, no,
                                                                  no))
        return torch.cat([s1.reshape(-1), s2.reshape(-1)])

    U = torch.zeros((n_roots, N), dtype=dt, device=dev)
    U[torch.arange(n_roots), guesses.to(dev)] = 1.0
    W = torch.stack([apply(u) for u in U])
    prev = np.eye(n_roots)              # tracked vectors in U's coordinates
    theta = np.zeros(n_roots)
    for it in range(1, max_iter + 1):
        B = (U @ W.T).double().cpu().numpy()       # B[i,j] = <u_i|H̄ u_j>
        ev, vec = np.linalg.eig(B)
        m = B.shape[0]
        O = np.abs(vec[: prev.shape[0]].conj().T @ prev) ** 2
        sel = np.empty(n_roots, dtype=int)
        for _ in range(n_roots):
            k, j = np.unravel_index(np.argmax(O), O.shape)
            sel[j] = k
            O[k, :] = -1.0
            O[:, j] = -1.0
        order = sel[np.argsort(ev[sel].real)]
        y = np.real(vec[:, order])
        new = np.real(ev[order])
        Y = torch.as_tensor(y, dtype=dt, device=dev)
        th = torch.as_tensor(new, dtype=dt, device=dev)[:, None]
        X = Y.T @ U
        R = Y.T @ W - th * X
        rn = R.norm(dim=1).double().cpu().numpy()
        moved = np.max(np.abs(new - theta))
        theta = new
        if it > 1 and moved < tol and np.max(rn) < res_tol:
            break
        if m + n_roots > max_dim:
            # restart on the Ritz vectors; x_j = Σ_i q_i r_ij
            q, r = torch.linalg.qr(X.T)
            U = q.T.contiguous()
            W = torch.linalg.solve_triangular(r.T, Y.T @ W, upper=False)
            r = r.double().cpu().numpy()
            prev = r / np.linalg.norm(r, axis=0)
            continue
        prev = np.real(vec[:, order])
        den = th - diag[None, :]
        den = torch.where(den.abs() > 1e-8, den, torch.full_like(den, 1e-8))
        for c in R / den:
            for _ in range(2):
                c = c - U.T @ (U @ c)
            nrm = c.norm()
            if float(nrm) > 1e-10:
                c = c / nrm
                U = torch.cat([U, c[None]])
                W = torch.cat([W, apply(c)[None]])
    order = np.argsort(theta)
    return theta[order], it, X[torch.as_tensor(order, device=dev)]
