"""Plain reference of closed-shell CCD on the uniform electron gas: the
spin-adapted doubles residual (the diagrams of pymes' ``ccd.py``: both
ladders with the T2-renormalised hole ladder, the ring and crossed-ring
terms with 2T − T^x, the quadratic rings and the dressed one-particle
intermediates, symmetrised by P(ab,ij)), its energy, and a Jacobi + DIIS
fixed point taken far past the program's stopping test.  T is carried
[a,b,i,j].  With canonical HF orbitals of the gas T1 vanishes by momentum
conservation, so this is also the CCSD solution.
"""

import torch

from portbench.reference import ueg

CCD_BLOCKS = ("klij", "ijab", "abij", "iajb", "iabj")


class Problem:
    """Orbital energies, the CCD blocks and the ladder matrix of one
    gas (a :class:`portbench.reference.ueg.Gas`)."""

    def __init__(self, gas, names=CCD_BLOCKS):
        self.gas = gas
        self.no, self.nv = gas.no, gas.nv
        eps = gas.orbital_energies()
        self.eps_i, self.eps_a = eps[: self.no], eps[self.no:]
        self.V = {name: gas.block(name) for name in names}
        self.ladder = gas.ladder_matrix()

    def denominators(self):
        ei, ea = self.eps_i, self.eps_a
        return (ei[None, None, :, None] + ei[None, None, None, :]
                - ea[:, None, None, None] - ea[None, :, None, None])


def residual(p, T):
    """The CCD doubles residual R[a,b,i,j] (zero at the solution)."""
    es = torch.einsum
    V = p.V
    tilde = 2.0 * T - T.permute(1, 0, 2, 3)
    I_klij = V["klij"] + es("klcd,cdij->klij", V["ijab"], T)
    R = V["abij"] + es("klij,abkl->abij", I_klij, T) + ueg.ladder(p.ladder, T)
    X = es("klcd,adkj->alcj", V["ijab"], T)
    R = R + es("alcj,cbil->abij", X, T)
    X = es("klcd,dblj->cbkj", V["ijab"], tilde)
    R = R + es("acik,cbkj->abij", tilde, X)
    X_ac = torch.diag(p.eps_a) - es("adkl,lkdc->ac", tilde, V["ijab"])
    X_ki = torch.diag(p.eps_i) + es("cdil,lkdc->ki", tilde, V["ijab"])
    Ex = es("ac,cbij->abij", X_ac, T) - es("ki,abkj->abij", X_ki, T)
    Ex = Ex - es("kaic,cbkj->abij", V["iajb"], T)
    Ex = Ex - es("kbic,ackj->abij", V["iajb"], T)
    Ex = Ex + es("acik,kbcj->abij", tilde, V["iabj"])
    X = es("klcd,daki->alci", V["ijab"], T)
    Ex = Ex - es("alci,cblj->abij", X, T) + es("alci,bclj->abij", X, T)
    return R + Ex + Ex.permute(1, 0, 3, 2)


def energy(p, T):
    """E = Σ T[a,b,i,j] (2<ij|ab> − <ij|ba>)."""
    V = p.V["ijab"]
    return (2.0 * torch.sum(T * V.permute(2, 3, 0, 1))
            - torch.sum(T * V.permute(3, 2, 0, 1)))


def solve(p, shift=-1.0, tol=1e-13, max_iter=200, n_diis=8):
    """Jacobi + DIIS from the MP2 guess until the largest step is below
    ``tol`` times the largest amplitude; returns (E, T, iterations)."""
    D = p.denominators() + shift
    tol = max(tol, 10 * torch.finfo(D.dtype).eps)
    T = p.V["abij"] / D
    amps, errs = [], []
    for it in range(1, max_iter + 1):
        dT = residual(p, T) / D
        T = T + dT
        amps.append(T.reshape(-1))
        errs.append(dT.reshape(-1))
        amps, errs = amps[-n_diis:], errs[-n_diis:]
        m = len(errs)
        B = torch.zeros((m + 1, m + 1), dtype=torch.float64)
        E = torch.stack(errs)
        B[:m, :m] = (E @ E.T).to("cpu", torch.float64)
        B[m, :m] = B[:m, m] = -1.0
        rhs = torch.zeros(m + 1, dtype=torch.float64)
        rhs[m] = -1.0
        c = torch.linalg.solve(B, rhs)[:m].to(T.device, T.dtype)
        T = (c @ torch.stack(amps)).reshape(T.shape)
        if float(dT.abs().max()) <= tol * float(T.abs().max()):
            break
    return float(energy(p, T)), T, it
