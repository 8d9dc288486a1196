"""Restarted GMRES and damped Richardson on the device, for one system or
for L independent systems ("lanes") in lock step.

Counterpart of ``pymes_tpu/ops/gmres.py``: left-preconditioned GMRES(m)
with CGS2 Arnoldi, Givens rotations, an early exit on the least-squares
residual and the restart residual reconstructed from the Arnoldi relation
(no extra matvec), and the best-iterate Richardson iteration.  The
systems are float64, or float32 for the inner solves of the FEAST/RT
mixed-precision engine; the breakdown and underflow guards follow the type
as the JAX package's do (``ops/gmres.py:58-69``: ``_BREAK`` 1e-140 and
``tiny`` 1e-300 in f64, 1e-18 and 1e-30 in f32).

:func:`gmres_lanes` is the device form of the JAX f64 FEAST path's
``vmap`` of that solver over contour nodes
(``pymes_tpu/solver/feast_eom_ccsd.py:321-347``): each lane keeps its own
Arnoldi step j, its own restart count and its own convergence, as a
vmapped ``while_loop`` does.  A lane whose cycle has ended waits, and
takes no part in the next operator application; the operator runs on the
rows of the active lanes only, so a lane's result is that of the one-lane
solver.  The split between host and card follows the EOM Davidson's:

* the Krylov bases V (L, restart+1, n) and every vector stay on the card;
  the CGS2 projection and the two cycle-end Krylov combines (one pass
  over V) are kernel K7 (:mod:`pymes_tpu_torch.kernels.arnoldi`);
* the new Hessenberg column (La, restart+1) comes down once per Arnoldi
  step — it is also the convergence read;
* the Givens rotations, ``g``, the back-substitution and the reverse
  rotation run on the host in numpy float64 (for f32 systems too, where
  the JAX package rotates in f32), with the JAX formulas in the JAX order,
  vectorised over the lanes;
* the solution and residual coefficients go up once per cycle end, in
  float64 (K7 sums in float64 for either basis type).
"""

import numpy as np
import torch

from pymes_tpu_torch.kernels import arnoldi

BREAK = arnoldi.BREAK   # ops/gmres.py:69
TINY = 1e-300           # ops/gmres.py:59
TINY_F32 = 1e-30        # ops/gmres.py:59, f32


def guards(dtype):
    """(breakdown, underflow) guards of a system of ``dtype``."""
    f32 = dtype == torch.float32
    return arnoldi.breakdown(dtype), TINY_F32 if f32 else TINY


def _norms(X):
    return torch.sqrt((X * X).sum(dim=1))


def _safe_unit(v, norm, brk=BREAK):
    """Rows of v scaled to unit length; a row of norm ≤ brk becomes 0."""
    scale = torch.where(norm > brk, 1.0 / torch.clamp(norm, min=brk),
                        torch.zeros_like(norm))
    return scale[:, None] * v


def _givens(h, j, cs, sn, g, brk=BREAK):
    """One Arnoldi step's Givens update (``ops/gmres.py:110-130``) for the
    active lanes of a cycle, in place: ``h`` (La, R+1) the new columns,
    ``j`` (La,) their step, ``cs``/``sn`` (La, R), ``g`` (La, R+1); ``brk``
    the breakdown guard.  Returns the rotated columns."""
    rows = np.arange(h.shape[0])
    for i in range(cs.shape[1]):
        use = i < j
        if not use.any():
            break
        hi, hi1 = h[:, i].copy(), h[:, i + 1].copy()
        h[:, i] = np.where(use, cs[:, i] * hi + sn[:, i] * hi1, hi)
        h[:, i + 1] = np.where(use, -sn[:, i] * hi + cs[:, i] * hi1, hi1)
    hj, hj1 = h[rows, j], h[rows, j + 1]
    denom = np.sqrt(hj ** 2 + hj1 ** 2)
    safe_d = np.maximum(denom, brk)
    alive = denom > brk
    c = np.where(alive, hj / safe_d, 1.0)
    s = np.where(alive, hj1 / safe_d, 0.0)
    h[rows, j] = denom
    h[rows, j + 1] = 0.0
    cs[rows, j] = c
    sn[rows, j] = s
    gj = g[rows, j]
    g[rows, j + 1] = -s * gj
    g[rows, j] = c * gj
    return h


def _back_substitute(H, g):
    """R y = g per lane (``ops/gmres.py:145-160``): ``H`` (Lc, R+1, R),
    sums in the JAX order (ascending l); a dead column (|H_ii| ≤ 1e-300:
    early exit or happy breakdown) gets y_i = 0."""
    Lc, _, R = H.shape
    y = np.zeros((Lc, R))
    for i in range(R - 1, -1, -1):
        prods = H[:, i, i + 1:] * y[:, i + 1:]
        acc = np.cumsum(prods, axis=1)[:, -1] if R - 1 > i else 0.0
        d = H[:, i, i]
        ok = np.abs(d) > 1e-300
        y[:, i] = np.where(ok, (g[:, i] - acc) / np.where(ok, d, 1.0), 0.0)
    return y


def _unrotate(g, cs, sn, j):
    """ζ = Qᵀ e_j·g_j per lane (``ops/gmres.py:168-178``): the Krylov
    coordinates of the least-squares residual."""
    Lc, R = cs.shape
    rows = np.arange(Lc)
    u = np.zeros((Lc, R + 1))
    u[rows, j] = g[rows, j]
    for i in range(R - 1, -1, -1):
        use = i < j
        ui, ui1 = u[:, i].copy(), u[:, i + 1].copy()
        u[:, i] = np.where(use, cs[:, i] * ui - sn[:, i] * ui1, ui)
        u[:, i + 1] = np.where(use, sn[:, i] * ui + cs[:, i] * ui1, ui1)
    return u


def gmres_lanes(apply, b, precond=None, tol=1e-5, restart=20, max_outer=20,
                twin=False):
    """Solve the L systems A_ℓ x_ℓ = b_ℓ of ``b`` (L, n) in lock step.

    ``apply(X, lanes)`` returns M·A on the rows ``X`` (La, n) of the
    active lanes ``lanes`` (int64 tensor on b's device) — the
    preconditioned operator, so that an operator can fuse the two;
    ``precond(B, lanes)`` applies M alone (None: M = 1).  ``b`` is float64
    or float32 (the basis and x take its type, the guards follow it).
    ``twin`` runs K7 through its twin.

    Returns ``(x, rel_res, info)``: x (L, n), the preconditioned relative
    residual of each lane (numpy, from the Arnoldi relation, as the JAX
    ``gmres`` reports it) and ``info`` with the Arnoldi steps and restart
    cycles of each lane (numpy), and the counts of operator applications
    (``calls``) and of batched cycle ends (``cycle_ends``)."""
    L, n = b.shape
    dev = b.device
    R = int(restart)
    brk, tiny = guards(b.dtype)
    all_lanes = torch.arange(L, device=dev)
    # x0 = 0 ⇒ the preconditioned residual is exactly Mb — no matvec
    r = b.clone() if precond is None else precond(b, all_lanes)
    bnorm = _norms(r).double().cpu().numpy()
    safe_b = np.maximum(bnorm, tiny)
    x = torch.zeros_like(b)
    res = bnorm.copy()
    cycles = np.zeros(L, dtype=np.int64)
    steps = np.zeros(L, dtype=np.int64)
    calls = cycle_ends = 0
    V = torch.empty((L, R + 1, n), dtype=b.dtype, device=dev)
    while True:
        cyc = np.nonzero((res / safe_b > tol) & (cycles < max_outer))[0]
        if len(cyc) == 0:
            break
        Lc = len(cyc)
        cyc_t = torch.as_tensor(cyc, device=dev)
        rc = r[cyc_t]
        beta_t = _norms(rc)
        V[cyc_t, 0] = _safe_unit(rc, beta_t, brk)
        H = np.zeros((Lc, R + 1, R))
        cs, sn = np.zeros((Lc, R)), np.zeros((Lc, R))
        g = np.zeros((Lc, R + 1))
        g[:, 0] = beta_t.double().cpu().numpy()
        j = np.zeros(Lc, dtype=np.int64)
        thresh = tol * safe_b[cyc]
        rows = np.arange(Lc)
        while True:
            # |g[j]| is the preconditioned residual of the current
            # least-squares iterate: the free early exit of :133-139
            ia = np.nonzero((j < R) & (np.abs(g[rows, np.minimum(j, R)])
                                       > thresh))[0]
            if len(ia) == 0:
                break
            lanes_t = torch.as_tensor(cyc[ia], device=dev)
            ja = j[ia]
            ja_t = torch.as_tensor(ja, device=dev)
            w = apply(V[lanes_t, ja_t], lanes_t)
            h = arnoldi.arnoldi_cgs2(V, w.contiguous(), lanes_t, ja_t + 1,
                                     twin=twin).cpu().numpy()
            calls += 1
            cs_a, sn_a, g_a = cs[ia], sn[ia], g[ia]
            h = _givens(h, ja, cs_a, sn_a, g_a, brk)
            cs[ia], sn[ia], g[ia] = cs_a, sn_a, g_a
            H[ia, :, ja] = h
            j[ia] += 1
            steps[cyc[ia]] += 1
        # cycle end: x ← x0 + Σ y_i V_i, r ← Σ u_i V_i (:162, :179)
        y = np.concatenate([_back_substitute(H, g), np.zeros((Lc, 1))], 1)
        u = _unrotate(g, cs, sn, j)
        m_t = torch.as_tensor(j + 1, device=dev)
        coef = torch.as_tensor(np.stack([y, u], axis=1),
                               dtype=torch.float64, device=dev)
        x[cyc_t], r[cyc_t] = arnoldi.krylov_combine_xr(
            V, coef, m_t, cyc_t, x0=x[cyc_t], twin=twin)
        cycle_ends += 1
        # on early exit the residual sits at g[j_fin], not g[restart]
        res[cyc] = np.abs(g[rows, j])
        cycles[cyc] += 1
    return x, res / safe_b, {"steps": steps, "cycles": cycles,
                             "calls": calls, "cycle_ends": cycle_ends}


def gmres(matvec, b, precond=None, tol=1e-5, restart=20, max_outer=20, *,
          twin=False):
    """Solve A x = b (``pymes_tpu/ops/gmres.py:40``); returns ``(x,
    rel_res)`` with rel_res the preconditioned residual norm from the
    Arnoldi relation over ‖Mb‖.  ``matvec``/``precond``: vector → vector
    callables (``precond`` None: the identity)."""
    def apply(X, lanes):
        y = matvec(X[0])
        return (y if precond is None else precond(y))[None]

    pre = None if precond is None else (lambda B, lanes: precond(B[0])[None])
    x, rel, _ = gmres_lanes(apply, b[None], pre, tol=tol, restart=restart,
                            max_outer=max_outer, twin=twin)
    return x[0], float(rel[0])


def richardson_lanes(residual, b, precond=None, tol=1e-5, damping=1.0,
                     max_iter=400):
    """Damped preconditioned Richardson x ← x + ω·M(b − A x) on the L
    systems of ``b`` (L, n) in lock step (``pymes_tpu/ops/gmres.py:199``):
    each lane keeps the best iterate it has seen (least true residual) and
    stops on ``tol``, on ``max_iter`` or once its residual is 1e3× past
    ‖b‖.  ``residual(X, lanes)`` returns (b − A x rows, their norms);
    ``precond(R, lanes)`` applies M.  Returns ``(best_x, rel_res,
    iterations)``."""
    L = b.shape[0]
    dev = b.device
    bnorm = _norms(b).double().cpu().numpy()
    safe_b = np.maximum(bnorm, guards(b.dtype)[1])
    x = torch.zeros_like(b)
    best_x = torch.zeros_like(b)
    # the entry residual at x0 = 0 is exactly ‖b‖ (no matvec)
    res, best = bnorm.copy(), bnorm.copy()
    it = np.zeros(L, dtype=np.int64)
    while True:
        ia = np.nonzero((res / safe_b > tol) & (it < max_iter)
                        & (res < 1e3 * safe_b))[0]
        if len(ia) == 0:
            break
        lanes_t = torch.as_tensor(ia, device=dev)
        xa = x[lanes_t]
        r, rn = residual(xa, lanes_t)
        rn = rn.double().cpu().numpy()
        better = rn < best[ia]
        if better.any():
            best_x[lanes_t[torch.as_tensor(better, device=dev)]] = \
                xa[torch.as_tensor(better, device=dev)]
            best[ia[better]] = rn[better]
        step = r if precond is None else precond(r, lanes_t)
        x[lanes_t] = xa + damping * step
        res[ia] = rn
        it[ia] += 1
    return best_x, best / safe_b, it


def richardson(matvec, b, precond=None, tol=1e-5, damping=1.0,
               max_iter=400):
    """Damped preconditioned Richardson on one system
    (``pymes_tpu/ops/gmres.py:199``); returns ``(best_x, rel_res)``."""
    def residual(X, lanes):
        r = b[None] - matvec(X[0])[None]
        return r, _norms(r)

    pre = None if precond is None else (lambda R, lanes: precond(R[0])[None])
    x, rel, _ = richardson_lanes(residual, b[None], pre, tol=tol,
                                 damping=damping, max_iter=max_iter)
    return x[0], float(rel[0])
