"""The port's GMRES and Richardson (``pymes_tpu_torch/ops/gmres.py``)
against the JAX package's (``pymes_tpu/ops/gmres.py``) on the systems of
``tests/test_gmres.py``: seeded numpy A, b through both, f64 on the CPU.

Tolerances: x within 1e-10 and ``rel_res`` within 1e-12 of the JAX
values (the same algorithm; only the summation order of the reductions
differs).  The lane-batched solver on the CPU (the K7 twins) equals
one-lane solves bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymes_tpu.ops import gmres as jgmres
from pymes_tpu_torch.ops import gmres as tgmres


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.3
    b = rng.standard_normal(n)
    return A, b


def _both_gmres(A, b, precond, **kw):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    d = 1.0 / np.diag(A)
    dj, dt = jnp.asarray(d), torch.as_tensor(d)
    xj, rj = jgmres.gmres(lambda v: Aj @ v, jnp.asarray(b),
                          precond=(lambda v: dj * v) if precond else None,
                          **kw)
    xt, rt = tgmres.gmres(lambda v: At @ v, torch.as_tensor(b),
                          precond=(lambda v: dt * v) if precond else None,
                          **kw)
    return np.asarray(xj), float(rj), xt.numpy(), rt


@pytest.mark.parametrize("n,seed,precond,restart,max_outer,tol", [
    (60, 0, False, 20, 50, 1e-12),     # plain
    (80, 1, True, 15, 60, 1e-12),      # diagonal preconditioner
    (120, 7, False, 8, 60, 1e-12),     # many restart cycles
    (50, 5, True, 20, 1, 1e-3),        # early exit inside one cycle
])
def test_gmres_matches_jax(n, seed, precond, restart, max_outer, tol):
    A, b = _system(n, seed)
    xj, rj, xt, rt = _both_gmres(A, b, precond, tol=tol, restart=restart,
                                 max_outer=max_outer)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)
    assert abs(rt - rj) <= 1e-12
    if tol == 1e-12:
        np.testing.assert_allclose(xt, np.linalg.solve(A, b), atol=1e-8)


def test_gmres_breakdown_matches_jax():
    """n = 4 with restart 20: the Krylov space is exhausted after 4 steps
    (happy breakdown, a zero row past it, dead columns in the
    back-substitution); the port returns the JAX x."""
    A, b = _system(4, seed=2)
    xj, rj, xt, rt = _both_gmres(A, b, False, tol=1e-14, restart=20,
                                 max_outer=3)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(xt, np.linalg.solve(A, b), atol=1e-12)
    assert abs(rt - rj) <= 1e-12


def _lane_problem(L=5, n=40, seed=3):
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] * 4.0 + rng.standard_normal((L, n, n)) * 0.3
    b = rng.standard_normal((L, n))
    return torch.as_tensor(A), torch.as_tensor(b)


def test_gmres_lanes_equal_single_solves_bit_for_bit():
    """Five systems of different difficulty in lock step (each keeps its
    own j, cycles and convergence) give exactly the one-lane results."""
    A, b = _lane_problem()
    A[3] = A[3] + 3.0 * torch.eye(A.shape[1], dtype=A.dtype)  # converges early
    d = 1.0 / torch.diagonal(A, dim1=1, dim2=2)

    def apply(X, lanes):
        return torch.stack([d[l] * torch.mv(A[l], x)
                            for l, x in zip(lanes.tolist(), X)])

    def precond(X, lanes):
        return torch.stack([d[l] * x for l, x in zip(lanes.tolist(), X)])

    x, rel, info = tgmres.gmres_lanes(apply, b, precond, tol=1e-11,
                                      restart=6, max_outer=40)
    assert len(set(info["steps"].tolist())) > 1   # lanes diverged in j
    for l in range(A.shape[0]):
        x1, r1 = tgmres.gmres(lambda v: torch.mv(A[l], v), b[l],
                              precond=lambda v: d[l] * v, tol=1e-11,
                              restart=6, max_outer=40)
        assert torch.equal(x[l], x1)
        assert rel[l] == r1
        np.testing.assert_allclose(
            x1.numpy(), np.linalg.solve(A[l].numpy(), b[l].numpy()),
            atol=1e-9)


@pytest.mark.parametrize("seed,max_iter,tol", [(3, 500, 1e-12),
                                               (4, 80, 1e-10)])
def test_richardson_matches_jax(seed, max_iter, tol):
    A, b = _system(70 if seed == 3 else 40, seed)
    d = 1.0 / np.diag(A)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    xj, rj = jgmres.richardson(lambda v: Aj @ v, jnp.asarray(b),
                               precond=lambda v: dj * v, tol=tol,
                               max_iter=max_iter)
    xt, rt = tgmres.richardson(lambda v: At @ v, torch.as_tensor(b),
                               precond=lambda v: dt * v, tol=tol,
                               max_iter=max_iter)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    assert abs(rt - float(rj)) <= 1e-12
    assert rt < tol


def test_richardson_divergence_keeps_best_iterate():
    """ω = 1 on a system that is not diagonally dominant diverges: the
    loop bails past 1e3·‖b‖ and returns its best iterate, as JAX's."""
    rng = np.random.default_rng(9)
    n = 30
    A = np.eye(n) + rng.standard_normal((n, n)) * 0.8
    b = rng.standard_normal(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    xj, rj = jgmres.richardson(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                               max_iter=400)
    xt, rt = tgmres.richardson(lambda v: At @ v, torch.as_tensor(b),
                               tol=1e-12, max_iter=400)
    assert rt == pytest.approx(float(rj), rel=1e-12, abs=1e-14)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    assert rt <= 1.0
