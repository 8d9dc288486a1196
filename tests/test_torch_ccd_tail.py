"""The per-iteration tail of the CCD fixed point (K2/K3 twins and the DIIS
mixer) against the JAX package, over a recorded sequence of 8 steps so that
the 6-slot ring wraps twice.

K2 (Jacobi step + ring insertion + Gram row) and K3 (mix + energy) are
CUDA C++ kernels that run only on the card (``test_torch_cuda.py``); their
plain twins, which the CPU path runs, are held here to JAX's Jacobi step,
``diis.mix`` and ``ccd_energy_ij``.  Tolerance 1e-12 relative: f64 on both
sides, only the summation order and the small solve (LU here, Gaussian
elimination there) differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.mixer import diis as jdiis
from pymes_tpu.solver import ccd as jccd
from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import ccd_tail
from pymes_tpu_torch.mixer import diis as tdiis

NO, NV, M, STEPS = 3, 5, 6, 8
REL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def record():
    """Seeded residuals/amplitudes of 8 steps, orbital energies, V."""
    rng = np.random.default_rng(2024)
    shape = (NO, NO, NV, NV)
    return {
        "R": [rng.standard_normal(shape) * 0.1 ** (k / 2)
              for k in range(STEPS)],
        "T": [rng.standard_normal(shape) for _ in range(STEPS)],
        "eps_i": -1.0 - rng.random(NO),
        "eps_a": 1.0 + rng.random(NV),
        "V": rng.standard_normal(shape),
    }


def test_diis_mix_matches_jax(record):
    n = NO * NO * NV * NV
    sj = jdiis.init_state(M, n, jnp.float64)
    st = tdiis.init_state(M, n, torch.float64, device="cpu")
    for R, T in zip(record["R"], record["T"]):
        err, amp = R.reshape(-1), T.reshape(-1)
        sj, mj = jdiis.mix(sj, jnp.asarray(err), jnp.asarray(amp))
        st, mt = tdiis.mix(st, torch.as_tensor(err), torch.as_tensor(amp))
        _close(mt.numpy(), mj)
        _close(st.B.numpy(), sj.B)
        assert st.count == int(sj.count)
    assert st.count % M == STEPS % M    # the ring wrapped


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gram_from_errs_matches_jax(dtype):
    """The Gram matrix rebuilt from a ring of errors (the restore path),
    real and complex, against the JAX package's; also the carried ``B``
    of the port's ring after 8 insertions."""
    rng = np.random.default_rng(7)
    errs = rng.standard_normal((M, 40))
    if dtype is np.complex128:
        errs = errs + 1j * rng.standard_normal((M, 40))
    got = tdiis.gram_from_errs(torch.as_tensor(errs))
    assert got.dtype == torch.float64
    _close(got.numpy(), jdiis.gram_from_errs(jnp.asarray(errs)))
    st = tdiis.init_state(M, 40, torch.float64, device="cpu")
    for k in range(STEPS):
        st, _ = tdiis.mix(st, torch.as_tensor(errs.real[k % M] + k),
                          torch.as_tensor(errs.real[k % M]))
    _close(tdiis.gram_from_errs(st.errs).numpy(), st.B.numpy())


def test_diis_class_list_api_matches_jax(record):
    dj, dt = jdiis.DIIS(), tdiis.DIIS()          # default dim_space 5
    for R, T in zip(record["R"], record["T"]):
        errs = [R[0], R[1:]]
        amps = [T[0], T[1:]]
        outj = dj.mix([jnp.asarray(e) for e in errs],
                      [jnp.asarray(a) for a in amps])
        outt = dt.mix([torch.as_tensor(e) for e in errs],
                      [torch.as_tensor(a) for a in amps])
        for a, b in zip(outt, outj):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a.numpy(), b)


@pytest.mark.parametrize("shift", [0.0, -1.0])
def test_tail_twins_match_jax_step(record, shift):
    """Jacobi step + DIIS + energy, step by step, through the K2/K3 twins
    and ``diis.coefficients`` (port) and through the ``ccd_solve_jit``
    body's formulas, ``diis.mix`` and ``ccd_energy_ij`` (JAX)."""
    eps_i, eps_a, V = record["eps_i"], record["eps_a"], record["V"]
    Vx = V.transpose(0, 1, 3, 2)
    n = V.size
    sj = jdiis.init_state(M, n, jnp.float64)
    st = tdiis.init_state(M, n, torch.float64, device="cpu")
    D = (eps_i[:, None, None, None] + eps_i[None, :, None, None]
         - eps_a[None, None, :, None] - eps_a[None, None, None, :])
    tt = {k: torch.as_tensor(record[k]) for k in ("eps_i", "eps_a", "V")}
    Vx_t = torch.as_tensor(np.ascontiguousarray(Vx))
    launches = dict(kernels.LAUNCHES)
    for R, T in zip(record["R"], record["T"]):
        dT = R / (D + shift)
        sj, mixed_j = jdiis.mix(sj, jnp.asarray(dT.ravel()),
                                jnp.asarray((T + dT).ravel()))
        ej = jccd.ccd_energy_ij(mixed_j.reshape(T.shape), V, Vx)

        T_t = torch.as_tensor(T.copy())
        slot, n_valid = st.count % M, min(st.count + 1, M)
        row = ccd_tail.jacobi_diis_insert(
            torch.as_tensor(R), T_t, tt["eps_i"], tt["eps_a"], shift,
            st.errs, st.amps, slot, n_valid)
        assert bool((row[n_valid:] == 0).all())
        B, coeff, info = tdiis.coefficients(st.B, row, slot, n_valid)
        assert int(info) == 0
        st = st._replace(count=st.count + 1, B=B)
        et = ccd_tail.diis_mix_energy(st.amps, coeff, n_valid, T_t,
                                      tt["V"], Vx_t)
        _close(T_t.reshape(-1).numpy(), mixed_j)
        _close(st.errs.numpy(), sj.errs)
        _close(st.amps.numpy(), sj.amps)
        _close(B.numpy(), sj.B)
        for a, b in zip(et, ej):
            _close(float(a), float(b))
    assert kernels.LAUNCHES == launches      # twins count no launches


def test_tail_without_diis_is_the_plain_jacobi_step(record):
    """With one ring slot and coefficient 1 the two passes write T + dT
    exactly (the solver's ``is_diis=False`` route)."""
    R, T = record["R"][0], record["T"][0]
    eps_i, eps_a = (torch.as_tensor(record[k]) for k in ("eps_i", "eps_a"))
    D = (record["eps_i"][:, None, None, None]
         + record["eps_i"][None, :, None, None]
         - record["eps_a"][None, None, :, None]
         - record["eps_a"][None, None, None, :])
    state = tdiis.init_state(1, T.size, torch.float64, device="cpu")
    T_t = torch.as_tensor(T.copy())
    ccd_tail.jacobi_diis_insert(torch.as_tensor(R), T_t, eps_i, eps_a, 0.0,
                                state.errs, state.amps, 0, 1)
    V = torch.as_tensor(record["V"])
    ccd_tail.diis_mix_energy(state.amps, torch.ones(1, dtype=torch.float64),
                             1, T_t, V, V)
    assert np.array_equal(T_t.numpy(), T + R / D)
