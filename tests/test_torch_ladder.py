"""The port's momentum-sector ladder against the JAX package and the dense
contraction, and the kernel's launch plan (K1) checked on the CPU.

K1 itself is CUDA C++ and runs only on the card (``test_torch_cuda.py``);
here its plain twin is held to the JAX ``block_ladder_apply_ij`` and to the
dense einsum, and a numpy walk of the plan exactly as the kernel addresses
it (bins of work units and their stage table of ket rows, the
``bra_of_row`` store, zero rows) is held to the twin.  Tolerance: 1e-12·max|R| (f64 sums of ≤ nv² terms in
another order).
"""

import jax
import numpy as np
import pytest
import torch

from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu_torch import interop, kernels
from pymes_tpu_torch.kernels import block_ladder as k1
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder

NO = 7
REL = 1e-12


def _case(cutoff, bra, seed):
    uj, ut = jueg.UEG(14, 7, 7, 1.0), tueg.UEG(14, 7, 7, 1.0)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    nv = ut.n_spatial - NO
    T = np.random.default_rng(seed).standard_normal((NO, NO, nv, nv))
    V = ut.eval_2b_integrals()
    lo = 0 if bra == "all" else NO
    R_dense = np.einsum("ijcd,pqcd->ijpq", T, V[lo:, lo:, NO:, NO:])
    return uj, ut, T, R_dense


def _close(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 3])
def test_twin_matches_jax_and_dense(cutoff, bra):
    uj, ut, T, R_dense = _case(cutoff, bra, seed=cutoff)
    plan = tladder.build_block_ladder(ut, "cpu", bra=bra)
    R_t = tladder.block_ladder_apply_ij(plan, torch.as_tensor(T)).numpy()
    _close(R_t, R_dense)
    for preslice in (None, 9):   # XLA f64 and the Ozaki form
        pj = jladder.build_block_ladder(uj, bra=bra, preslice=preslice)
        # jitted: the eager Ozaki form dispatches hundreds of small ops
        _close(R_t, np.asarray(jax.jit(jladder.block_ladder_apply_ij)(pj, T)))
    # occupied-leading dispatch gives the same
    assert torch.equal(tladder.ladder_apply_ij(plan, torch.as_tensor(T)),
                       torch.as_tensor(R_t))


@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_interop_plan_matches_port_plan(bra):
    uj, ut, T, R_dense = _case(2, bra, seed=11)
    pj = jladder.build_block_ladder(uj, bra=bra)   # with Ozaki slices
    p_int = interop.block_ladder_from_numpy(pj, "cpu")
    p_own = tladder.build_block_ladder(ut, "cpu", bra=bra)
    for a, b in zip(p_int.groups, p_own.groups):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for x, y in zip(p_int.packed, p_own.packed):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    R = tladder.block_ladder_apply_ij(p_int, torch.as_tensor(T))
    _close(R.numpy(), R_dense)


def test_blocks_from_numpy():
    d = {"ijab": np.arange(6.0).reshape(1, 1, 2, 3),
         "klij": np.ones((1, 1, 1, 1), np.float32)}
    out = interop.blocks_from_numpy(d, "cpu")
    assert all(t.dtype == torch.float64 for t in out.values())
    assert np.array_equal(out["ijab"].numpy(), d["ijab"])


@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_bra_of_row_inverts_inv_bra(bra):
    _, ut, _, _ = _case(3, bra, seed=0)
    plan = tladder.build_block_ladder(ut, "cpu", bra=bra)
    rows = torch.cat([g.bra_of_row.reshape(-1) for g in plan.groups])
    n_cols = rows.numel()
    live = plan.inv_bra < n_cols
    # every bra pair with a sector is the row inv_bra names, and the rest
    # (pairs whose total momentum has no ket pair) are in no row
    assert torch.equal(rows[plan.inv_bra[live]].long(),
                       torch.nonzero(live).reshape(-1))
    assert (rows >= 0).sum() == live.sum()
    assert bool((plan.inv_bra[~live] == n_cols).all())


def _k1_walk(pack, T2, n_bra):
    """numpy model of csrc/block_ladder.cu: each bin's work units in order,
    each busy slot an m16 row tile read from its first A element, its
    k-th B row the ket row that the stage table gives stage k // kd, row
    (panel row) + k % kd, stored through bra_of_row, and the listed zero
    rows."""
    Tt = T2.T.copy()                                  # (nv², no²)
    blocks, bra = pack.blocks.numpy(), pack.bra_of_row.numpy()
    stages = pack.stages.numpy()
    outT = np.full((n_bra * n_bra, T2.shape[0]), np.nan)
    written = np.zeros(n_bra * n_bra, int)
    work, bins = pack.work.numpy(), pack.bins.numpy()
    for b in range(len(bins) - 1):
        st = bins[b, 1]
        for u in work[bins[b, 0]:bins[b + 1, 0]]:
            mK, kd, n_st = u[:3]
            for w in range(k1.CW):
                if u[8 + w] == 0:
                    continue
                kets = [stages[st + k // kd, u[16 + w] + k % kd]
                        for k in range(mK)]
                assert min(kets) >= 0
                for m in range(u[8 + w]):
                    a0 = u[4 + w] + m * mK
                    r = bra[u[12 + w] + m]
                    if r >= 0:
                        outT[r] = blocks[a0:a0 + mK] @ Tt[kets]
                        written[r] += 1
            st += n_st
        assert st == bins[b + 1, 1]
    zero = pack.zero_rows.numpy()
    outT[zero] = 0.0
    written[zero] += 1
    return outT.T, written


@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_k1_launch_plan_covers_each_row_once(bra):
    _, ut, T, R_dense = _case(3, bra, seed=5)
    plan = tladder.build_block_ladder(ut, "cpu", bra=bra)
    pack = plan.packed
    assert pack.work.dtype == pack.stages.dtype == torch.int32
    assert pack.work.shape[1] == k1.UNIT
    assert tuple(pack.bins.shape) == (k1.DEFAULT_SMS + 1, 2)
    assert pack.stages.shape[1] == k1.TK
    assert pack.n_rows == plan.n_bra ** 2
    T2 = T.reshape(NO * NO, -1)
    R, written = _k1_walk(pack, T2, plan.n_bra)
    assert (written == 1).all()           # every output row exactly once
    _close(R.reshape(R_dense.shape), R_dense)
    _close(R, tladder.block_ladder_apply_ij(
        plan, torch.as_tensor(T)).reshape(NO * NO, -1).numpy())


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a card gets no kernel and no twin."""
    with pytest.raises(RuntimeError):
        kernels.check_device(torch.empty(1, device="meta"))
    assert kernels.check_device(torch.empty(1)) is False


def test_twin_does_not_count_launches():
    _, ut, T, _ = _case(2, "virtual", seed=1)
    plan = tladder.build_block_ladder(ut, "cpu")
    before = kernels.LAUNCHES["block_ladder"]
    tladder.block_ladder_apply_ij(plan, torch.as_tensor(T))
    assert kernels.LAUNCHES["block_ladder"] == before
