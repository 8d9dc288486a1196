"""K4's plain side on the CPU: the diagonal twin (the fused G_vv trace of
the CCSD dressing) and the strided batch twin against the JAX package, the
launch planner, the wrapper's CPU routing, and the matrix-free CCSD
dressing through the diagonal entry.

The kernel itself (``pymes_tpu_torch/csrc/ovvv_gather.cu``) runs only on a
card: ``tests/test_torch_cuda.py`` holds it to these twins there.

Tolerance: 1e-12 relative to the largest entry (f64; the trace sums j in
another order than the JAX einsum); the gathers themselves are one
multiply an element, so the batch twin equals the JAX gather bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pymes_tpu.integral.partition import part_2_body_int as jpart
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.solver import ccsd as jccsd
from pymes_tpu_torch import interop, kernels
from pymes_tpu_torch.integral.partition import part_2_body_int as tpart
from pymes_tpu_torch.kernels import ovvv_gather as k4
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.ops import ueg_ladder
from pymes_tpu_torch.solver import ccsd

NO = 7
REL = 1e-12
# (n, columns) of the main paths at full width: the CCSD dressing at
# nP=219 (7 columns), the EOM Davidson sigma at nP=219 (2 trials), the
# FEAST nP=57 sigma (2·64 lanes of trials) and the RT nP=123 sigma (2·32)
WIDTHS = [(212 * 212 * 7, 7), (212 * 212 * 7, 14), (50 * 50 * 7, 896),
          (116 * 116 * 7, 448)]
EDGES = [(1, 1), (255, 1), (257, 33), (1025, 31), (3 * 4 * 256 * 132, 32),
         (1000, 3), (77, 70_000), (256, 9), (1, 896)]


def _plans(cutoff):
    u = jueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    pj = jladder.build_ovvv_plans(u)
    return u, pj, interop.ovvv_plans_from_numpy(pj, "cpu")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("pat,axis,spec", [("vov", 1, "jajb->ab"),
                                           ("ovv", 0, "jjab->ab")])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_diag_twin_matches_jax_trace(cutoff, pat, axis, spec):
    u, pj, pt = _plans(cutoff)
    T1 = np.random.default_rng(cutoff + axis).standard_normal(
        (u.n_spatial - NO, NO))
    want = jnp.einsum(spec, jladder.ovvv_t1_apply_j(pj[pat], T1))
    got = ueg_ladder.ovvv_t1_trace(pt[pat], torch.as_tensor(T1), axis)
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got.numpy(), want)


@pytest.mark.parametrize("pat", ["vvo", "ovv", "vov"])
def test_strided_batch_twin_matches_jax(pat):
    """The sigma's trial batch as the Krylov rows give it: a (k, nv, no)
    view of (k, N) rows (batch stride N), gathered per trial by JAX."""
    u, pj, pt = _plans(2)
    nv = u.n_spatial - NO
    k, N = 3, nv * NO + 11
    rows = np.random.default_rng(17).standard_normal((k, N))
    T = torch.as_tensor(rows)[:, :nv * NO].reshape(k, nv, NO)
    assert not T.is_contiguous() or k == 1
    got = ueg_ladder.ovvv_t1_apply(pt[pat], T)
    assert got.shape == (k,) + tuple(pt[pat].S.shape) + (NO,)
    for b in range(k):
        want = jladder.ovvv_t1_apply(pj[pat], rows[b, :nv * NO].reshape(
            nv, NO))
        assert np.array_equal(got[b].numpy(), np.asarray(want))


def _covered_once(n, ncol, ct):
    """Every (entry, column) in exactly one block: the column ranges
    partition [0, ncol), and under each the entry ranges partition [0, n)."""
    by_cols = {}
    for ents, cols in k4.tiles(n, ncol, ct):
        by_cols.setdefault(cols, []).append(ents)
    starts = sorted(by_cols)
    assert starts[0][0] == 0 and starts[-1][1] == ncol
    assert all(a[1] == b[0] for a, b in zip(starts, starts[1:]))
    assert all(c1 - c0 <= ct and c1 > c0 for c0, c1 in starts)
    for ents in by_cols.values():
        ents = sorted(ents)
        assert ents[0][0] == 0 and ents[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ents, ents[1:]))
        assert all(0 < i1 - i0 <= k4.THREADS * k4.EPT for i0, i1 in ents)
    return sum(len(v) for v in by_cols.values())


@pytest.mark.parametrize("n,ncol", WIDTHS)
def test_plan_fills_the_card_at_the_main_widths(n, ncol):
    ct = k4.plan(n, ncol, 132)
    # the dressing and the EOM batch at nP=219 in one column tile, the
    # FEAST and RT lane batches in tiles of 4
    assert ct == (ncol if ncol <= k4.WIDE_TILE else k4.NARROW_TILE)
    assert _covered_once(n, ncol, ct) >= k4.FILL_BLOCKS_PER_SM * 132


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n,ncol", EDGES)
def test_plan_tiles_cover_each_entry_and_column_once(n, ncol, sms):
    ct = k4.plan(n, ncol, sms)
    assert 1 <= ct <= min(ncol, k4.WIDE_TILE)
    assert -(-ncol // ct) <= k4.MAX_GRID_Y
    _covered_once(n, ncol, ct)
    tiles_n = -(-n // (k4.THREADS * k4.EPT))
    fill = k4.FILL_BLOCKS_PER_SM * sms
    if tiles_n >= fill:               # the entries fill the card
        assert ct == k4._even(ncol, k4.WIDE_TILE)
    else:                             # a narrower tile only to fill it
        assert ct <= k4.NARROW_TILE
        assert ct == k4._even(ncol, min(ncol, k4.NARROW_TILE)) or \
            tiles_n * -(-ncol // k4._even(ncol, ct + 1)) < fill


def test_plan_balances_the_column_tiles():
    n = 212 * 212 * 7
    # 18 columns as two tiles of 9, not 16 and 2; 9 lane columns as 3 x 3,
    # not 4, 4 and 1
    assert k4.plan(n, 18, 132) == 9
    assert k4.plan(50 * 50 * 7, 9 * 64, 132) == 4
    assert k4.plan(200 * k4.THREADS * k4.EPT, 9, 132) == 3
    # a small plan takes narrower tiles to fill the card: the 35 entry
    # tiles of the nP=57 dressing as 245 blocks of one column
    assert k4.plan(50 * 50 * 7, 7, 132) == 1


def test_cpu_tensors_take_the_twins_and_count_nothing():
    u, _, pt = _plans(2)
    T1 = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (u.n_spatial - NO, NO)))
    before = dict(kernels.LAUNCHES)
    p = pt["vov"]
    full = k4.ovvv_gather(p.S, p.W, T1)
    assert torch.equal(full, k4.ovvv_gather_twin(p.S, p.W, T1))
    d = k4.ovvv_gather_diag(p.S, p.W, T1, 1)
    assert torch.equal(d, torch.einsum("jajb->ab", full))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        k4.ovvv_gather_diag(p.S, p.W, T1, 2)


def test_mf_ccsd_dressing_runs_the_diag_entry_and_matches_jax(monkeypatch):
    """Matrix-free CCSD, nP=19 with the seeded non-canonical Fock: each
    iteration makes 4 full gathers and 2 diagonal ones (the G_vv trace),
    and the per-iteration energies stay within 1e-10 of the JAX package."""
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = torch.as_tensor(u.eval_2b_integrals())
    fock = hf.construct_hf_matrix(
        NO, torch.diag(torch.as_tensor(u.kinetic_energies())), V)
    noise = np.random.default_rng(5).standard_normal(tuple(fock.shape))
    fock = fock + torch.as_tensor(0.02 * noise + 0.02 * noise.T)
    drop = ("abcd", "abci", "iabc", "aibc", "abic")
    d = {k: v for k, v in tpart(NO, V).items() if k not in drop}
    d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, "cpu")
    plan = ueg_ladder.build_block_ladder(u, "cpu", bra="all")
    calls = {"full": 0, "diag": 0}
    full, diag = k4.ovvv_gather, k4.ovvv_gather_diag

    def spy(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(k4, "ovvv_gather", spy("full", full))
    monkeypatch.setattr(k4, "ovvv_gather_diag", spy("diag", diag))
    kw = dict(delta_e=1e-10, max_iter=200)
    res = ccsd.CCSD(NO, "cpu").solve(fock, d, ladder=plan, **kw)
    n_it = len(res["e history"])
    assert calls == {"full": 4 * n_it, "diag": 2 * n_it}

    uj = jueg.UEG(14, 7, 7, 1.0)
    uj.init_single_basis(2)
    dj = {k: v for k, v in jpart(NO, jnp.asarray(V.numpy())).items()
          if k not in drop}
    dj["_ovvv_plans"] = jladder.build_ovvv_plans(uj)
    ref = jccsd.CCSD(NO).solve(
        jnp.asarray(fock.numpy()), dj, ladder=jladder.build_block_ladder(
            uj, bra="all", preslice=None), contract_mode="xla", **kw)
    want = np.asarray(ref["e history"])
    assert len(want) == n_it
    assert float(np.abs(np.asarray(res["e history"]) - want).max()) <= 1e-10
