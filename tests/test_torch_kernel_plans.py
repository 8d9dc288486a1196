"""The Python planners of K7 (``kernels/arnoldi.py``) and K9
(``kernels/ring_step.py``), and the CPU side of the fused Krylov combine.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what they are handed — K9's tile width and contraction splits, K7's column
ranges and tile widths — is decided here in plain Python, so these tests
hold the plans to covering the work exactly once and to fitting the
kernels' shared memory.  The lane-batched GMRES through the fused combine's
twin is held to the JAX package's ``gmres`` (x within 1e-10, ``rel_res``
within 1e-12: the same algorithm, only the reductions' order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymes_tpu.ops import gmres as jgmres
from pymes_tpu_torch.kernels import arnoldi, ring_step
from pymes_tpu_torch.ops import gmres as tgmres

RING_SHAPES = [(49, 11236, 11236), (49, 500, 500), (9, 100, 37),
               (113, 1000, 999), (49, 2000, 3001), (1, 1, 1)]


@pytest.mark.parametrize("K", [1, 31, 32, 33, 500, 3001, 11236])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_ring_split_ranges_cover_k_once_in_order(K, splits):
    ranges = ring_step.split_ranges(K, splits)
    assert 1 <= len(ranges) <= splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1                      # contiguous, in order
    for b, e in ranges:
        assert b < e and b % ring_step.TK == 0   # whole 32-deep stages


@pytest.mark.parametrize("M,N,K", RING_SHAPES)
@pytest.mark.parametrize("sms", [132, 8])
def test_ring_plan_is_a_launchable_split(M, N, K, sms):
    tile_n, splits = ring_step.plan(M, N, K, sms)
    assert tile_n in ring_step.TILES_N
    assert 1 <= splits <= ring_step.MAX_SPLITS
    # the planned split count is the kernel's: no empty split
    assert len(ring_step.split_ranges(K, splits)) == splits


def test_ring_plan_at_the_ring_shapes():
    """nP=219 (4 shards) fills 132 SMs with 128-wide tiles in 3 splits;
    nP=57 (5 shards) takes one split, so no second launch."""
    assert ring_step.plan(49, 11236, 11236, 132) == (128, 3)
    assert ring_step.plan(49, 500, 500, 132)[1] == 1


@pytest.mark.parametrize("n,La", [(245700, 64), (1320312, 32), (9000, 4),
                                  (70001, 4), (30002, 3), (7, 1),
                                  (2048, 200)])
@pytest.mark.parametrize("rows", [1, 11, 61, 121, 128])
def test_k7_blocks_cover_every_lane_column_once(n, La, rows):
    G, span = arnoldi.plan(n, La, 132)
    assert span % 2 == 0 and G * span >= n > (G - 1) * span
    for tile in (arnoldi.PROJ_TILE, arnoldi.COMB_TILE):
        tiles = [t for blk in arnoldi.block_tiles(n, G, span, rows, tile)
                 for t in blk]
        cover = np.zeros(n, dtype=np.int64)
        for c0, c1 in tiles:
            assert c0 < c1
            cover[c0:c1] += 1
        # every lane walks the same ranges, so each (lane, column) once
        assert (cover == 1).all()


@pytest.mark.parametrize("m", [0, 1, 10, 59, 60, 95, 120, 121])
def test_k7_tile_fits_shared_memory(m):
    """The projection's tile (m rows and w) and the combine's (m + 1
    rows) fit their buffers for m up to 121, at least 16 columns wide, a
    multiple of 16 so every row segment stays 16-byte aligned."""
    for rows, tile in ((m + 1, arnoldi.PROJ_TILE),
                       (m + 1, arnoldi.COMB_TILE)):
        C = arnoldi.tile_cols(rows, tile)
        assert C >= 16 and C % 16 == 0
        assert rows * C <= tile
    assert m + 1 <= arnoldi.MAX_ROWS


@pytest.mark.parametrize("with_x0", [False, True])
def test_fused_combine_twin_equals_two_single_combines(with_x0):
    rng = np.random.default_rng(7 + with_x0)
    L, R1, n = 4, 9, 50
    V = torch.as_tensor(rng.standard_normal((L, R1, n)))
    C = torch.as_tensor(rng.standard_normal((3, 2, R1)))
    lanes = torch.as_tensor([3, 0, 2])
    m = torch.as_tensor([1, R1, 5])
    x0 = torch.as_tensor(rng.standard_normal((3, n))) if with_x0 else None
    x, r = arnoldi.krylov_combine_xr(V, C, m, lanes, x0=x0)
    assert torch.equal(x, arnoldi.krylov_combine(V, C[:, 0], m, lanes,
                                                 x0=x0))
    assert torch.equal(r, arnoldi.krylov_combine(V, C[:, 1], m, lanes))


@pytest.mark.parametrize("precond", [False, True])
def test_gmres_lanes_match_jax_gmres(precond):
    """Four systems in lock step through the lane-batched GMRES (the K7
    twins, the fused combine at every cycle end): each lane's x and
    residual equal the JAX package's one-system ``gmres``."""
    rng = np.random.default_rng(11 + precond)
    L, n = 4, 36
    A = np.eye(n)[None] * 4.0 + rng.standard_normal((L, n, n)) * 0.3
    A[1] += 2.0 * np.eye(n)                      # converges sooner
    b = rng.standard_normal((L, n))
    d = 1.0 / np.diagonal(A, axis1=1, axis2=2)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)

    def apply(X, lanes):
        Y = torch.stack([torch.mv(At[l], x)
                         for l, x in zip(lanes.tolist(), X)])
        return Y * dt[lanes] if precond else Y

    pre = (lambda B, lanes: B * dt[lanes]) if precond else None
    kw = dict(tol=1e-12, restart=7, max_outer=40)
    x, rel, info = tgmres.gmres_lanes(apply, torch.as_tensor(b), pre, **kw)
    assert info["cycle_ends"] > 1
    for l in range(L):
        Aj, dj = jnp.asarray(A[l]), jnp.asarray(d[l])
        xj, rj = jgmres.gmres(lambda v: Aj @ v, jnp.asarray(b[l]),
                              precond=(lambda v: dj * v) if precond
                              else None, **kw)
        np.testing.assert_allclose(x[l].numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-10)
        assert abs(rel[l] - float(rj)) <= 1e-12
