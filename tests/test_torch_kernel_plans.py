"""The Python planners of K1 (``kernels/block_ladder.py``, the f64 kernel's
units and bins and the f32 kernel's items), the f32 K4's column tiles
(``kernels/ovvv_gather.py`` ``plan_f32``), K7
(``kernels/arnoldi.py``), K9 (``kernels/ring_step.py``) and the tail passes
K2/K3, K2′/K3′ (``kernels/ccsd_tail.py``), and the CPU side of the fused
Krylov combine.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
what they are handed — K1's work units, bins and column tile, K9's tile
width and contraction splits, K7's column ranges and tile widths — is
decided here in plain Python, so these tests hold the plans to covering the
work exactly once and to fitting the kernels' shared memory.  The tail
plans are walked here as ``csrc/cc_tail.cu`` walks them (grid-stride loops,
the digits of each T2 position stepped by carries).  The lane-batched GMRES through the fused combine's
twin is held to the JAX package's ``gmres`` (x within 1e-10, ``rel_res``
within 1e-12: the same algorithm, only the reductions' order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymes_tpu.ops import gmres as jgmres
from pymes_tpu_torch.kernels import arnoldi, ccsd_tail, ring_step
from pymes_tpu_torch.kernels import block_ladder as k1
from pymes_tpu_torch.kernels import ovvv_gather as k4
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import gmres as tgmres
from pymes_tpu_torch.ops import ueg_ladder as tladder

K1_WIDTHS = [1, 8, 9, 33, 49, 56, 57, 77, 98, 128, 129, 1000, 6272, 6273]
_K1_PLANS = {}


def _k1_plan(cutoff, bra, pad):
    """A ladder plan of UEG 14 electrons, rs = 0.5 (nP = 19, 57, 219 at
    cutoff 2, 5, 14), built once per case."""
    key = (cutoff, bra, pad)
    if key not in _K1_PLANS:
        u = tueg.UEG(14, 7, 7, 0.5)
        u.init_single_basis(cutoff)
        _K1_PLANS[key] = tladder.build_block_ladder(u, "cpu", bra=bra,
                                                    pad_sectors=pad)
    return _K1_PLANS[key]


def _k1_args(plan):
    shapes = [tuple(g.blocks.shape) for g in plan.groups]
    return shapes, plan.packed.perm.numpy(), plan.packed.bra_of_row.numpy()


def _k1_slots(work, bins):
    """Every busy slot of every unit, bin by bin: (unit, slot)."""
    for b in range(len(bins) - 1):
        for i in range(bins[b, 0], bins[b + 1, 0]):
            for w in range(k1.CW):
                if work[i, 8 + w] > 0:
                    yield i, w


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("pad", [1, 4])
@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5, 14])
def test_k1_units_cover_every_bra_row_once(cutoff, bra, pad, sms):
    """Every bra row of the plan is stored by exactly one slot of one unit
    in one bin, from its own sector's A row and ket panel; the bins cut
    the units and the stages in order."""
    plan = _k1_plan(cutoff, bra, pad)
    shapes, perm, bra_rows = _k1_args(plan)
    work, stages, bins = k1.plan_units(shapes, perm, bra_rows, sms)
    assert work.shape[1] == k1.UNIT and stages.shape[1] == k1.TK
    assert bins.shape == (sms + 1, 2) and (bins[0] == 0).all()
    assert bins[-1, 0] == len(work) and bins[-1, 1] == len(stages)
    assert (np.diff(bins, axis=0) >= 0).all()
    # each group's offsets into the blocks, perm and bra buffers
    gtab, offs = [], np.zeros(3, np.int64)
    for nS, mB, mK in shapes:
        gtab.append((*offs, mB, mK))
        offs += (nS * mB * mK, nS * mK, nS * mB)
    n_st = np.zeros(len(work), int)
    for b in range(sms):
        u = work[bins[b, 0]:bins[b + 1, 0]]
        assert u[:, 2].sum() == bins[b + 1, 1] - bins[b, 1]
        n_st[bins[b, 0]:bins[b + 1, 0]] = np.cumsum(u[:, 2]) - u[:, 2] \
            + bins[b, 1]
    seen = np.zeros(len(bra_rows), int)
    for i, w in _k1_slots(work, bins):
        mK, kd, ns, g = work[i, :4]
        o_b, o_p, o_r, mB, gmK = gtab[g]
        assert mK == gmK and kd in (8, 16, 32) and ns == -(-mK // kd)
        s, r0 = divmod(int(work[i, 12 + w] - o_r), mB)
        assert r0 % 16 == 0 and work[i, 8 + w] == min(16, mB - r0)
        assert work[i, 4 + w] == o_b + (s * mB + r0) * mK
        kets = [stages[n_st[i] + k // kd, work[i, 16 + w] + k % kd]
                for k in range(mK)]
        assert kets == perm[o_p + s * mK:o_p + (s + 1) * mK].tolist()
        seen[work[i, 12 + w]:work[i, 12 + w] + work[i, 8 + w]] += 1
    live = bra_rows >= 0
    assert (seen[live] == 1).all() and (seen <= 1).all()
    if sms == k1.DEFAULT_SMS:   # the pack holds this plan
        assert np.array_equal(plan.packed.work.numpy(), work)
        assert np.array_equal(plan.packed.stages.numpy(), stages)
        assert np.array_equal(plan.packed.bins.numpy(), bins)


@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_k1_small_buckets_fill_the_block(bra):
    """The 8- and 16-row buckets pack CW sectors a unit: all but at most
    one of their units keep every consumer warp busy."""
    plan = _k1_plan(14, bra, 1)
    work = plan.packed.work.numpy()
    for g, grp in enumerate(plan.groups):
        nS, mB, _ = grp.blocks.shape
        if mB > 16:
            continue
        busy = (work[work[:, 3] == g][:, 8:12] > 0).sum(1)
        assert nS >= k1.CW and (busy < k1.CW).sum() <= 1


def test_k1_bins_are_balanced():
    """Largest first onto the least loaded bin: no bin's byte count
    exceeds another's by more than the largest unit's."""
    plan = _k1_plan(14, "virtual", 1)
    work, _, bins = k1.plan_units(*_k1_args(plan), 132)
    # the planner's cost from a descriptor: slots, panels, stages
    cost = [8 * u[0] * (16 * (u[8:12] > 0).sum()
                        + 56 * len(set(u[16:20][u[8:12] > 0])))
            + k1.STAGE_COST * u[2] for u in work]
    loads = [sum(cost[bins[b, 0]:bins[b + 1, 0]]) for b in range(132)]
    assert max(loads) - min(loads) <= max(cost)


@pytest.mark.parametrize("nt", k1.TILES)
def test_k1_tile_fits_shared_memory(nt):
    """Each built column tile holds at least 3 stages in the 227 KB a
    block may use; 8 nt + 4 keeps the B fragment loads conflict-free."""
    smem = k1.smem_bytes(nt)
    sd = 8 * (k1.CW * 16 * k1.LDA + k1.TK * (8 * nt + 4) + k1.HDR)
    assert smem <= 227 * 1024 and smem >= 3 * sd
    assert (8 * nt + 4) % 16 in (4, 12) and k1.LDA % 16 == 4


@pytest.mark.parametrize("N", K1_WIDTHS)
def test_k1_column_tile_fits_the_width(N):
    nt, tiles = k1.plan(N)
    assert nt in k1.TILES
    assert 8 * nt * tiles >= N > 8 * nt * (tiles - 1)
    if N <= 128:                 # one tile: the ket panel gathered once
        assert tiles == 1 and nt == min(t for t in k1.TILES if 8 * t >= N)
    assert k1.plan(49) == (7, 1) and k1.plan(98) == (13, 1)
    assert k1.plan(6272) == (16, 49)


@pytest.mark.parametrize("mB,mK", [(8, 8), (12, 8), (8, 12), (4, 16),
                                   (16, 4), (24, 32)])
def test_k1_pack_takes_only_buckets_padded_to_8(mB, mK):
    """The kernel copies ket rows and bra ids 16 bytes at a time, so a
    bucket whose bra or ket count is not a multiple of 8 is refused."""
    group = (np.ones((2, mB, mK)), np.arange(2 * mK).reshape(2, mK) % mK,
             np.arange(2 * mB).reshape(2, mB))
    if mB % 8 or mK % 8:
        with pytest.raises(ValueError, match="multiple of 8"):
            k1.pack_groups([group], "cpu", 2 * mB)
    else:
        pack, _ = k1.pack_groups([group], "cpu", 2 * mB)
        assert pack.n_rows == 2 * mB and pack.zero_rows.numel() == 0


# ---- the f32 K1: items (a unit on a column tile) dealt to bins ------------

K1_F32_WIDTHS = [1, 33, 49, 98, 3136, 6272]


def _f32_walk(plan, N, sms):
    """The f32 kernel's plan at width N, walked as the kernel walks it:
    returns (records, bins, column tile, coverage) where coverage[row,
    tile] counts the stores of output row ``row`` in column tile
    ``tile`` (each live slot row of each item, and the zero rows)."""
    pk = plan.packed
    rec, bins, nc = k1.f32_plan(pk.work.numpy(), N, sms)
    bra_rows = pk.bra_of_row.numpy()
    tiles = -(-N // nc)
    cover = np.zeros((pk.n_rows, tiles), int)
    for w in range(k1.CW):
        alive, first = rec[:, 12 + w].astype(int), rec[:, 16 + w]
        item = np.repeat(np.arange(len(rec)), alive)
        offs = np.repeat(first, alive) + np.arange(alive.sum()) - np.repeat(
            np.cumsum(alive) - alive, alive)
        b = bra_rows[offs]
        np.add.at(cover, (b[b >= 0], rec[item[b >= 0], 1] // nc), 1)
    cover[pk.zero_rows.numpy()] += 1
    return rec, bins, nc, cover


@pytest.mark.parametrize("N", K1_F32_WIDTHS)
@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5, 14])
def test_k1_f32_items_store_every_output_once(cutoff, bra, N):
    """Every output row is stored exactly once in every column tile (by
    one slot of one item, or as a zero row); each record carries its
    unit's descriptor, its first stage-table row and the tile's n0."""
    plan = _k1_plan(cutoff, bra, 1)
    rec, bins, nc, cover = _f32_walk(plan, N, 132)
    assert nc in k1.F32_TILES and (cover == 1).all()
    work = plan.packed.work.numpy()
    u = rec[:, 5]
    st0 = np.cumsum(work[:, 2]) - work[:, 2]
    assert (rec[:, 0] == st0[u]).all() and (rec[:, 2:5] == work[u, :3]).all()
    assert (rec[:, 8:24] == work[u, 4:20]).all()
    assert (rec[:, 1] % nc == 0).all() and (rec[:, 1] < N).all()
    # each (unit, tile) once
    assert len({(a, b) for a, b in rec[:, [5, 1]]}) == len(rec) == \
        len(work) * -(-N // nc)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("N", K1_F32_WIDTHS)
@pytest.mark.parametrize("cutoff", [5, 14])
def test_k1_f32_bins_fill_every_sm_largest_first(cutoff, N, sms):
    """Two bins an SM whenever there are items enough (none empty), each
    bin's items largest first, and no bin's load above another's by more
    than the largest item's (largest first onto the least loaded)."""
    plan = _k1_plan(cutoff, "all", 1)
    rec, bins, _ = k1.f32_plan(plan.packed.work.numpy(), N, sms)
    items, cost, _ = k1.f32_items(plan.packed.work.numpy(), N)
    n_bins = len(bins) - 1
    assert n_bins == min(k1.F32_BLOCKS_PER_SM * sms, len(items))
    assert bins[0] == 0 and bins[-1] == len(rec) and (np.diff(bins) > 0).all()
    # the records are the items, dealt
    key = {(a, b): c for (a, b), c in zip(items[:, [5, 1]], cost)}
    c = np.array([key[(a, b)] for a, b in rec[:, [5, 1]]])
    loads = [c[bins[b]:bins[b + 1]].sum() for b in range(n_bins)]
    for b in range(n_bins):
        assert (np.diff(c[bins[b]:bins[b + 1]]) <= 0).all()
    assert max(loads) - min(loads) <= c.max()
    if len(items) >= k1.F32_BLOCKS_PER_SM * sms:
        assert n_bins == k1.F32_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("N", [1, 33, 98])
@pytest.mark.parametrize("bra", ["virtual", "all"])
def test_k1_f32_plan_computes_the_twin(bra, N):
    """The f32 kernel's arithmetic walked in numpy (f64) over its records:
    per item and live slot, each stage's kv A columns of the slot's rows
    times the planned ket rows of its panel, summed over the stages, then
    stored to the slot's bra rows on the item's columns; zero rows zero.
    It equals the twin (nP=19 and nP=57 plans)."""
    for cutoff in (2, 5):
        plan = _k1_plan(cutoff, bra, 1)
        pk = plan.packed
        Tt = np.random.default_rng(N).standard_normal((plan.nv ** 2, N))
        rec, _, nc = k1.f32_plan(pk.work.numpy(), N, 8)
        blocks, stages = pk.blocks.numpy(), pk.stages.numpy()
        bra_rows = pk.bra_of_row.numpy()
        out = np.full((pk.n_rows, N), np.nan)
        out[pk.zero_rows.numpy()] = 0.0
        for r in rec:
            st0, n0, mK, kd, nst = r[:5]
            cols = slice(n0, min(N, n0 + nc))
            for w in range(k1.CW):
                alive = r[12 + w]
                if alive == 0:
                    continue
                acc = np.zeros((alive, cols.stop - n0))
                for t in range(nst):
                    kv = min(kd, mK - t * kd)
                    A = np.stack([blocks[r[8 + w] + m * mK + t * kd:
                                         r[8 + w] + m * mK + t * kd + kv]
                                  for m in range(alive)])
                    kets = stages[st0 + t, r[20 + w]:r[20 + w] + kv]
                    acc += A @ Tt[kets, cols]
                for m in range(alive):
                    b = bra_rows[r[16 + w] + m]
                    if b >= 0:
                        out[b, cols] = acc[m]
        assert not np.isnan(out).any()
        # the kernel's row b is the twin's output column b
        want = k1.block_ladder_twin(plan.groups, plan.inv_bra,
                                    torch.as_tensor(Tt.T)).T.numpy()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("nc", k1.F32_TILES)
def test_k1_f32_block_fits_two_an_sm(nc, staged):
    """Each f32 block holds at least 3 stages (the ring) in its share of
    two blocks an SM; A rows lie 4 banks apart, so the 16-byte A loads of
    a quarter warp's four rows are free of conflicts."""
    smem = k1.f32_smem_bytes(nc, staged)
    sf = 4 * (k1.F32_HDR + k1.CW * 16 * k1.F32_LDA + k1.TK * nc)
    assert 3 * sf <= smem <= k1.F32_BLOCK_SMEM
    assert 2 * (smem + 1024) <= 228 * 1024
    assert k1.F32_LDA % 32 == 4 and (4 * k1.F32_HDR) % 16 == 0
    assert k1.f32_tile(49) == (64, 1) and k1.f32_tile(98) == (64, 2)
    assert k1.f32_tile(3136) == (128, 25) and k1.f32_tile(6272) == (128, 49)


# ---- the f32 K4: column tiles ------------------------------------------------

# (entries n = nv² no of a plan, columns, planned tile): the dressing (7)
# and an EOM batch (14) at nP=219, the RT nP=123 (448) and FEAST nP=57
# (896) lane batches
K4_F32_WIDTHS = [(212 * 212 * 7, 7, 4), (212 * 212 * 7, 14, 7),
                 (116 * 116 * 7, 448, 8), (50 * 50 * 7, 896, 8)]


@pytest.mark.parametrize("n,ncol,want", K4_F32_WIDTHS)
def test_k4_f32_plan_fills_the_card(n, ncol, want):
    """The f32 gather's column tile at the main widths: the widest up to
    F32_WIDE_TILE whose tiles with the entry tiles of F32_ENT give every
    SM three blocks, cut evenly."""
    ct = k4.plan_f32(n, ncol, 132)
    assert ct == want
    tiles_n, tiles_c = -(-n // k4.F32_ENT), -(-ncol // ct)
    fill = k4.FILL_BLOCKS_PER_SM * 132
    assert tiles_n * tiles_c >= fill
    # no wider tile with fewer column tiles fills the card
    assert all(tiles_n * -(-ncol // c) < fill
               for c in range(ct + 1, k4.F32_WIDE_TILE + 1)
               if -(-ncol // c) < tiles_c)
    assert ct * (tiles_c - 1) < ncol <= ct * tiles_c


@pytest.mark.parametrize("ncol", [1, 3, 7, 33, 129, 896])
@pytest.mark.parametrize("n", [1, 175, 17500, 314608])
@pytest.mark.parametrize("sms", [132, 8])
def test_k4_f32_plan_tiles_any_width(n, ncol, sms):
    """Any width gets tiles of at most F32_WIDE_TILE columns that cut it
    evenly (tiles differ by at most one column) in a launchable grid."""
    ct = k4.plan_f32(n, ncol, sms)
    tiles_c = -(-ncol // ct)
    assert 1 <= ct <= min(ncol, k4.F32_WIDE_TILE)
    assert ct * (tiles_c - 1) < ncol <= ct * tiles_c
    assert ncol - ct * (tiles_c - 1) >= ct - tiles_c + 1
    assert tiles_c <= k4.MAX_GRID_Y


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


# ---- the f32 K7: equal shares of the lanes' rows laid end to end ------------

# (n, La, m of each lane): the FEAST nP=57 and RT nP=123 lane shapes at the
# timed m and at uneven m on both sides of every G threshold, odd n, a
# lane count past the grid, single lanes
K7_F32_SHAPES = [(245700, 64, (60,)), (1320312, 32, (10,)),
                 (245700, 64, (1, 15, 16, 31, 32, 63, 64, 120)),
                 (1320312, 32, (4, 16, 20, 9)), (300001, 6, (17, 3, 90)),
                 (4096, 62, (2, 40)), (9000, 200, (5,)), (7, 1, (1,)),
                 (70001, 1, (120,))]


def _k7_ms(La, pattern):
    return tuple(pattern[a % len(pattern)] for a in range(La))


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,La,pattern", K7_F32_SHAPES)
def test_k7_f32_walk_covers_every_lane_column_once_a_pass(n, La, pattern,
                                                          sms):
    """Each pass of the f32 plan's walk stores every column of every active
    lane once; a block keeps its items in all three passes, takes them and
    their tiles forward, backward, forward; the grid is no larger than the
    resident blocks, and every block streams an equal share."""
    ms = _k7_ms(La, pattern)
    nb = arnoldi.F32_BLOCKS_PER_SM * sms
    plan = arnoldi.f32_plan(n, La, nb)
    assert plan.blocks <= nb and plan.share % 4 == 0
    # equal shares: every block but the last has share columns
    assert (plan.blocks - 1) * plan.share < La * n <= plan.blocks * plan.share
    walk = arnoldi.f32_walk(plan, n, ms)
    assert len(walk) == plan.blocks
    cover = np.zeros((3, La, n), dtype=np.int64)
    blocks_of = [set() for _ in range(La)]
    for b, (items, steps) in enumerate(walk):
        assert sum(ce - cb for _, (cb, ce) in items) <= plan.share
        for a, _ in items:
            blocks_of[a].add(b)
        for p in range(3):
            mine = [s for s in steps if s[0] == p]
            order = [a for _, a, _ in mine]
            want = [a for a, _ in items]
            assert order == (want[::-1] if p == 1 else want)
            for (_, a, tiles), (_, (cb, ce)) in zip(
                    mine, items[::-1] if p == 1 else items):
                starts = [c0 for c0, _ in tiles]
                assert starts == sorted(starts, reverse=(p == 1))
                for c0, c1 in tiles:
                    assert cb <= c0 < c1 <= ce
                    assert c1 - c0 <= arnoldi.f32_tile_cols(ms[a])
                    cover[p, a, c0:c1] += 1
    assert (cover == 1).all()
    # the partials' layout holds every lane's blocks, numbered from its
    # first
    assert max(len(s) for s in blocks_of) <= plan.maxg
    for s_ in blocks_of:
        assert sorted(s_) == list(range(min(s_), max(s_) + 1))


@pytest.mark.parametrize("n,La,pattern", K7_F32_SHAPES)
def test_k7_f32_row_segments_stay_16_byte_aligned(n, La, pattern):
    """Where n is a multiple of 4 every tile of every block starts on a
    multiple of 4 columns of its lane, so every row segment of the 16-byte
    copies is 16-byte aligned; else the kernel takes 4-byte copies."""
    ms = _k7_ms(La, pattern)
    walk = arnoldi.f32_walk(arnoldi.f32_plan(n, La, 132), n, ms)
    starts = {c0 for _, steps in walk for _, _, tiles in steps
              for c0, _ in tiles}
    if n % 4 == 0:
        assert all(c0 % 4 == 0 for c0 in starts)
    # the shares' cut points in the lanes' rows laid end to end
    plan = arnoldi.f32_plan(n, La, 132)
    assert all((b * plan.share) % 4 == 0 for b in range(plan.blocks))


@pytest.mark.parametrize("m", [0, 1, 10, 15, 16, 20, 31, 32, 60, 63, 64, 90,
                               120, 127])
def test_k7_f32_tile_fits_the_ring(m):
    """G threads a column quad keep a thread at most 16 rows; the (m + 1)
    row tile of 1024/G columns leaves the 192 KB ring at least 3 buffers
    (2 in flight while one is summed); the block fits one an SM."""
    G = arnoldi.f32_parts(m)
    assert G in (1, 2, 4, 8) and -(-m // G) <= arnoldi.F32_PART_ROWS
    assert arnoldi.f32_tile_cols(m) == 1024 // G
    nbuf = arnoldi.f32_ring_buffers(m)
    assert 3 <= nbuf <= arnoldi.F32_MAX_BUF
    assert nbuf * (m + 1) * arnoldi.f32_tile_cols(m) <= arnoldi.F32_RING_FLOATS
    assert arnoldi.F32_SMEM <= 227 * 1024
    assert m + 1 <= arnoldi.MAX_ROWS


@pytest.mark.parametrize("n,La,pattern", [(4096, 62, (2, 40)),
                                          (3001, 5, (17, 3, 30)),
                                          (20000, 3, (70, 1, 16))])
def test_k7_f32_walk_computes_the_twin(n, La, pattern):
    """The f32 kernel's arithmetic walked in numpy over the plan (sm = 8):
    each block's partial row dots of its items a pass, summed over the
    lane's blocks; w1 and the new row rounded to f32 where the kernel
    stores them; the guarded scale.  It equals the twin: the rows within
    one f32 rounding, the Hessenberg column within 1e-7 of its largest
    entry (the sums' order differs from the twin's, so w1's rounding to
    f32, 6e-8 relative, flips in some columns and enters h2)."""
    rng = np.random.default_rng(n + La)
    ms = _k7_ms(La, pattern)
    R1 = max(ms) + 2
    L = La + 1
    V = rng.standard_normal((L, R1, n)).astype(np.float32) / np.sqrt(n)
    w = rng.standard_normal((La, n)).astype(np.float32)
    lanes = rng.permutation(L)[:La]
    plan = arnoldi.f32_plan(n, La, 8)
    walk = arnoldi.f32_walk(plan, n, ms)
    Vd = V.astype(np.float64)
    H = np.zeros((La, R1))
    wk = w.astype(np.float64)
    h = [np.zeros(m) for m in ms]
    nrm2 = np.zeros(La)
    row = np.zeros((La, n))
    for p in range(3):
        part = [np.zeros(max(m, 1)) for m in ms]
        for _, steps in walk:
            for q, a, tiles in steps:
                if q != p:
                    continue
                Vl, m = Vd[lanes[a], :ms[a]], ms[a]
                for c0, c1 in tiles:
                    if p == 0:
                        part[a][:m] += Vl[:, c0:c1] @ wk[a, c0:c1]
                        continue
                    x = wk[a, c0:c1] - h[a] @ Vl[:, c0:c1]
                    if p == 1:
                        wk[a, c0:c1] = x.astype(np.float32)
                        part[a][:m] += Vl[:, c0:c1] @ wk[a, c0:c1]
                    else:
                        row[a, c0:c1] = x
                        part[a][0] += x @ x
        for a, m in enumerate(ms):
            if p < 2:
                h[a] = part[a][:m]
                H[a, :m] += h[a]
            else:
                nrm2[a] = part[a][0]
    twin_V = torch.as_tensor(V.copy())
    want = arnoldi.arnoldi_cgs2_twin(twin_V, torch.as_tensor(w),
                                     torch.as_tensor(lanes),
                                     torch.as_tensor(ms)).numpy()
    for a, m in enumerate(ms):
        H[a, m] = np.sqrt(nrm2[a])
        brk = arnoldi.BREAK_F32
        scale = 1.0 / max(H[a, m], brk) if H[a, m] > brk else 0.0
        got = (scale * row[a].astype(np.float32).astype(np.float64)).astype(
            np.float32)
        np.testing.assert_allclose(got, twin_V[lanes[a], m].numpy(),
                                   rtol=0, atol=2e-7 * np.abs(got).max())
    np.testing.assert_allclose(H, want, rtol=0,
                               atol=1e-7 * np.abs(want).max())


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


def _digits(p, no, nv):
    """(i, j, a, b) of T2 positions p; i unreduced, as ``digits``."""
    r, q = np.divmod(p, nv * nv)
    i, j = np.divmod(r, no)
    a, b = np.divmod(q, nv)
    return [i, j, a, b]


def _step1(x, no, nv):
    i, j, a, b = (t.copy() for t in x)
    b += 1
    c = b == nv
    b[c] = 0
    a[c] += 1
    c &= a == nv
    a[c] = 0
    j[c] += 1
    c &= j == no
    j[c] = 0
    i[c] += 1
    return [i, j, a, b]


def _stepd(x, d, no, nv):
    i, j, a, b = x
    b = b + d[3]
    c = b >= nv
    b = b - np.where(c, nv, 0)
    a = a + d[2] + c
    c = a >= nv
    a = a - np.where(c, nv, 0)
    j = j + d[1] + c
    c = j >= no
    j = j - np.where(c, no, 0)
    return [i + d[0] + c, j, a, b]


def _tail_walk(p, n1, no, nv, jacobi):
    """Every flat position a tail pass touches, with the T2 digits it
    computes there, as ``csrc/cc_tail.cu`` walks them: the scalar loop
    (the T1 segment in the Jacobi pass, the T2 head and tail), the T1 mix
    launch (the mix pass), and each thread's vectors from its first
    position's digits stepped by the grid stride."""
    S, W = p.grid * ccsd_tail.THREADS, p.vec
    pos, dig = [], []
    s = np.arange((n1 if jacobi else 0) + p.head + p.tail)
    if jacobi:
        pos.append(s[s < n1])
        s = s[s >= n1] - n1
    else:
        assert (p.grid1 >= 1) == (n1 > 0)     # a grid-stride loop of n1
        pos.append(np.arange(n1))
    t2 = np.where(s < p.head, s, s + p.nvec * W)
    pos.append(n1 + t2)
    dig.append((t2, _digits(t2, no, nv)))
    v = np.arange(S)
    x = _digits(p.head + v * W, no, nv)
    d = _digits(np.asarray(S * W), no, nv)
    while (v < p.nvec).any():
        live = v < p.nvec
        y = [t[live] for t in x]
        for w in range(W):
            t2 = p.head + v[live] * W + w
            pos.append(n1 + t2)
            dig.append((t2, y))
            y = _step1(y, no, nv)
        x = _stepd(x, d, no, nv)
        v = v + S
    return np.concatenate(pos), dig


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("bases", [(0, 0), (3, 1), (1, 1)])
@pytest.mark.parametrize("no,nv,t1", [(3, 23, False), (3, 23, True),
                                      (4, 22, True), (2, 9, True)])
@pytest.mark.parametrize("elem", [8, 4])
def test_tail_plan_covers_every_element_once(elem, no, nv, t1, bases, sms):
    """Both tail passes touch every element of [T1 | T2] once, with the
    digits (i, j, a, b) of its T2 position, for N1 = 0 (no T1 segment; N
    = 4761, odd: scalars), N1 odd (69: the rings' and the flat operands'
    phases differ), N1 aligned (88) and a short vector (N1 = 18), the
    operands at one phase or several (``bases``: the rings' and the flat
    operands' first element, in elements), a grid of one wave or of
    several strides; every vector lies aligned in every operand."""
    n1 = nv * no if t1 else 0
    n = n1 + no * no * nv * nv
    w = ccsd_tail.VECTOR_BYTES // elem
    ring, flat = bases
    phases = ((ring + n1) % w,) * 2 + (flat % w,) * 3
    p = ccsd_tail.plan(n1, n, 6, elem, phases, sms)
    assert p.vec in (1, 2, 4) and p.vec * elem <= ccsd_tail.VECTOR_BYTES
    assert n % p.vec == 0
    assert all((ph + p.head) % p.vec == 0 for ph in phases)
    assert p.head + p.nvec * p.vec + p.tail == n - n1
    assert 0 <= p.head < max(p.vec, 1) and 0 <= p.tail < p.vec
    assert 1 <= p.grid <= ccsd_tail.BLOCKS_PER_SM * sms
    if len({ph % w for ph in phases}) == 1 and n % w == 0:
        assert p.vec == w                        # the widest load
    for jacobi in (True, False):
        pos, dig = _tail_walk(p, n1, no, nv, jacobi)
        assert np.array_equal(np.sort(pos), np.arange(n))
        for t2, y in dig:
            for got, want in zip(y, _digits(t2, no, nv)):
                assert np.array_equal(got, want)


@pytest.mark.parametrize("m", [1, 6, 17])
def test_tail_slot_groups_cover_the_valid_slots_once(m):
    """The Gram sums take the valid slots in groups of at most SLOTS held
    in registers: every slot below n_valid once, in order; m = 17 takes
    more than one group."""
    for n_valid in range(1, m + 1):
        groups = ccsd_tail.plan(0, 4096, n_valid, 8, (0, 0, 0, 0),
                                132).groups
        slots = [g0 + k for g0, ng in groups for k in range(ng)]
        assert slots == list(range(n_valid))
        assert all(1 <= ng <= ccsd_tail.SLOTS for _, ng in groups)
    assert len(groups) == -(-m // ccsd_tail.SLOTS)


@pytest.mark.parametrize("elem", [8, 4])
@pytest.mark.parametrize("t1", [False, True])
def test_tail_plan_at_the_main_path_shapes(elem, t1):
    """At nP=219 (no = 7, nv = 212) on fresh allocations both passes load
    16-byte vectors with no scalar head or tail, on a persistent grid of
    BLOCKS_PER_SM blocks an SM of the H100's 132; the T1 segment (1484
    elements) takes 6 blocks of the T1 mix."""
    no, nv = 7, 212
    n1 = nv * no if t1 else 0
    n = n1 + no * no * nv * nv
    p = ccsd_tail.plan(n1, n, 6, elem, (n1 % 4,) * 2 + (0,) * 3, 132)
    assert (p.vec, p.head, p.tail) == (16 // elem, 0, 0)
    assert p.grid == ccsd_tail.BLOCKS_PER_SM * 132
    assert p.grid1 == (6 if t1 else 0)
