"""K1 wrapper: the momentum-sector ladder GEMM, its planners and its twin.

Replaces B1, ``pymes_tpu/ops/ueg_ladder.py:450`` ``block_ladder_apply_ij``
(TPU form ``block_ladder_apply_ij_ozaki``, :533).  The kernel is CUDA C++
on the f64 tensor cores (``pymes_tpu_torch/csrc/block_ladder.cu``, built
with nvcc for sm_90a at first use), with an f32 kernel of its own on the
CUDA cores (FFMA) over the same units for the f32 sigmas and ground-state
bulk of the precision modes (a plan in f32:
:func:`pymes_tpu_torch.ops.ueg_ladder.cast_plan`); its source says what
bounds each and how the design answers.

:class:`LadderPack` is the kernel's view of a plan: every group's blocks,
``perm_ket`` and ``bra_of_row`` in three flat device buffers (the plan's
per-group tensors are views into them), the work units with the ket row
of every B row of every pipeline stage, binned one bin per SM, and the
rows that no sector writes.  :func:`plan_units` (at plan-build time) and :func:`plan`
(the column tile of an operand width, at launch) are plain Python, so the
CPU tests reach them; so is :func:`f32_plan`, the f32 kernel's work items
(a unit on a column tile) dealt to two bins an SM, built once per plan and
width and kept on the pack.
"""

import functools
import heapq
from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

# the kernel's geometry; must equal csrc/block_ladder.cu (the shared
# memory per tile is checked against the library at first launch)
CW = 4                 # consumer warps: m16 row slots of a work unit
TK = 32                # B rows of a pipeline stage, split among the panels
LDA = TK + 4           # padded A row of a stage, doubles
UNIT = 20              # ints of a work unit
HDR = 44               # doubles of a stage's unit header (84 ints, padded)
SMEM_BUDGET = 227 * 1024
MAX_STAGES = 6
HELD_BYTES = 4 * TK * 32 + 4 * UNIT * 16   # 32 stage rows, 16 descriptors
BRA_PAD = 16           # -1 entries after bra_of_row (a header reads 16)
TILES = (1, 2, 4, 7, 8, 13, 16)   # column tiles built, in n8 tiles
# H100 SMs: the bins of a plan built for a CPU device
DEFAULT_SMS = 132
# planner's cost of a pipeline stage beyond its bytes (the block's turn
# through the barriers), in bytes
STAGE_COST = 2048
# the f32 kernel's geometry; must equal csrc/block_ladder.cu namespace f32k
F32_TILES = (64, 128)  # column tiles built
F32_WIDE = 384         # the width from which the 128-column tile is taken
F32_REC = 24           # ints of an item record
F32_HDR = F32_REC + 16 * CW          # ints of a stage's header
F32_LDA = TK + 4       # padded A row of a stage, floats
F32_BLOCK_SMEM = 113 * 1024          # two blocks an SM
F32_MAX_STAGES = 6
F32_BLOCKS_PER_SM = 2
# planner's cost of an f32 stage beyond its bytes, and the FFMA count that
# costs an SM as long as one byte of its share of HBM
F32_STAGE_COST = 1024
F32_FMA_PER_BYTE = 8


class LadderPack(NamedTuple):
    blocks: torch.Tensor      # f64 (f32: cast_plan), all groups' blocks
    perm: torch.Tensor        # int32, all groups' (nS, mK) ket-pair ids
    bra_of_row: torch.Tensor  # int32, all groups' (nS, mB) bra ids (−1 pad)
    work: torch.Tensor        # int32 (n_units, UNIT), bin after bin
    stages: torch.Tensor      # int32 (n_stages, TK): ket row of each B row
    bins: torch.Tensor        # int32 (n_bins + 1, 2): first unit, stage
    zero_rows: torch.Tensor   # int32: output rows no sector writes
    n_rows: int               # output rows (n_bra², or a shard's rows)
    f32_plans: dict           # (width, SMs) → the f32 kernel's items


def smem_bytes(nt):
    """Shared memory of a block at a column tile of ``nt`` n8 tiles: as
    many stages of (64 A rows × LDA) + (TK B rows × (8 nt + 4)) + HDR
    doubles as fit the budget beside what the producers hold (at most
    MAX_STAGES), that, and two mbarriers a stage."""
    sd = CW * 16 * LDA + TK * (8 * nt + 4) + HDR
    stages = min(MAX_STAGES, (SMEM_BUDGET - HELD_BYTES - 256) // (8 * sd))
    return 8 * stages * sd + HELD_BYTES + 16 * stages


@functools.lru_cache(maxsize=64)
def plan(N):
    """(nt, column tiles) for an operand of N columns: the narrowest built
    tile that holds N in one (N = 49: 7 n8 tiles, 56 columns), else tiles
    of 8 or 16 n8 tiles, whichever pads less (ties to the wider)."""
    if N <= 8 * TILES[-1]:
        nt = next(t for t in TILES if 8 * t >= N)
    else:
        nt = min((16, 8), key=lambda t: -(-N // (8 * t)) * 8 * t - N)
    return nt, -(-N // (8 * nt))


def f32_smem_bytes(nc, staged):
    """Shared memory of an f32 block at a column tile of ``nc`` columns:
    as many stages of (header + 64 A rows × F32_LDA + TK B rows × nc)
    floats as fit F32_BLOCK_SMEM beside the staging rows of the unaligned
    stores (``staged``: 16 rows of nc + 4 floats and 16 bra ids a consumer
    warp), at most F32_MAX_STAGES, and two mbarriers a stage."""
    sf = F32_HDR + CW * 16 * F32_LDA + TK * nc
    stg = CW * 16 * (nc + 4) + CW * 16 if staged else 0
    stages = min(F32_MAX_STAGES, (F32_BLOCK_SMEM - 4 * stg - 256) // (4 * sf))
    return 4 * (stages * sf + stg) + 16 * stages


def f32_tile(N):
    """(column tile, tiles) of the f32 kernel at width N: 64 columns below
    F32_WIDE (one or two tiles at the EOM and ground-state widths), 128
    from it (half the A re-reads and item turns a column)."""
    nc = F32_TILES[1] if N >= F32_WIDE else F32_TILES[0]
    return nc, -(-N // nc)


def f32_items(work, N):
    """The f32 kernel's items at width N, unit by unit (``work`` in pack
    order, :func:`plan_units`) and column tile by tile (:func:`f32_tile`):
    (records (n_items, F32_REC), costs, column tile).  A record: [0] the
    unit's first stage-table row, [1] n0, [2] mK, [3] kd, [4] stages, [5]
    the unit, [8:24] its descriptor's [4:20] (each slot's first A element,
    live rows, first bra_of_row entry and panel's first B row).  An item's
    cost is its bytes (A rows, ket panels and output rows of its tile),
    F32_STAGE_COST a stage and its FFMAs at F32_FMA_PER_BYTE."""
    work = np.asarray(work, np.int64).reshape(-1, UNIT)
    nc, tiles = f32_tile(N)
    nu = len(work)
    busy = work[:, 8:12] > 0
    slots = busy.sum(1)
    panels = np.array([len(set(r[16:20][b])) for r, b in zip(work, busy)],
                      np.int64)
    u = np.repeat(np.arange(nu), tiles)
    n0 = np.tile(np.arange(tiles), nu) * nc
    cols = np.minimum(nc, N - n0)
    mK, nst = work[u, 0], work[u, 2]
    cost = (4 * mK * (16 * slots[u] + cols * panels[u])
            + 4 * 16 * slots[u] * cols + F32_STAGE_COST * nst
            + 16 * slots[u] * mK * nc // F32_FMA_PER_BYTE)
    rec = np.zeros((len(u), F32_REC), np.int64)
    rec[:, 0] = (np.cumsum(work[:, 2]) - work[:, 2])[u]
    rec[:, 1], rec[:, 2], rec[:, 3], rec[:, 4], rec[:, 5] = (
        n0, mK, work[u, 1], nst, u)
    rec[:, 8:24] = work[u, 4:20]
    return rec, cost, nc


def f32_plan(work, N, sms):
    """The f32 kernel's work at width N on ``sms`` SMs: the items of
    :func:`f32_items` dealt largest first onto the least loaded of
    ``F32_BLOCKS_PER_SM·sms`` bins (at most one an item, at least one),
    each kept in dealt order.  Returns (records bin by bin, bins (n_bins +
    1,): each bin's first record, column tile), int32."""
    rec, cost, nc = f32_items(work, N)
    n_bins = max(1, min(F32_BLOCKS_PER_SM * sms, len(rec)))
    heap = [(0, b) for b in range(n_bins)]
    members = [[] for _ in range(n_bins)]
    for i in np.argsort(-cost, kind="stable"):
        load, b = heapq.heappop(heap)
        members[b].append(i)
        heapq.heappush(heap, (load + int(cost[i]), b))
    order = np.asarray([i for m in members for i in m], np.int64)
    bins = np.concatenate([[0], np.cumsum([len(m) for m in members])])
    return (rec[order].astype(np.int32).reshape(-1, F32_REC),
            bins.astype(np.int32), nc)


def _parts_cost(mK, parts):
    """A unit's planning cost: its bytes (A rows; B panels at N = 49)
    plus STAGE_COST a stage.  ``parts`` lists (sector, [first rows of its
    m16 tiles]); each part is a panel, each tile a consumer warp's slot."""
    npan = (1, 1, 2, 4, 4)[len(parts)]
    slots = sum(len(t) for _, t in parts)
    return (8 * mK * (16 * slots + 56 * len(parts))
            + STAGE_COST * -(-mK // (TK // npan)))


def _unit_rows(g, shape, offs, parts, perm, bra):
    """One unit's descriptor and its stages' B rows.

    Descriptor (UNIT ints): [0] mK, [1] kd (B rows of a panel in a stage:
    TK / panels), [2] stages, [3] group, [4:8] each slot's first A element
    (row r0 of its sector, column 0) in the blocks buffer, [8:12] its live
    rows (0: idle slot), [12:16] its first ``bra_of_row`` entry, [16:20]
    the first B row of its panel in a stage.  Stage t holds k in [t·kd,
    (t+1)·kd) of every panel: B row j·kd + i is ket ``perm[sector_j,
    t·kd + i]`` (−1 past mK or past the panels)."""
    nS, mB, mK = shape
    o_b, o_p, o_r = offs
    npan = (1, 1, 2, 4, 4)[len(parts)]
    kd = TK // npan
    n_st = -(-mK // kd)
    row = [mK, kd, n_st, g] + [0] * 16
    slot = 0
    for j, (s, tiles) in enumerate(parts):
        for r0 in tiles:
            row[4 + slot] = o_b + (s * mB + r0) * mK
            row[8 + slot] = min(16, mB - r0)
            row[12 + slot] = o_r + s * mB + r0
            row[16 + slot] = j * kd
            slot += 1
    st = np.full((n_st, TK), -1, np.int64)
    for j, (s, _) in enumerate(parts):
        ket = perm[o_p + s * mK:o_p + (s + 1) * mK]
        for t in range(n_st):
            k = ket[t * kd:(t + 1) * kd]
            st[t, j * kd:j * kd + len(k)] = k
    return row, st


def plan_units(shapes, perm, bra, sms):
    """The work units of a plan, their stages and their bins.

    ``shapes`` lists each group's (nS, mB, mK); ``perm`` and ``bra`` are
    the flat ``perm_ket`` and ``bra_of_row`` of all groups in order.  A
    sector's m16 row tiles that hold a bra row go CW at a time into units
    of their own (one ket panel per CW·16 rows); the leftover tiles of a
    bucket (fewer than CW a sector) are packed first-fit, most tiles
    first, into units of up to CW slots and CW panels.  The units are
    dealt to ``sms`` bins largest first, each to the least loaded bin (by
    :func:`_parts_cost`), and kept in that order in a bin.  Returns (units
    (n, UNIT), stages (n_stages, TK), bins (sms + 1, 2): each bin's first
    unit and first stage), int32."""
    units = []                                  # (cost, g, parts)
    offs = np.zeros(3, np.int64)
    goffs = []
    for g, (nS, mB, mK) in enumerate(shapes):
        goffs.append(tuple(int(o) for o in offs))
        live = bra[offs[2]:offs[2] + nS * mB].reshape(nS, mB) >= 0
        offs += (nS * mB * mK, nS * mK, nS * mB)
        pieces = []
        for s in range(nS):
            tiles = [r0 for r0 in range(0, mB, 16)
                     if live[s, r0:r0 + 16].any()]
            whole = len(tiles) - len(tiles) % CW
            units.extend((g, [(s, tiles[i:i + CW])])
                         for i in range(0, whole, CW))
            if whole < len(tiles):
                pieces.append((s, tiles[whole:]))
        pieces.sort(key=lambda pc: -len(pc[1]))
        packs, free = [], []
        for pc in pieces:
            for i, f in enumerate(free):
                if f >= len(pc[1]):
                    packs[i].append(pc)
                    free[i] -= len(pc[1])
                    break
            else:
                packs.append([pc])
                free.append(CW - len(pc[1]))
        units.extend((g, pk) for pk in packs)
    if offs[0] >= 2 ** 31:
        raise ValueError("sector blocks past int32 offsets")
    cost = [_parts_cost(shapes[g][2], parts) for g, parts in units]
    heap = [(0, b) for b in range(sms)]
    members = [[] for _ in range(sms)]
    for i in sorted(range(len(units)), key=lambda i: -cost[i]):
        load, b = heapq.heappop(heap)
        members[b].append(i)
        heapq.heappush(heap, (load + cost[i], b))
    rows, stages, bins = [], [], [(0, 0)]
    for m in members:
        for i in m:
            g, parts = units[i]
            row, st = _unit_rows(g, shapes[g], goffs[g], parts, perm, bra)
            rows.append(row)
            stages.append(st)
        bins.append((len(rows), sum(len(st) for st in stages)))
    return (np.asarray(rows, np.int32).reshape(-1, UNIT),
            np.concatenate(stages).astype(np.int32) if stages
            else np.zeros((0, TK), np.int32),
            np.asarray(bins, np.int32))


def pack_groups(group_arrays, device, n_rows):
    """Pack host arrays ``[(blocks, perm_ket, bra_of_row), ...]`` (in the
    plan's concat order) into one :class:`LadderPack` on ``device`` for an
    output of ``n_rows`` rows.  Returns ``(pack, [(blocks, perm_ket,
    bra_of_row) views per group])``."""
    device = torch.device(device)
    blk = [np.asarray(b, dtype=np.float64).ravel() for b, _, _ in group_arrays]
    prm = [np.asarray(p, dtype=np.int32).ravel() for _, p, _ in group_arrays]
    bra = [np.asarray(r, dtype=np.int32).ravel() for _, _, r in group_arrays]
    shapes = [tuple(np.shape(b)) for b, _, _ in group_arrays]
    for _, mB, mK in shapes:
        # the kernel copies ket rows and bra ids 16 bytes at a time
        if mK % 8 or mB % 8:
            raise ValueError(f"a bucket of {mB} bra and {mK} ket pairs: K1 "
                             "takes sectors padded to a multiple of 8")

    def cat(arrs, dt):
        return np.concatenate(arrs).astype(dt) if arrs else np.zeros(0, dt)

    perm_all, bra_all = cat(prm, np.int32), cat(bra, np.int32)
    sms = (_build.sm_count(device) if device.type == "cuda"
           else DEFAULT_SMS)
    work, stages, bins = plan_units(shapes, perm_all, bra_all, sms)
    written = np.zeros(n_rows, bool)
    written[bra_all[bra_all >= 0]] = True

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    pack = LadderPack(
        blocks=dev(cat(blk, np.float64)), perm=dev(perm_all),
        bra_of_row=dev(np.concatenate([bra_all, np.full(BRA_PAD, -1,
                                                         np.int32)])),
        work=dev(work), stages=dev(stages), bins=dev(bins),
        zero_rows=dev(np.nonzero(~written)[0].astype(np.int32)),
        n_rows=int(n_rows), f32_plans={})
    views, o_b, o_p, o_r = [], 0, 0, 0
    for nS, mB, mK in shapes:
        views.append((pack.blocks[o_b:o_b + nS * mB * mK].view(nS, mB, mK),
                      pack.perm[o_p:o_p + nS * mK].view(nS, mK),
                      pack.bra_of_row[o_r:o_r + nS * mB].view(nS, mB)))
        o_b, o_p, o_r = o_b + nS * mB * mK, o_p + nS * mK, o_r + nS * mB
    return pack, views


def block_ladder_twin(groups, inv_bra, T2):
    """Plain PyTorch twin (the JAX algorithm): per group a ket gather,
    one ``torch.bmm`` over the sectors, then the ``inv_bra`` gather of the
    concatenated columns (+ a trailing zero column).  ``T2`` is
    (no², nv²); returns (no², n_bra²)."""
    no2 = T2.shape[0]
    cols = []
    for g in groups:
        nS, mK = g.perm_ket.shape
        Tg = T2.index_select(1, g.perm_ket.reshape(-1).long())
        Tg = Tg.reshape(no2, nS, mK).permute(1, 0, 2)          # (nS, no2, mK)
        Rg = torch.bmm(Tg, g.blocks.transpose(1, 2))           # (nS, no2, mB)
        cols.append(Rg.permute(1, 0, 2).reshape(no2, -1))
    cols.append(T2.new_zeros((no2, 1)))
    return torch.cat(cols, dim=1).index_select(1, inv_bra)


_SMEM_CHECKED = set()


def block_ladder_kernel_cd(pack: LadderPack, Tt, n_out, nv):
    """Launch K1 on a cd-major operand ``Tt`` (nv², n), a CUDA tensor with
    unit column stride and any row stride ≥ n; returns the bra-major
    output (n_out, n): row r holds the pack's rows whose ``bra_of_row`` is
    r (n_bra² rows for a whole plan, the shard's own rows for a shard of a
    sector-sharded plan).  Operand and blocks are both float64 (the DMMA
    kernel) or both float32 (the f32 kernel)."""
    sfx = kernels.type_suffix("the ladder kernel", Tt, pack.blocks)
    if pack.blocks.device != Tt.device:
        raise ValueError("plan and amplitudes lie on different devices")
    if (Tt.dim() != 2 or Tt.shape[0] != nv * nv or Tt.stride(1) != 1
            or Tt.stride(0) < Tt.shape[1]):
        raise ValueError(f"operand of shape {tuple(Tt.shape)}, strides "
                         f"{Tt.stride()} is not a row-major cd-major "
                         f"(nv², n) with nv={nv}")
    if n_out != pack.n_rows:
        raise ValueError(f"{n_out} output rows for a plan of {pack.n_rows}")
    n = Tt.shape[1]
    lib = _build.library()
    if sfx:
        return _block_ladder_f32(lib, pack, Tt, n_out)
    nt, _ = plan(n)
    if nt not in _SMEM_CHECKED:
        if lib.pymes_block_ladder_smem(nt) != smem_bytes(nt):
            raise RuntimeError("smem_bytes differs from csrc/block_ladder.cu")
        _SMEM_CHECKED.add(nt)
    outT = torch.empty((n_out, n), dtype=Tt.dtype, device=Tt.device)
    args = (Tt.data_ptr(), Tt.stride(0), pack.blocks.data_ptr(),
            pack.bra_of_row.data_ptr(), pack.work.data_ptr(),
            pack.stages.data_ptr(), pack.bins.data_ptr(),
            int(pack.bins.shape[0]) - 1, pack.zero_rows.data_ptr(),
            int(pack.zero_rows.shape[0]), outT.data_ptr(), int(n), nt)
    rc = _build.launch(Tt.device, lib.pymes_block_ladder, *args)
    if rc != 0:
        raise RuntimeError(f"block_ladder launch failed: cudaError {rc}")
    kernels.LAUNCHES["block_ladder"] += 1
    return outT


_SMEM_CHECKED_F32 = set()


def _block_ladder_f32(lib, pack, Tt, n_out):
    """The f32 kernel on the checked operand, with the width's items (built
    at its first launch on the plan, then kept on the pack)."""
    n, dev = Tt.shape[1], Tt.device
    sms = _build.sm_count(dev)
    fp = pack.f32_plans.get((n, sms))
    if fp is None:
        items, bins, nc = f32_plan(pack.work.cpu().numpy(), n, sms)
        for staged in (False, True):
            if (nc, staged) not in _SMEM_CHECKED_F32:
                if (lib.pymes_block_ladder_f32_smem(nc, int(staged))
                        != f32_smem_bytes(nc, staged)):
                    raise RuntimeError("f32_smem_bytes differs from "
                                       "csrc/block_ladder.cu")
                _SMEM_CHECKED_F32.add((nc, staged))
        fp = pack.f32_plans[(n, sms)] = (
            torch.as_tensor(items, device=dev),
            torch.as_tensor(bins, device=dev), nc)
    items, bins, nc = fp
    if pack.blocks.data_ptr() % 16:
        raise ValueError("the f32 kernel copies the sector blocks 16 bytes "
                         "at a time: their buffer must be 16-byte aligned")
    vec4 = int(Tt.data_ptr() % 16 == 0 and Tt.stride(0) % 4 == 0)
    outT = torch.empty((n_out, n), dtype=Tt.dtype, device=dev)
    rc = _build.launch(dev, lib.pymes_block_ladder_f32, Tt.data_ptr(),
                       Tt.stride(0), vec4, pack.blocks.data_ptr(),
                       pack.bra_of_row.data_ptr(), items.data_ptr(),
                       pack.stages.data_ptr(), bins.data_ptr(),
                       int(bins.shape[0]) - 1, pack.zero_rows.data_ptr(),
                       int(pack.zero_rows.shape[0]), outT.data_ptr(), int(n),
                       nc)
    if rc != 0:
        raise RuntimeError(f"block_ladder_f32 launch failed: cudaError {rc}")
    kernels.LAUNCHES["block_ladder_f32"] += 1
    return outT


def block_ladder_kernel(pack: LadderPack, T2, n_out, nv):
    """Launch K1 on ``T2`` (no², nv²), a CUDA f64 or f32 tensor; returns
    the (no², n_out) result as the transposed view of the bra-major output.
    The cd-major copy of T2 gets a row stride of whole 16-byte words, so
    every gathered row starts 16-byte aligned."""
    if T2.dim() != 2 or T2.shape[1] != nv * nv:
        raise ValueError(f"amplitudes of shape {tuple(T2.shape)} do not "
                         f"fit a plan with nv={nv}")
    n = T2.shape[0]
    per16 = 16 // T2.element_size()
    Tt = torch.empty((nv * nv, n + -n % per16), dtype=T2.dtype,
                     device=T2.device)[:, :n]
    Tt.copy_(T2.t())
    return block_ladder_kernel_cd(pack, Tt, n_out, nv).t()


def block_ladder(plan, T2, twin=False):
    """R[ij, pq] = Σ_cd V[pq, cd] T[ij, cd] through ``plan`` (its
    ``inv_bra`` has one entry per output column): K1 for a CUDA tensor,
    the twin for a CPU tensor (or when ``twin=True``, which the on-card
    comparisons use)."""
    if kernels.check_device(T2) and not twin:
        return block_ladder_kernel(plan.packed, T2, plan.inv_bra.shape[0],
                                   plan.nv)
    return block_ladder_twin(plan.groups, plan.inv_bra, T2)


def block_ladder_cd(plan, Tt, twin=False):
    """R[pq, x] = Σ_cd V[pq, cd] Tt[cd, x] on a cd-major operand (nv², n),
    e.g. abij amplitudes of any batch flattened to (nv², batch·no²): K1 for
    a CUDA tensor, with no copy of an operand whose rows are contiguous,
    the twin for a CPU tensor or with ``twin=True``.  Returns (n_out, n),
    one row per entry of ``plan.inv_bra``."""
    if kernels.check_device(Tt) and not twin:
        if (Tt.dim() != 2 or Tt.stride(1) != 1
                or Tt.stride(0) < Tt.shape[1]):
            Tt = Tt.contiguous()
        return block_ladder_kernel_cd(plan.packed, Tt,
                                      plan.inv_bra.shape[0], plan.nv)
    return block_ladder_twin(plan.groups, plan.inv_bra, Tt.t()).t()
