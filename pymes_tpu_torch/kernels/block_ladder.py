"""K1 wrapper: the momentum-sector ladder GEMM and its plain twin.

Replaces B1, ``pymes_tpu/ops/ueg_ladder.py:450`` ``block_ladder_apply_ij``
(TPU form ``block_ladder_apply_ij_ozaki``, :533).  The kernel is CUDA C++
(``pymes_tpu_torch/csrc/block_ladder.cu``, built with nvcc for sm_90a at
first use); its source says what bounds it and how the design answers.

:class:`LadderPack` is the kernel's view of a plan: every group's blocks,
``perm_ket`` and ``bra_of_row`` in three flat device buffers (the plan's
per-group tensors are views into them), a per-group table of offsets and
padded sizes, and the work list of (group, sector, row tile) entries.
"""

from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

# rows of a sector handled by one CUDA block; must equal TM in
# csrc/block_ladder.cu (checked against the library at first launch)
ROW_TILE = 16


class LadderPack(NamedTuple):
    blocks: torch.Tensor      # f64, all groups' (nS, mB, mK) blocks
    perm: torch.Tensor        # int32, all groups' (nS, mK) ket-pair ids
    bra_of_row: torch.Tensor  # int32, all groups' (nS, mB) bra ids (−1 pad)
    gtab: torch.Tensor        # int64 (G, 5): offsets of the three, mB, mK
    work: torch.Tensor        # int32 (n_work, 3): group, sector, row0


def pack_groups(group_arrays, device):
    """Pack host arrays ``[(blocks, perm_ket, bra_of_row), ...]`` (in the
    plan's concat order) into one :class:`LadderPack` on ``device``.
    Returns ``(pack, [(blocks, perm_ket, bra_of_row) views per group])``."""
    blk = [np.asarray(b, dtype=np.float64).ravel() for b, _, _ in group_arrays]
    prm = [np.asarray(p, dtype=np.int32).ravel() for _, p, _ in group_arrays]
    bra = [np.asarray(r, dtype=np.int32).ravel() for _, _, r in group_arrays]
    gtab, work = [], []
    offs = np.zeros(3, np.int64)
    for g, (b, p, r) in enumerate(group_arrays):
        nS, mB, mK = np.shape(b)
        gtab.append([offs[0], offs[1], offs[2], mB, mK])
        offs += (nS * mB * mK, nS * mK, nS * mB)
        work.extend((g, s, r0) for s in range(nS)
                    for r0 in range(0, mB, ROW_TILE))
    # largest buckets first, so their long K loops start early
    work.sort(key=lambda w: -(gtab[w[0]][3] * gtab[w[0]][4]))

    def dev(arrs, dt):
        flat = np.concatenate(arrs) if arrs else np.zeros(0)
        return torch.as_tensor(flat, dtype=dt, device=device)

    pack = LadderPack(
        blocks=dev(blk, torch.float64), perm=dev(prm, torch.int32),
        bra_of_row=dev(bra, torch.int32),
        gtab=torch.as_tensor(np.asarray(gtab, np.int64).reshape(-1, 5),
                             device=device),
        work=torch.as_tensor(np.asarray(work, np.int32).reshape(-1, 3),
                             device=device))
    views = []
    for (b, _, _), (o_b, o_p, o_r, mB, mK) in zip(group_arrays, gtab):
        nS = np.shape(b)[0]
        views.append((pack.blocks[o_b:o_b + nS * mB * mK].view(nS, mB, mK),
                      pack.perm[o_p:o_p + nS * mK].view(nS, mK),
                      pack.bra_of_row[o_r:o_r + nS * mB].view(nS, mB)))
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


_ROW_TILE_CHECKED = False


def block_ladder_kernel_cd(pack: LadderPack, Tt, n_out, nv):
    """Launch K1 on a cd-major operand ``Tt`` (nv², n), a contiguous CUDA
    f64 tensor; returns the bra-major output (n_out, n): row r holds the
    pack's rows whose ``bra_of_row`` is r (n_bra² rows for a whole plan,
    the shard's own rows for a shard of a sector-sharded plan)."""
    global _ROW_TILE_CHECKED
    if Tt.dtype != torch.float64 or pack.blocks.dtype != torch.float64:
        raise TypeError("the ladder kernel takes float64 amplitudes/blocks")
    if pack.blocks.device != Tt.device:
        raise ValueError("plan and amplitudes lie on different devices")
    if Tt.dim() != 2 or Tt.shape[0] != nv * nv or not Tt.is_contiguous():
        raise ValueError(f"operand of shape {tuple(Tt.shape)} is not a "
                         f"contiguous cd-major (nv², n) with nv={nv}")
    lib = _build.library()
    if not _ROW_TILE_CHECKED:
        if lib.pymes_block_ladder_row_tile() != ROW_TILE:
            raise RuntimeError("ROW_TILE differs from TM in "
                               "csrc/block_ladder.cu")
        _ROW_TILE_CHECKED = True
    n = Tt.shape[1]
    outT = torch.zeros((n_out, n), dtype=Tt.dtype, device=Tt.device)
    with torch.cuda.device(Tt.device):
        rc = lib.pymes_block_ladder(
            Tt.data_ptr(), pack.blocks.data_ptr(), pack.perm.data_ptr(),
            pack.bra_of_row.data_ptr(), pack.gtab.data_ptr(),
            pack.work.data_ptr(), int(pack.work.shape[0]), outT.data_ptr(),
            int(n), torch.cuda.current_stream(Tt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_ladder launch failed: cudaError {rc}")
    kernels.LAUNCHES["block_ladder"] += 1
    return outT


def block_ladder_kernel(pack: LadderPack, T2, n_out, nv):
    """Launch K1 on ``T2`` (no², nv²), a CUDA f64 tensor; returns the
    (no², n_out) result as the transposed view of the bra-major output."""
    if T2.dim() != 2 or T2.shape[1] != nv * nv:
        raise ValueError(f"amplitudes of shape {tuple(T2.shape)} do not "
                         f"fit a plan with nv={nv}")
    return block_ladder_kernel_cd(pack, T2.t().contiguous(), n_out, nv).t()


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
    a CUDA tensor, with no transpose of the operand, the twin for a CPU
    tensor or with ``twin=True``.  Returns (n_out, n), one row per entry
    of ``plan.inv_bra``."""
    if kernels.check_device(Tt) and not twin:
        return block_ladder_kernel_cd(plan.packed, Tt.contiguous(),
                                      plan.inv_bra.shape[0], plan.nv)
    return block_ladder_twin(plan.groups, plan.inv_bra, Tt.t()).t()
