"""K4: the ovvv T1 gather of the matrix-free CCSD dressing, in CUDA C++.

Replaces B4, ``pymes_tpu/ops/ueg_ladder.py:150`` ``ovvv_t1_apply_j``:

    out[c, p, q, r] = W[p, r] · T1[S[p, q, r], c]    (0 where S < 0)

the contraction ``Σ_s V[p,q,r,s] T1[s,c]`` of a momentum-structured block
whose last axis is virtual: momentum conservation fixes s from (p, q, r), so
the nv³·no-sized ovvv blocks never exist.  The columns c run over
batch × no: ``T1`` is the (nv, no) T1 of the CCSD dressing or the
(k, nv, no) trial batch of the EOM, FEAST and RT sigmas, read in place
through its strides (no transpose copy).  The gather takes float64, or
float32 for the f32 sigma of the FEAST/RT mixed-precision engine (an f32
instantiation of the same kernel, on a plan whose weights W are cast).
:func:`ovvv_gather_diag` fuses the G_vv trace of the dressing
(``einsum("jajb->ab")`` / ``einsum("jjab->ab")`` of a full gather) and
writes nv² values; it takes float64, or float32 for the dressing of the
f32 bulk of the mixed-precision CCSD (its own f32 instantiation, launches
counted under ``ovvv_gather_diag_f32``).

The kernel (``pymes_tpu_torch/csrc/ovvv_gather.cu``, built with nvcc for
sm_90a at first use) is bound by its output write; its source says how the
design answers.  :func:`plan` chooses its grid (tiles of the flat (p, q, r)
index × tiles of columns) from the width, :func:`plan_f32` the f32
kernel's; they are plain Python so that the CPU tests reach them.  The
gather is one multiply an element, as the twin's, so kernel and twin agree
bit for bit.
"""

import functools

import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.kernels import _build

THREADS = 256
EPT = 2                     # (p, q, r) entries a thread
NARROW_TILE = 4             # columns of a tile when the columns fill the card
WIDE_TILE = 16              # columns of a tile when the entries fill it
FILL_BLOCKS_PER_SM = 3      # the card: at least this many blocks an SM
MAX_GRID_Y = 65535
# the f32 kernel: entries a thread and a block, its widest column tile
F32_EPT = 4
F32_ENT = THREADS * F32_EPT
F32_WIDE_TILE = 8


def _even(ncol, ct):
    """The widest tile ≤ ``ct`` that cuts ``ncol`` columns evenly."""
    return -(-ncol // -(-ncol // ct))


@functools.lru_cache(maxsize=64)
def plan(n, ncol, sms):
    """The column tile ``ct`` of one launch on ``sms`` SMs.  Where the
    entry tiles alone give every SM ``FILL_BLOCKS_PER_SM`` blocks (the
    dressing and the EOM batch at nP=219), one tile takes up to
    ``WIDE_TILE`` columns, so that S and W are read and the indices
    computed once for all of them; else (the FEAST and RT lane batches)
    the columns are cut into tiles of ``NARROW_TILE``, narrower still
    where even those do not fill the card.  Both were the fastest tiles
    measured on the H100 at those widths."""
    tiles_n = -(-n // (THREADS * EPT))
    fill = FILL_BLOCKS_PER_SM * sms
    if tiles_n >= fill:
        ct = _even(ncol, WIDE_TILE)
    else:
        for ct in range(min(ncol, NARROW_TILE), 0, -1):
            ct = _even(ncol, ct)
            if tiles_n * -(-ncol // ct) >= fill:
                break
    if -(-ncol // ct) > MAX_GRID_Y:
        raise ValueError(f"{ncol} columns: too many column tiles")
    return ct


@functools.lru_cache(maxsize=64)
def plan_f32(n, ncol, sms):
    """The column tile of one f32 launch on ``sms`` SMs: the widest up to
    ``F32_WIDE_TILE`` whose column tiles, with the ⌈n / F32_ENT⌉ entry
    tiles, give every SM ``FILL_BLOCKS_PER_SM`` blocks (else 1), cut
    evenly.  Its tiles at the main widths (4 at 7 columns, 7 at 14, 8 at
    448 and 896) ran within 1 % of the fastest of 4-32 measured on an
    H100 (PERF.md §6)."""
    tiles_n = -(-n // F32_ENT)
    fill = FILL_BLOCKS_PER_SM * sms
    ct = min(F32_WIDE_TILE, ncol)
    while ct > 1 and tiles_n * -(-ncol // ct) < fill:
        ct -= 1
    ct = _even(ncol, ct)
    if -(-ncol // ct) > MAX_GRID_Y:
        raise ValueError(f"{ncol} columns: too many column tiles")
    return ct


def tiles(n, ncol, ct):
    """The ((i_begin, i_end), (c_begin, c_end)) ranges of every block as
    the kernel cuts them: block (x, y) takes entries [x·THREADS·EPT, …) and
    columns [y·ct, …), the last of each short."""
    te = THREADS * EPT
    return [((x * te, min(n, (x + 1) * te)), (y * ct, min(ncol, (y + 1) * ct)))
            for y in range(-(-ncol // ct)) for x in range(-(-n // te))]


def ovvv_gather_twin(S, W, T1):
    """Plain twin (the JAX algorithm): a gather of T1's columns, a mask and
    a multiply.  ``T1`` (nv, no) or (k, nv, no); returns (k·no,) +
    S.shape (k = 1 for a 2-D T1)."""
    Tb = T1 if T1.dim() == 3 else T1[None]
    k, nv, no = Tb.shape
    flat = S.clamp(0, nv - 1).reshape(-1).long()
    cols = Tb.transpose(1, 2).reshape(k * no, nv)
    Tg = cols.index_select(1, flat).reshape((k * no,) + tuple(S.shape))
    Tg = torch.where((S >= 0)[None], Tg, torch.zeros((), dtype=Tg.dtype,
                                                     device=Tg.device))
    return Tg * W[None, :, None, :]


def _refuse(S, W, T1):
    """The type, device and shape refusals the kernels share; returns the
    type suffix of T1 and W."""
    sfx = kernels.type_suffix("the ovvv gather", T1, W)
    if S.dtype != torch.int32 or not S.is_contiguous():
        raise TypeError("the ovvv gather takes a contiguous int32 index S")
    if not S.device == W.device == T1.device:
        raise ValueError("plan and T1 lie on different devices")
    if S.dim() != 3 or W.shape != (S.shape[0], S.shape[2]):
        raise ValueError("plan and T1 shapes do not fit the kernel")
    if S.numel() >= 2 ** 31:
        raise ValueError("plan too large for the kernel")
    return sfx


def ovvv_gather(S, W, T1, twin=False):
    """``out[c,p,q,r] = W[p,r] · T1[S[p,q,r], c]`` (0 where S < 0): K4 on a
    CUDA tensor, the twin on a CPU tensor or with ``twin=True``.  ``S``
    (n0, n1, n2) int32, ``W`` (n0, n2), ``T1`` (nv, no) or a batch (k, nv,
    no) of any strides, W and T1 both f64 or both f32; columns c = b·no +
    j.  Returns (k·no, n0, n1, n2)."""
    if twin or not kernels.check_device(T1):
        return ovvv_gather_twin(S, W, T1)
    sfx = _refuse(S, W, T1)
    if T1.dim() == 3:
        k, nv, no = T1.shape
        sb, ss, sj = T1.stride()
    elif T1.dim() == 2:
        (nv, no), k, sb = T1.shape, 1, 0
        ss, sj = T1.stride()
    else:
        raise ValueError(f"T1 of shape {tuple(T1.shape)}: want (nv, no) or "
                         "(k, nv, no)")
    n0, n1, n2 = S.shape
    n, ncol = S.numel(), k * no
    out = torch.empty((ncol, n0, n1, n2), dtype=T1.dtype, device=T1.device)
    if n == 0 or ncol == 0:
        return out
    dev, Wc = T1.device, W.contiguous()
    ct = (plan_f32 if sfx else plan)(n, ncol, _build.sm_count(dev))
    rc = _build.launch(dev, getattr(_build.library(),
                                    "pymes_ovvv_gather" + sfx),
                       S.data_ptr(), Wc.data_ptr(), T1.data_ptr(),
                       sb, ss, sj, no, ncol, out.data_ptr(), n, n1 * n2, n2,
                       ct)
    if rc != 0:
        raise RuntimeError(f"ovvv_gather launch failed: cudaError {rc}")
    kernels.LAUNCHES["ovvv_gather" + sfx] += 1
    return out


_DIAG_SPEC = {1: "jajb->ab", 0: "jjab->ab"}


def ovvv_gather_diag_twin(S, W, T1, axis):
    """Plain twin: the full gather, then its (j′ = j) trace over S's axis
    ``axis`` (1: ``jajb->ab``, the vov plan; 0: ``jjab->ab``, ovv)."""
    return torch.einsum(_DIAG_SPEC[axis], ovvv_gather_twin(S, W, T1))


def ovvv_gather_diag(S, W, T1, axis, twin=False):
    """``d[a, r] = Σ_j W · T1[S, j]`` over the plan's occupied axis ``axis``
    of S (1: ``d[p,r] = Σ_j W[p,r] T1[S[p,j,r], j]``; 0: ``d[q,r] = Σ_j
    W[j,r] T1[S[j,q,r], j]``): K4's diagonal entry on a CUDA tensor, the
    twin on a CPU tensor or with ``twin=True``.  ``T1`` (nv, no); W and T1
    both f64 or both f32."""
    if axis not in _DIAG_SPEC:
        raise ValueError(f"axis {axis}: the trace runs over S's axis 0 or 1")
    if twin or not kernels.check_device(T1):
        return ovvv_gather_diag_twin(S, W, T1, axis)
    sfx = _refuse(S, W, T1)
    if T1.dim() != 2 or S.shape[axis] != T1.shape[1]:
        raise ValueError(f"S {tuple(S.shape)} axis {axis} does not run over "
                         f"the {T1.shape[-1]} columns of T1 (nv, no)")
    n0, n1, n2 = S.shape
    out = torch.empty((n1 if axis == 0 else n0, n2), dtype=T1.dtype,
                      device=T1.device)
    if out.numel() == 0:
        return out
    Wc = W.contiguous()
    rc = _build.launch(T1.device, getattr(_build.library(),
                                          "pymes_ovvv_gather_diag" + sfx),
                       S.data_ptr(), Wc.data_ptr(), T1.data_ptr(),
                       T1.stride(0), T1.stride(1), out.data_ptr(), n0, n1,
                       n2, T1.shape[1], axis)
    if rc != 0:
        raise RuntimeError(f"ovvv_gather_diag launch failed: cudaError {rc}")
    kernels.LAUNCHES["ovvv_gather_diag" + sfx] += 1
    return out
