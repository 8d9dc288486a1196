"""K10: the set-up scatter of a sparse integral list into named blocks, in
CUDA C++.

Replaces B8, the jitted multi-block scatter ``_scatter_all`` of
``pymes_tpu/models/ueg.py:688`` under ``sparse_to_blocks`` (``:639-682``),
the host masks in front of it (``:654-676``) and the flat scatter of
``sparse_to_dense`` (``:611-636``):

    block(p, q, r, s)[p - sp, q - sq, r - sr, s - ss] = vals[e]

for each entry ``e`` of ``idx`` (nnz, 4), where the block is the one whose
letters follow which of p, q, r, s are below ``no`` (occupied), and each
virtual index is shifted by ``no``.  The four comparisons make a 4-bit
class, one for each name of ``integral/partition.BLOCK_NAMES``; an entry
whose class was not asked for is dropped.  ``sparse_to_dense`` is the case
``no = 0`` with the one block ``abcd`` of dims (nP,)⁴.

The kernel (``pymes_tpu_torch/csrc/block_scatter.cu``, built with nvcc for
sm_90a at first use) sorts each entry into its block on the card, all
blocks in one launch, so the host makes no mask and no per-block copy.
The list goes up in one copy: the indices packed to int16 and the values
cast to float64 (as the twin casts them) into one pinned staging buffer,
which the card reads once.  The blocks are zeroed first, each a tensor of
its own.  Offsets are int64 (the dense (219,)⁴ holds 2.3·10⁹ elements).
The indices must be unique, as those of ``eval_2b_integrals`` are: the
kernel stores plainly, as the twin's ``index_put_`` without accumulate.
Kernel and twin give the same blocks bit for bit.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from pymes_tpu_torch import kernels
from pymes_tpu_torch.config import DTYPE
from pymes_tpu_torch.integral.partition import BLOCK_NAMES, OCC_LETTERS
from pymes_tpu_torch.kernels import _build

CLASSES = 16
MAX_INDEX = 2 ** 15    # the packed int16 indices


class Plan(NamedTuple):
    """The blocks of one scatter: ``slot[c]`` is the block of class ``c``
    (−1: dropped), and each block has its name, dims, index shifts
    (``no`` on a virtual slot) and size in elements."""
    slot: tuple
    names: tuple
    dims: tuple
    shifts: tuple
    sizes: tuple


def entry_class(occ):
    """The class of an entry whose four indices are occupied as the
    booleans ``occ`` say: p the highest bit."""
    return sum(int(o) << (3 - k) for k, o in enumerate(occ))


def strides(dims):
    """Row-major strides of a block of ``dims``."""
    return tuple(math.prod(dims[k + 1:]) for k in range(4))


def plan(n_p, no, names):
    """The slot table, dims, shifts and sizes of the blocks ``names``
    (distinct classes; a repeated name is taken once) of ``V[p,q,r,s]``
    with ``no`` occupied of ``n_p`` orbitals."""
    if not 0 <= no <= n_p:
        raise ValueError(f"no={no} outside [0, n_p={n_p}]")
    slot = [-1] * CLASSES
    out_names, dims, shifts = [], [], []
    for name in dict.fromkeys(names):
        if len(name) != 4:
            raise ValueError(f"block name {name!r} has not 4 letters")
        occ = [c in OCC_LETTERS for c in name]
        c = entry_class(occ)
        if slot[c] >= 0:
            raise ValueError(f"blocks {out_names[slot[c]]!r} and {name!r} "
                             "are the same class")
        slot[c] = len(out_names)
        out_names.append(name)
        dims.append(tuple(no if o else n_p - no for o in occ))
        shifts.append(tuple(0 if o else no for o in occ))
    return Plan(tuple(slot), tuple(out_names), tuple(dims), tuple(shifts),
                tuple(math.prod(d) for d in dims))


def block_scatter_twin(idx, vals, n_p, no, names, device):
    """Plain twin: host masks by block, then one flat ``index_put_`` a
    block on ``device``."""
    dev = torch.device(device)
    idx = np.asarray(idx, dtype=np.int64)
    vals = np.asarray(vals)
    is_occ = idx < no
    out = {}
    for name in names:
        want = [c in OCC_LETTERS for c in name]
        mask = np.ones(len(vals), dtype=bool)
        for slot, w in enumerate(want):
            mask &= (is_occ[:, slot] == w)
        sub = idx[mask]
        dims = [no if w else n_p - no for w in want]
        flat = np.zeros(len(sub), dtype=np.int64)
        for slot, w in enumerate(want):
            flat = flat * dims[slot] + (sub[:, slot] if w
                                        else sub[:, slot] - no)
        block = torch.zeros(int(np.prod(dims)), dtype=DTYPE, device=dev)
        block.index_put_((torch.as_tensor(flat, device=dev),),
                         torch.as_tensor(vals[mask], dtype=DTYPE, device=dev))
        out[name] = block.reshape(dims)
    return out


def upload(idx, vals, device):
    """The list on ``device`` as the kernel reads it, in one copy: the
    indices packed to int16 (nnz, 4) and the values cast to float64, both
    written by one host pass into one pinned staging buffer."""
    nnz = len(vals)
    stage = torch.empty(16 * nnz, dtype=torch.uint8, pin_memory=True)
    stage[:8 * nnz].view(torch.int16).view(nnz, 4).copy_(
        torch.as_tensor(idx))
    stage[8 * nnz:].view(DTYPE).copy_(torch.as_tensor(vals))
    buf = stage.to(device, non_blocking=True)
    return buf[:8 * nnz].view(torch.int16).view(nnz, 4), \
        buf[8 * nnz:].view(DTYPE)


def scatter(idx16, vals64, n_p, no, names, device):
    """The blocks from a list already on the card (:func:`upload`): zeroed,
    then K10 (no launch for an empty list).  Returns the dict name →
    block."""
    pl = plan(n_p, no, names)
    blocks = [torch.zeros(size, dtype=DTYPE, device=device)
              for size in pl.sizes]
    nnz = idx16.shape[0]
    if nnz:
        base = (ctypes.c_void_p * CLASSES)()
        stride = (ctypes.c_longlong * (4 * CLASSES))()
        shift = (ctypes.c_int * (4 * CLASSES))()
        for c, k in enumerate(pl.slot):
            if k < 0:
                continue
            base[c] = blocks[k].data_ptr()
            stride[4 * c:4 * c + 4] = strides(pl.dims[k])
            shift[4 * c:4 * c + 4] = pl.shifts[k]
        bad = torch.zeros(1, dtype=torch.int64, device=device)
        rc = _build.launch(device, _build.library().pymes_block_scatter,
                           idx16.data_ptr(), vals64.data_ptr(), nnz, n_p, no,
                           base, stride, shift, bad.data_ptr())
        if rc != 0:
            raise RuntimeError(f"block_scatter launch failed: cudaError {rc}")
        kernels.LAUNCHES["block_scatter"] += 1
        n_bad = int(bad.item())
        if n_bad:
            raise ValueError(f"{n_bad} entries have an index outside "
                             f"[0, {n_p})")
    return {name: b.reshape(dims)
            for name, b, dims in zip(pl.names, blocks, pl.dims)}


def block_scatter(idx, vals, n_p, no, names, device, twin=False):
    """The blocks ``names`` of the sparse list (``idx`` (nnz, 4) integer,
    ``vals`` (nnz,)) on ``device``: K10 on a CUDA device (one upload of the
    list, one launch), the twin on the CPU or with ``twin=True``.  Returns
    the dict name → float64 block."""
    dev = torch.device(device)
    names = BLOCK_NAMES if names is None else names
    if twin or dev.type == "cpu":
        return block_scatter_twin(idx, vals, n_p, no, names, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel or twin for device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    idx, vals = np.asarray(idx), np.asarray(vals)
    if idx.ndim != 2 or idx.shape[1] != 4 or vals.shape != idx.shape[:1]:
        raise ValueError(f"idx of shape {idx.shape} and vals of shape "
                         f"{vals.shape}: want (nnz, 4) and (nnz,)")
    if n_p > MAX_INDEX - 1:
        raise ValueError(f"n_p={n_p}: the packed indices hold at most "
                         f"{MAX_INDEX - 1}")
    return scatter(*upload(idx, vals, dev), n_p, no, names, dev)
