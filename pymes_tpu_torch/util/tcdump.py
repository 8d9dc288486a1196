"""TCDUMP (transcorrelated 3-body integral) reader and writer (host
numpy).

A copy of ``pymes_tpu/util/tcdump.py``: text dumps hold ``norb`` on the first line
then ``value o p q r s t`` records (1-based, physicists' <opq|rst>) storing
one representative of the 6-fold electron-permutation symmetry; values
carry the ``−1/3`` factor, so the in-memory tensor is ``−3×`` the file
values.  The dense tensor interleaves electron pairs: axes
(o, r, p, s, q, t).  :func:`write` keeps one canonical representative
per 6-fold orbit (the lexicographically smallest physicists' index), so a
written dump reads back to the same tensor.  Text records are parsed by
the port's native parser (:mod:`pymes_tpu_torch._native`), bit for bit as
the numpy parse that stays as its fallback.  h5py is optional and imported
only by the HDF5 reader.  ``tests/test_torch_ccsd_io.py`` and
``tests/test_torch_io.py`` hold the copy equal to the original.
"""

import itertools
from typing import NamedTuple

import numpy as np

from pymes_tpu_torch import _native
from pymes_tpu_torch.log import print_logging_info


class SparseL(NamedTuple):
    """6-index L tensor as its deduplicated nonzero list: ``idx`` (n, 6)
    int64 in the dense axis order (o, r, p, s, q, t), 0-based, all 6-fold
    images expanded; ``vals`` with the −3× convention."""

    idx: np.ndarray
    vals: np.ndarray
    nb: int


def _expand_6_fold(idx, vals):
    """All 6 electron-permutation images of physicists' records (n, 6)
    (o, p, q, r, s, t), deduplicated, in the dense axis order."""
    ket = [idx[:, 0], idx[:, 1], idx[:, 2]]
    bra = [idx[:, 3], idx[:, 4], idx[:, 5]]
    rows, val_list = [], []
    for per in itertools.permutations(range(3)):
        rows.append(np.stack([ket[per[0]], bra[per[0]],
                              ket[per[1]], bra[per[1]],
                              ket[per[2]], bra[per[2]]], axis=1))
        val_list.append(vals)
    rows = np.concatenate(rows, axis=0)
    allv = np.concatenate(val_list)
    uniq, first = np.unique(rows, axis=0, return_index=True)
    return uniq, allv[first]


def sparse_to_dense(sL):
    """Materialise the dense (nb,)*6 tensor of a :class:`SparseL`."""
    t_L = np.zeros([sL.nb] * 6)
    o, r, p, s, q, t = sL.idx.T
    t_L[o, r, p, s, q, t] = sL.vals
    return t_L


def _scatter_6_fold(t_L, idx, vals):
    """Scatter physicists' records into all 6 electron-permutation images
    of the dense tensor."""
    ket = [idx[:, 0], idx[:, 1], idx[:, 2]]
    bra = [idx[:, 3], idx[:, 4], idx[:, 5]]
    for per in itertools.permutations(range(3)):
        t_L[ket[per[0]], bra[per[0]],
            ket[per[1]], bra[per[1]],
            ket[per[2]], bra[per[2]]] = vals
    return t_L


def _read_txt(file_name):
    with open(file_name) as reader:
        nb = int(reader.readline().strip())
        body = reader.read()
    vals, idx = _native.parse(body, 6, _numpy_parse)
    return -3.0 * vals, idx - 1, nb


def _numpy_parse(body):
    rows = np.array(body.split(), dtype=object).reshape(-1, 7)
    return rows[:, 0].astype(np.float64), rows[:, 1:].astype(np.int64)


def _read_hdf5(file_name):
    import h5py

    with h5py.File(file_name, "r") as f:
        vals = -3.0 * np.asarray(f["tcdump"]["values"]).reshape(-1)
        idx = np.asarray(f["tcdump"]["indices"], dtype=np.int64) - 1
        nb = int(f["tcdump"].attrs["nOrbs"])
    return vals, idx, nb


def _read_records(file_name):
    if "h5" in file_name or "hdf5" in file_name:
        return _read_hdf5(file_name)
    return _read_txt(file_name)


def read_sparse(file_name="TCDUMP"):
    """Read a TCDUMP into a :class:`SparseL` nonzero list (no nb⁶ array)."""
    print_logging_info("Reading in TCDUMP (sparse)", level=1)
    vals, idx, nb = _read_records(file_name)
    rows, v = _expand_6_fold(idx, vals)
    return SparseL(idx=rows, vals=v, nb=nb)


def read(file_name="TCDUMP"):
    """Read a TCDUMP into the dense (nb,)*6 array ``L[o,r,p,s,q,t]``
    (−3× file values, 6-fold symmetry restored)."""
    print_logging_info("Reading in TCDUMP", level=1)
    vals, idx, nb = _read_records(file_name)
    return _scatter_6_fold(np.zeros([nb] * 6), idx, vals)


def unique_index(p, q):
    return int(min(p, q) + (max(p, q) - 1) * max(p, q) / 2)


def write(t_L_orpsqt, file_name="TCDUMP"):
    """Write one canonical representative per 6-fold permutation orbit of a
    dense 6-index L tensor (numpy; the inverse of :func:`read`, values
    stored as ``−L/3``): the lexicographically smallest (o,p,q,r,s,t)
    under the 6 joint pair permutations."""
    nb = t_L_orpsqt.shape[0]
    o, r, p, s, q, t = np.nonzero(np.abs(t_L_orpsqt) > 1e-10)
    vals = t_L_orpsqt[o, r, p, s, q, t]
    phys = np.stack([o, p, q, r, s, t], axis=1)   # physicists' (opq|rst)

    kets = phys[:, :3]
    bras = phys[:, 3:]
    best = None
    for per in itertools.permutations(range(3)):
        cand = np.concatenate([kets[:, per], bras[:, per]], axis=1)
        if best is None:
            best = cand
            continue
        smaller = np.zeros(len(cand), dtype=bool)
        decided = np.zeros(len(cand), dtype=bool)
        for col in range(6):
            lt = (cand[:, col] < best[:, col]) & ~decided
            gt = (cand[:, col] > best[:, col]) & ~decided
            smaller |= lt
            decided |= lt | gt
        best = np.where(smaller[:, None], cand, best)
    is_canon = np.all(phys == best, axis=1)

    with open(file_name, "w") as f:
        f.write(str(nb) + "\n")
        for n in np.nonzero(is_canon)[0]:
            on, pn, qn, rn, sn, tn = phys[n]
            f.write(str(-vals[n] / 3.0) + " " + str(on + 1) + " "
                    + str(pn + 1) + " " + str(qn + 1) + " " + str(rn + 1)
                    + " " + str(sn + 1) + " " + str(tn + 1) + "\n")
