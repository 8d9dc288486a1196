"""Contractions of the transcorrelated 3-body tensor L (host numpy).

A copy of ``pymes_tpu/integral/contraction.py``: the effective 2-body
integrals (single contraction), the 1-body corrections (double) and the
scalar energy shift (triple) from the 6-index L tensor in the
pair-interleaved layout (o, r, p, s, q, t) of
:mod:`pymes_tpu_torch.util.tcdump`, dense or as a
:class:`~pymes_tpu_torch.util.tcdump.SparseL` nonzero list.  The results
are numpy arrays; the solver moves them onto its device.
``tests/test_torch_ccsd_io.py`` holds the copy equal to the original.
"""

import numpy as np

from pymes_tpu_torch.log import print_logging_info
from pymes_tpu_torch.util.tcdump import SparseL


def _sparse_single(no, sL):
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    D = np.zeros((sL.nb,) * 4, dtype=v.dtype)
    # exchange and its electron-swapped partner, factor −3 each
    m = (a3 == a4) & (a3 < no)
    np.add.at(D, (a0[m], a2[m], a1[m], a5[m]), -3.0 * v[m])
    np.add.at(D, (a2[m], a0[m], a5[m], a1[m]), -3.0 * v[m])
    # direct (RPA), +6
    m = (a4 == a5) & (a4 < no)
    np.add.at(D, (a0[m], a2[m], a1[m], a3[m]), 6.0 * v[m])
    return -D / 3.0


def _sparse_double(no, sL):
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    S = np.zeros((sL.nb,) * 2, dtype=v.dtype)
    m = (a0 == a1) & (a0 < no) & (a2 == a3) & (a2 < no)  # iijjpq
    np.add.at(S, (a4[m], a5[m]), 12.0 * v[m])
    m = (a0 == a1) & (a0 < no) & (a3 == a4) & (a3 < no)  # iipjjq
    np.add.at(S, (a2[m], a5[m]), -12.0 * v[m])
    m = (a1 == a4) & (a1 < no) & (a2 == a5) & (a2 < no)  # pijqij
    np.add.at(S, (a0[m], a3[m]), 6.0 * v[m])
    m = (a0 == a3) & (a0 < no) & (a1 == a2) & (a1 < no)  # ijjipq
    np.add.at(S, (a4[m], a5[m]), -6.0 * v[m])
    return -S / 6.0


def _sparse_triple(no, sL):
    a0, a1, a2, a3, a4, a5 = sL.idx.T
    v = sL.vals
    occ = (sL.idx < no).all(axis=1)
    t = 8.0 * v[occ & (a0 == a1) & (a2 == a3) & (a4 == a5)].sum()  # iijjkk
    t += -12.0 * v[occ & (a0 == a3) & (a1 == a2) & (a4 == a5)].sum()  # ijjikk
    t += 4.0 * v[occ & (a1 == a2) & (a3 == a4) & (a5 == a0)].sum()  # ijjkki
    return -t / 6.0


def get_single_contraction(no, t_L_orpsqt):
    """Effective 2-body integrals D_pqrs from one occupied contraction,
    symmetrised over the two electrons, with the overall −1/3."""
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_single(no, t_L_orpsqt)
    nb = t_L_orpsqt.shape[0]
    t_D_pqrs = np.zeros([nb, nb, nb, nb], dtype=t_L_orpsqt.dtype)
    # exchange-type: sign −1, 3·2 equivalent diagrams
    t_D_pqrs += -3.0 * 2.0 * np.einsum(
        "pqriis->prqs", t_L_orpsqt[:, :, :, :no, :no, :])
    t_D_pqrs += -3.0 * 2.0 * np.einsum(
        "rspiiq->prqs", t_L_orpsqt[:, :, :, :no, :no, :])
    t_D_pqrs /= 2.0
    # direct (RPA)-type: one loop, 3 diagrams, spin 2
    t_D_pqrs += 2.0 * 3.0 * np.einsum(
        "pqrsii->prqs", t_L_orpsqt[:, :, :, :, :no, :no])
    return -t_D_pqrs / 3.0


def get_double_contraction(no, t_L_orpsqt):
    """1-body corrections S_pq from two occupied contractions."""
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_double(no, t_L_orpsqt)
    t_S_pq = 2.0 ** 2 * 3.0 * np.einsum(
        "iijjpq->pq", t_L_orpsqt[:no, :no, :no, :no, :, :])
    t_S_pq += -(2.0 ** 1) * 3.0 * 2.0 * np.einsum(
        "iipjjq->pq", t_L_orpsqt[:no, :no, :, :no, :no, :])
    t_S_pq += 3.0 * 2.0 * np.einsum(
        "pijqij->pq", t_L_orpsqt[:, :no, :no, :, :no, :no])
    t_S_pq += -1.0 * 3.0 * 2.0 * np.einsum(
        "ijjipq->pq", t_L_orpsqt[:no, :no, :no, :no, :, :])
    return -t_S_pq / 6.0


def get_triple_contraction(no, t_L_orpsqt):
    """Scalar energy shift T_0 from three occupied contractions."""
    print_logging_info("Triple contraction")
    if isinstance(t_L_orpsqt, SparseL):
        return _sparse_triple(no, t_L_orpsqt)
    L_occ = t_L_orpsqt[:no, :no, :no, :no, :no, :no]
    t_T_0 = 2.0 ** 3 * np.einsum("iijjkk->", L_occ)
    t_T_0 += -(2 ** 2) * 3.0 * np.einsum("ijjikk->", L_occ)
    t_T_0 += 2.0 * 2.0 * np.einsum("ijjkki->", L_occ)
    return -t_T_0 / 6.0
