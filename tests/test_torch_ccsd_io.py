"""The port's host copies on the CCSD path against the JAX package's
originals: the FCIDUMP reader (plain and transcorrelated), the TCDUMP
readers (dense and the sparse nonzero list) and the three contractions of
the 3-body tensor, on the files in ``tests/data/``; the block partition;
and the OVVV gather plans of the matrix-free UEG.

Identity checks are exact (``array_equal``): the copies run the same numpy
arithmetic in the same order, so any difference is a drift of one copy.
"""

import os

import numpy as np
import pytest

from pymes_tpu.integral import contraction as jcontraction
from pymes_tpu.integral import partition as jpartition
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu.util import tcdump as jtcdump
from pymes_tpu_torch import interop
from pymes_tpu_torch.integral import contraction as tcontraction
from pymes_tpu_torch.integral import partition as tpartition
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder
from pymes_tpu_torch.util import fcidump as tfcidump
from pymes_tpu_torch.util import tcdump as ttcdump

DATA = os.path.join(os.path.dirname(__file__), "data")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name,is_tc", [
    ("FCIDUMP.LiH.321g", False), ("FCIDUMP.H2.sto6g", False),
    ("FCIDUMP.LiH.tc", True), ("FCIDUMP.H2.tc", True)])
def test_fcidump_read_matches_jax(name, is_tc):
    got = tfcidump.read(os.path.join(DATA, name), is_tc=is_tc)
    want = jfcidump.read(os.path.join(DATA, name), is_tc=is_tc)
    assert got[:3] == want[:3]
    for g, w in zip(got[3:], want[3:]):
        _same(g, w)


@pytest.mark.parametrize("name", ["TCDUMP.LiH_FNO", "TCDUMP.H2.tc"])
def test_tcdump_read_matches_jax(name):
    _same(ttcdump.read(os.path.join(DATA, name)),
          jtcdump.read(os.path.join(DATA, name)))
    got = ttcdump.read_sparse(os.path.join(DATA, name))
    want = jtcdump.read_sparse(os.path.join(DATA, name))
    assert got.nb == want.nb
    _same(got.idx, want.idx)
    _same(got.vals, want.vals)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("name,no", [("TCDUMP.LiH_FNO", 2),
                                     ("TCDUMP.H2.tc", 1)])
def test_contractions_match_jax(name, no, sparse):
    path = os.path.join(DATA, name)
    L_t = ttcdump.read_sparse(path) if sparse else ttcdump.read(path)
    L_j = jtcdump.read_sparse(path) if sparse else jtcdump.read(path)
    _same(tcontraction.get_single_contraction(no, L_t),
          jcontraction.get_single_contraction(no, L_j))
    _same(tcontraction.get_double_contraction(no, L_t),
          jcontraction.get_double_contraction(no, L_j))
    assert (tcontraction.get_triple_contraction(no, L_t)
            == jcontraction.get_triple_contraction(no, L_j))


def test_part_2_body_int_matches_jax():
    V = np.random.default_rng(0).standard_normal((6,) * 4)
    got = tpartition.part_2_body_int(2, V)
    want = jpartition.part_2_body_int(2, V)
    assert got.keys() == want.keys()
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("cutoff", [2, 5])
def test_ovvv_plans_match_jax(cutoff):
    uj, ut = jueg.UEG(14, 7, 7, 0.5), tueg.UEG(14, 7, 7, 0.5)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    got = tladder.build_ovvv_plans(ut, "cpu")
    want = jladder.build_ovvv_plans(uj)
    assert got.keys() == want.keys() == {"vvo", "ovv", "vov"}
    carried = interop.ovvv_plans_from_numpy(want, "cpu")
    for pat in want:
        _same(got[pat].S.numpy(), np.asarray(want[pat].S))
        _same(got[pat].W.numpy(), np.asarray(want[pat].W))
        _same(carried[pat].S.numpy(), got[pat].S.numpy())
        _same(carried[pat].W.numpy(), got[pat].W.numpy())
