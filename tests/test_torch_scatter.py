"""K10, the set-up scatter of the sparse UEG integrals into the named
blocks (``pymes_tpu_torch/kernels/block_scatter.py``), on the CPU.

* ``sparse_to_blocks`` / ``sparse_to_dense`` on ``"cpu"`` (the twin) give
  the JAX package's blocks bit for bit: every block name, the CCD blocks,
  ``abcd`` alone, a shuffled list, a transcorrelated non-hermitian list
  and float32 values (cast to float64, exactly).
* A numpy walk of :func:`block_scatter.plan` with the kernel's per-entry
  arithmetic (the int16-packed indices, class → slot → shifted int64
  offset, dropped classes) reproduces the twin, and gives the right int64
  offsets in blocks past 2³¹ elements (offsets only: nothing that large
  is allocated).
* The lists of ``eval_2b_integrals`` have unique flat indices, which the
  kernel's plain stores rely on.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
Exact comparisons throughout: a scatter of unique indices adds nothing.
"""

import numpy as np
import pytest
import torch

from pymes_tpu.models import ueg as jueg
from pymes_tpu_torch import kernels
from pymes_tpu_torch.integral.partition import BLOCK_NAMES, OCC_LETTERS
from pymes_tpu_torch.kernels import block_scatter as k10
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.util import roofline

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
        "ijak", "iajk")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small scatters: more threads only slow them down where several test
    processes share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _list(cutoff, kind="coulomb"):
    """(idx, vals, nP) of the port's list at ``cutoff``: the Coulomb
    integrals, or the transcorrelated non-hermitian class (gaskell)."""
    u = tueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    if kind == "tc":
        u.gamma = None
        u.k_cutoff = 1.0
        idx, vals = u.eval_2b_integrals(correlator=u.gaskell,
                                        is_only_non_hermi_2b=True, sp=2)
    else:
        idx, vals = u.eval_2b_integrals(sp=2)
    return idx, vals, u.n_spatial


CASES = {
    "all16-c2": (2, BLOCK_NAMES, None),
    "need-c2": (2, NEED, None),
    "abcd-c2": (2, ("abcd",), None),
    "all16-c5": (5, BLOCK_NAMES, None),
    "need-c5": (5, NEED, None),
    "abcd-c5": (5, ("abcd",), None),
    "shuffled-c5": (5, BLOCK_NAMES, "shuffle"),
    "tc-nonhermitian-c2": (2, BLOCK_NAMES, "tc"),
    "f32-values-c2": (2, NEED, "f32"),
    "dense-c2": (2, None, None),
    "dense-c5": (5, None, None),
    "dense-shuffled-c2": (2, None, "shuffle"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scatter_matches_jax(case):
    cutoff, names, how = CASES[case]
    idx, vals, n_p = _list(cutoff, "tc" if how == "tc" else "coulomb")
    if how == "shuffle":
        perm = np.random.default_rng(cutoff).permutation(len(vals))
        idx, vals = idx[perm], vals[perm]
    elif how == "f32":
        vals = vals.astype(np.float32)
    before = dict(kernels.LAUNCHES)
    if names is None:
        got = tueg.sparse_to_dense(idx, vals, n_p, device="cpu")
        assert got.dtype == torch.float64 and got.shape == (n_p,) * 4
        want = np.asarray(jueg.sparse_to_dense(idx, vals, n_p))
        assert np.array_equal(want, got.numpy())
    else:
        got = tueg.sparse_to_blocks(idx, vals, n_p, NO, device="cpu",
                                    names=names)
        want = jueg.sparse_to_blocks(idx, vals, n_p, NO, names=names)
        assert tuple(got) == tuple(names)
        for name in names:
            assert got[name].dtype == torch.float64
            assert np.array_equal(np.asarray(want[name]),
                                  got[name].numpy()), name
    # the CPU runs the twin: no kernel launched
    assert kernels.LAUNCHES == before


def _walk(idx, vals, pl, n_p, no):
    """The kernel's arithmetic over a list, entry by entry in numpy: the
    indices packed to int16 as the upload packs them, the range check,
    the 4-bit class (p the highest bit), its slot, the int64 offset of
    the shifted indices in the slot's row-major strides, one store."""
    q = np.asarray(idx).astype(np.int16).astype(np.int64)
    assert np.all((q >= 0) & (q < n_p))
    cls = (q < no).astype(np.int64) @ np.array([8, 4, 2, 1])
    slot = np.asarray(pl.slot)[cls]
    blocks = [np.zeros(size) for size in pl.sizes]
    for k in range(len(pl.names)):
        sel = slot == k
        off = ((q[sel] - np.asarray(pl.shifts[k]))
               * np.asarray(k10.strides(pl.dims[k]), dtype=np.int64)
               ).sum(axis=1)
        blocks[k][off] = np.asarray(vals, dtype=np.float64)[sel]
    return {name: b.reshape(dims)
            for name, b, dims in zip(pl.names, blocks, pl.dims)}


@pytest.mark.parametrize("names", [NEED, BLOCK_NAMES, None],
                         ids=["need", "all16", "dense"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_plan_walk_reproduces_twin(cutoff, names):
    idx, vals, n_p = _list(cutoff)
    no = 0 if names is None else NO
    names = ("abcd",) if names is None else names
    pl = k10.plan(n_p, no, names)
    assert pl.names == tuple(names)
    walked = _walk(idx, vals, pl, n_p, no)
    twin = k10.block_scatter(idx, vals, n_p, no, names, "cpu")
    for name in names:
        assert np.array_equal(walked[name], twin[name].numpy()), name
    # the entries that no slot takes are those of the classes not asked
    # for: the blocks hold every other entry
    kept = sum(int(np.count_nonzero(b)) for b in walked.values())
    cls = (idx < no).astype(np.int64) @ np.array([8, 4, 2, 1])
    asked = [c for c, k in enumerate(pl.slot) if k >= 0]
    assert kept == int(np.count_nonzero(vals[np.isin(cls, asked)]))


@pytest.mark.parametrize("n_p,no,name", [(223, 7, "abcd"), (219, 0, "abcd"),
                                         (230, 7, "abcd")])
def test_walk_int64_offsets_past_2_31(n_p, no, name):
    """Offsets in a block of more than 2³¹ elements (``abcd`` at nP=223,
    nv = 216; the dense (219,)⁴; nP=230): the walk's int64 offsets equal
    Python's integer row-major offsets at the corners and at seeded
    entries, the last one past 2³¹.  Offsets only, no block."""
    pl = k10.plan(n_p, no, (name,))
    (dims,), (size,) = pl.dims, pl.sizes
    assert size == int(np.prod(dims, dtype=np.int64)) and size > 2 ** 31
    rng = np.random.default_rng(n_p)
    lo, hi = no, n_p
    idx = np.concatenate([[[lo] * 4, [hi - 1] * 4, [hi - 1, lo, lo, lo]],
                          rng.integers(lo, hi, size=(200, 4))])
    q = idx.astype(np.int16).astype(np.int64)
    cls = (q < no).astype(np.int64) @ np.array([8, 4, 2, 1])
    assert np.all(np.asarray(pl.slot)[cls] == 0)
    off = ((q - np.asarray(pl.shifts[0]))
           * np.asarray(k10.strides(dims), dtype=np.int64)).sum(axis=1)
    assert off.dtype == np.int64
    want = [((((a - no) * dims[1] + (b - no)) * dims[2] + (c - no))
             * dims[3] + (d - no)) for a, b, c, d in idx.tolist()]
    assert off.tolist() == want
    assert off[1] == size - 1 and off.max() >= 2 ** 31 and off.min() == 0


@pytest.mark.parametrize("kind", ["coulomb", "tc"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_eval_2b_lists_have_unique_flat_indices(cutoff, kind):
    """The kernel stores plainly (no accumulate): each (p, q, r, s) of a
    list must come once."""
    idx, vals, n_p = _list(cutoff, kind)
    assert idx.shape == (len(vals), 4) and len(vals) > 0
    flat = ((idx[:, 0] * n_p + idx[:, 1]) * n_p + idx[:, 2]) * n_p + idx[:, 3]
    assert np.unique(flat).size == len(flat)


def test_plan_slot_table():
    """Every block name has a class of its own (all 16 covered), a
    repeated name is taken once, two names of one class raise, and a
    block's dims and shifts follow its letters."""
    n_p = 19
    pl = k10.plan(n_p, NO, BLOCK_NAMES)
    assert sorted(pl.slot) == list(range(16))
    for k, name in enumerate(BLOCK_NAMES):
        occ = [c in OCC_LETTERS for c in name]
        assert pl.slot[k10.entry_class(occ)] == k
        assert pl.dims[k] == tuple(NO if o else n_p - NO for o in occ)
        assert pl.shifts[k] == tuple(0 if o else NO for o in occ)
        assert pl.sizes[k] == int(np.prod(pl.dims[k]))
    pl = k10.plan(n_p, NO, ("ijab", "abcd", "ijab"))
    assert pl.names == ("ijab", "abcd")
    assert sum(k >= 0 for k in pl.slot) == 2
    with pytest.raises(ValueError, match="same class"):
        k10.plan(n_p, NO, ("ijab", "klcd"))
    with pytest.raises(ValueError):
        k10.plan(n_p, n_p + 1, ("abcd",))


def test_block_scatter_cpu_twin_and_devices():
    """On the CPU the wrapper runs its twin (``twin=True`` the same), an
    empty list gives zeroed blocks, and a device with neither kernel nor
    twin raises."""
    idx, vals, n_p = _list(2)
    a = k10.block_scatter(idx, vals, n_p, NO, NEED, "cpu")
    b = k10.block_scatter(idx, vals, n_p, NO, NEED, "cpu", twin=True)
    assert all(torch.equal(a[k], b[k]) for k in NEED)
    empty = k10.block_scatter(idx[:0], vals[:0], n_p, NO, NEED, "cpu")
    assert all(not bool(empty[k].any()) and empty[k].shape == a[k].shape
               for k in NEED)
    with pytest.raises(RuntimeError, match="no kernel or twin"):
        k10.block_scatter(idx, vals, n_p, NO, NEED, "meta")


def test_scatter_bound_counts_the_list_and_the_blocks():
    """K10's bound: 8 bytes an entry of the packed list, 8 a kept value,
    8 a block element, at the HBM rate; no operations."""
    ms, by = roofline.scatter_bound(3_399_619, 43_718, (2401, 2_202_256))
    want = (8 * 3_399_619 + 8 * 43_718 + 8 * (2401 + 2_202_256)) \
        / roofline.HBM_BYTES_S * 1e3
    assert by == "bytes" and ms == pytest.approx(want, rel=1e-15)
