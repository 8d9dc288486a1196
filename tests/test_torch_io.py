"""The port's host I/O and peripheral copies against the JAX package's
originals: the FCIDUMP writers and block reader, the HDF5 round trips, the
TCDUMP writer and ``sparse_to_dense``, the 3-body symmetry helpers, the
CC4S text tensors, the ``tcfactors`` reader and the POSCAR structure and
optimizer.

Tolerances: written files byte for byte, arrays exactly (``array_equal``;
the copies run the same numpy code on the same inputs).
"""

import os

import numpy as np
import pytest
import torch

from pymes_tpu.integral import symmetry as jsym
from pymes_tpu.util import cc4s_interface as jcc4s
from pymes_tpu.util import fcidump as jfcidump
from pymes_tpu.util import structure as jstructure
from pymes_tpu.util import tcdump as jtcdump
from pymes_tpu.util import tcfactors as jtcfactors
from pymes_tpu_torch.integral import symmetry as tsym
from pymes_tpu_torch.util import cc4s_interface as tcc4s
from pymes_tpu_torch.util import fcidump as tfcidump
from pymes_tpu_torch.util import structure as tstructure
from pymes_tpu_torch.util import tcdump as ttcdump
from pymes_tpu_torch.util import tcfactors as ttcfactors

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMPS = {"lih": ("FCIDUMP.LiH.321g", False), "tc_lih": ("FCIDUMP.LiH.tc",
                                                        True)}


def _read(name):
    path, is_tc = DUMPS[name]
    return os.path.join(DATA, path), is_tc


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_fcidump_write_byte_equal(name, tmp_path):
    path, is_tc = _read(name)
    n_elec, _, e_core, _, h, V = jfcidump.read(path, is_tc=is_tc)
    jfcidump.write(V, h, n_elec // 2, e_core, file=str(tmp_path / "j"))
    # the port writes from tensors: it must format the same numpy values
    tfcidump.write(torch.as_tensor(V), torch.as_tensor(h), n_elec // 2,
                   e_core, file=str(tmp_path / "t"))
    got, want = (tmp_path / "t").read_bytes(), (tmp_path / "j").read_bytes()
    assert got == want and len(got) > 1000
    back = tfcidump.read(str(tmp_path / "t"), is_tc=is_tc)
    assert np.array_equal(back[5], V) and np.array_equal(back[4], h)


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_read_blocks_equal(name):
    path, is_tc = _read(name)
    names = ("klij", "ijab", "abij", "iajb", "iabj", "abcd", "aibc")
    jr = jfcidump.read_blocks(path, 2, names=names, is_tc=is_tc)
    tr = tfcidump.read_blocks(path, 2, device="cpu", names=names, is_tc=is_tc)
    assert jr[:3] == tr[:3]
    assert np.array_equal(jr[3], tr[3]) and np.array_equal(jr[4], tr[4])
    for k in names:
        assert tr[5][k].dtype == torch.float64
        assert np.array_equal(jr[5][k], tr[5][k].numpy()), k
    # and the blocks of the dense reader
    V = tfcidump.read(path, is_tc=is_tc)[5]
    assert np.array_equal(tr[5]["aibc"].numpy(), V[2:, :2, 2:, 2:])


ALL_DUMPS = [("FCIDUMP.H2.sto6g", False), ("FCIDUMP.H2.tc", True),
             ("FCIDUMP.LiH.321g", False), ("FCIDUMP.LiH.tc", True)]


def _block(V, no, name):
    return V[tuple(slice(0, no) if c in "ijkl" else slice(no, None)
                   for c in name)]


@pytest.mark.parametrize("path,is_tc", ALL_DUMPS)
def test_readers_agree_with_jax_read(path, is_tc):
    """The dense and the block reader both give the JAX reader's values,
    also on the H2 TC dump, which lists pqrs and qpsr with different
    values."""
    path = os.path.join(DATA, path)
    want = jfcidump.read(path, is_tc=is_tc)
    got = tfcidump.read(path, is_tc=is_tc)
    assert got[:3] == want[:3]
    for g, w in zip(got[3:], want[3:]):
        assert np.array_equal(g, w)
    no = want[0] // 2
    names = ("klij", "ijab", "aibj", "abcd")
    tr = tfcidump.read_blocks(path, no, device="cpu", names=names, is_tc=is_tc)
    assert tr[:3] == want[:3]
    assert np.array_equal(tr[3], want[3]) and np.array_equal(tr[4], want[4])
    for k in names:
        assert np.array_equal(tr[5][k].numpy(), _block(want[5], no, k)), k


@pytest.mark.parametrize("path,is_tc", ALL_DUMPS)
def test_h5_round_trip_restores_jax_read(path, is_tc, tmp_path):
    pytest.importorskip("h5py")
    n_elec, n_orb, e_core, _, h, V = jfcidump.read(os.path.join(DATA, path),
                                                   is_tc=is_tc)
    out = str(tmp_path / "dump.h5")
    tfcidump.write_h5(out, torch.as_tensor(V), h, n_elec // 2, e_core)
    got = tfcidump.read_h5(out, is_tc=is_tc)
    assert got[:3] == (n_elec, n_orb, e_core)
    assert np.array_equal(got[4], h) and np.array_equal(got[5], V)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fcidump_h5_round_trip_across_packages(direction, tmp_path):
    pytest.importorskip("h5py")
    path, is_tc = _read("tc_lih")
    n_elec, n_orb, e_core, _, h, V = jfcidump.read(path, is_tc=is_tc)
    out = str(tmp_path / "dump.h5")
    writer, reader = ((tfcidump, jfcidump) if direction == "port_to_jax"
                      else (jfcidump, tfcidump))
    writer.write_h5(out, V, h, n_elec // 2, e_core)
    got = reader.read_h5(out, is_tc=True)
    assert got[:3] == (n_elec, n_orb, e_core)
    assert np.array_equal(got[4], h) and np.array_equal(got[5], V)


def test_tcdump_write_sparse_to_dense_equal(tmp_path):
    path = os.path.join(DATA, "TCDUMP.H2.tc")
    L = jtcdump.read(path)
    assert np.array_equal(ttcdump.read(path), L)
    jtcdump.write(L, str(tmp_path / "j"))
    ttcdump.write(L, str(tmp_path / "t"))
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert np.array_equal(ttcdump.read(str(tmp_path / "t")), L)
    sL = ttcdump.read_sparse(path)
    assert np.array_equal(ttcdump.sparse_to_dense(sL),
                          jtcdump.sparse_to_dense(jtcdump.read_sparse(path)))
    assert np.array_equal(ttcdump.sparse_to_dense(sL), L)
    for p, q in ((1, 1), (2, 5), (7, 3)):
        assert ttcdump.unique_index(p, q) == jtcdump.unique_index(p, q)


def test_symmetry_helpers_equal():
    rng = np.random.default_rng(11)
    L = rng.standard_normal((3,) * 6)
    assert tsym.sym_images_axes() == jsym.sym_images_axes()
    assert tsym.gen_sym_str_inds("abcdef") == jsym.gen_sym_str_inds("abcdef")
    S = tsym.symmetrize(L)
    assert np.array_equal(S, jsym.symmetrize(L))
    assert tsym.symmetry_defect(L) == jsym.symmetry_defect(L)
    assert tsym.symmetry_defect(S) < 1e-13
    for got, want in zip(tsym.unique_triangle(S), jsym.unique_triangle(S)):
        assert np.array_equal(got, want)
    idx, vals = tsym.unique_triangle(S)
    assert np.array_equal(tsym.recover_L(idx, vals, 3),
                          jsym.recover_L(idx, vals, 3))
    shape = (3, 4, 5)
    for g in (0, 17, 59):
        inds = tsym.global_ind_2_list_inds(g, shape)
        assert inds == jsym.global_ind_2_list_inds(g, shape)
        assert tsym.list_inds_2_global_ind(inds, shape) == g


def test_cc4s_files_equal(tmp_path, monkeypatch):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    monkeypatch.chdir(tmp_path)
    t = np.arange(24, dtype=float).reshape(2, 3, 4) / 7.0
    jcc4s.write_2_cc4s_tensor(t, [2, 3, 4], "J")
    tcc4s.write_2_cc4s_tensor(torch.as_tensor(t), [2, 3, 4], "T")
    j, p = (tmp_path / "J.dat").read_text(), (tmp_path / "T.dat").read_text()
    assert p.split("\n", 1)[1] == j.split("\n", 1)[1]   # past the name
    name, dims, data = tcc4s.read_cc4s_tensor("T.dat")
    assert (name, dims) == ("T", [2, 3, 4])
    assert np.array_equal(data, jcc4s.read_cc4s_tensor("J.dat")[2])
    jcc4s.dump_ftod(t, "FJ")
    tcc4s.dump_ftod(torch.as_tensor(t), "FJ2")
    assert ((tmp_path / "FJ2.dat").read_text().split("\n", 1)[1]
            == (tmp_path / "FJ.dat").read_text().split("\n", 1)[1])


def test_tcfactors_h5_fixture(tmp_path):
    h5py = pytest.importorskip("h5py")
    n_orb, n_grid = 4, 10
    rng = np.random.default_rng(2)
    path = str(tmp_path / "tcfactors.h5")
    with h5py.File(path, "w") as f:
        f["nBasis"] = np.array([n_orb])
        f["nGrid"] = np.array([n_grid])
        f["weights"] = rng.random(n_grid)
        f["mo_vals"] = rng.standard_normal((n_orb, n_grid))
        f["ycoulomb"] = rng.standard_normal((n_orb, n_grid))
    got, want = ttcfactors.read(path), jtcfactors.read(path)
    assert got[:2] == want[:2] == (n_orb, n_grid)
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g, w)
    with pytest.raises(NameError):
        ttcfactors.read("tcfactors.txt")


POSCAR = ("test cell\n1.5\n1.0 0.0 0.0\n0.0 1.0 0.0\n0.0 0.0 1.0\n"
          "2\nD\n0.0 0.0 0.0\n0.5 0.5 0.5\n")


def test_structure_poscar_and_optimizer_equal(tmp_path, monkeypatch):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    monkeypatch.chdir(tmp_path)
    (tmp_path / "POSCAR").write_text(POSCAR)
    js, ts = (m.Structure("POSCAR") for m in (jstructure, tstructure))
    for attr in ("numAtom", "latticeConstant", "typeCor", "atomSpec"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert np.array_equal(ts.posAtom, js.posAtom)
    assert np.array_equal(ts.findNNTable(), js.findNNTable())
    assert np.isclose(ts.findNNTable()[0, 1], np.sqrt(3) / 2 * 1.5)
    ts.write2File("POSCAR.t")
    (tmp_path / "StructureHistory.dat").rename(tmp_path / "history.t")
    js.write2File("POSCAR.j")
    assert (tmp_path / "POSCAR.t").read_bytes() == \
        (tmp_path / "POSCAR.j").read_bytes()
    assert (tmp_path / "history.t").read_bytes() == \
        (tmp_path / "StructureHistory.dat").read_bytes()

    (tmp_path / "forces.dat").write_text("0.1 0 0\n-0.1 0 0\n")
    pos = []
    for mod in (jstructure, tstructure):
        s = mod.Structure("POSCAR")
        opt = mod.Optimizer(s, timestep=0.1, threshhold=1e-3)
        assert not opt.run_step(hf_file="forces.dat")
        pos.append(s.posAtom)
    assert np.array_equal(pos[0], pos[1])
    with pytest.raises(ImportError):
        ts.getSpacegroup()
    with pytest.raises(ImportError):
        ts.getPrimitiveCell()


def _cells(mod):
    pc = mod.Structure()
    pc.numAtom = 2
    pc.posAtom = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    pc.typeCor = "C"
    pc.convert2SpgCell()
    sc = mod.Structure()
    sc.cellVecs = np.diag([2.0, 1.0, 1.0])
    sc.numAtom = 4
    sc.posAtom = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5],
                           [1.0, 0.0, 0.0], [1.5, 0.5, 0.5]])
    sc.typeCor = "C"
    sc.convert2SpgCell()
    return pc, sc


def test_relax_primitive_from_supercell_equal():
    f = np.array([[0.2, 0.0, 0.0], [-0.2, 0.0, 0.0],
                  [0.2, 0.0, 0.0], [-0.2, 0.0, 0.0]])
    map2pc = np.array([[0, 0], [1, 1]])
    outs = [mod.relax_primitive_from_supercell(*_cells(mod), f, map2pc,
                                               threshhold=1e-3,
                                               timestep=0.01)
            for mod in (jstructure, tstructure)]
    (jpc, jT, jup), (tpc, tT, tup) = outs
    assert tup and jup
    assert np.array_equal(tT, jT)
    assert np.array_equal(tT, np.diag([2.0, 1.0, 1.0]))
    assert np.array_equal(tpc.posAtom, jpc.posAtom)
