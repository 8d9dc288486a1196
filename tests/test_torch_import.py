"""The PyTorch port stands alone: it never imports jax, and the host-numpy
code it carries as copies (plane-wave basis, UEG integral lists, partition
names, ladder plan) stays identical to the JAX package's originals.

Identity checks are exact (``array_equal``): the copies run the same numpy
arithmetic in the same order, so any difference is a drift of one copy.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pymes_tpu.basis_set import planewave as jplanewave
from pymes_tpu.integral import partition as jpartition
from pymes_tpu.models import ueg as jueg
from pymes_tpu.ops import ueg_ladder as jladder
from pymes_tpu_torch.basis_set import planewave as tplanewave
from pymes_tpu_torch.integral import partition as tpartition
from pymes_tpu_torch.models import ueg as tueg
from pymes_tpu_torch.ops import ueg_ladder as tladder

REPO = Path(__file__).resolve().parent.parent


def _models(cutoff, rs=0.5):
    uj, ut = jueg.UEG(14, 7, 7, rs), tueg.UEG(14, 7, 7, rs)
    uj.init_single_basis(cutoff)
    ut.init_single_basis(cutoff)
    return uj, ut


# the utilities slice: configs, I/O, checkpoint, observability, roofline,
# twists and structure factor, and the examples
UTILITY_MODULES = tuple("pymes_tpu_torch." + m for m in (
    "configs", "util.roofline", "util.flops", "util.checkpoint",
    "util.observability", "util.kpoints", "util.structure_factor",
    "util.fcidump", "util.tcdump", "util.tcfactors", "util.cc4s_interface",
    "util.structure", "integral.symmetry", "model",
    "examples.molecular_ccsd_eom", "examples.rt_autocorrelation",
    "examples.ueg_tc_twist_average"))
# the last solver slice: the generic FEAST kernel and its adapters, the
# node fan-out and the native record parser; the tensor-parallel iteration
SOLVER_MODULES = tuple("pymes_tpu_torch." + m for m in (
    "solver.feast_kernel", "solver.feast_eom_rccsd", "parallel.sharding",
    "_native", "parallel.tensor_parallel"))


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import pymes_tpu_torch, pymes_tpu_torch.solver.ccd, "
            "pymes_tpu_torch.ops.ueg_ladder, pymes_tpu_torch.interop, "
            "pymes_tpu_torch.kernels.ccd_tail, "
            "pymes_tpu_torch.solver.ccsd, pymes_tpu_torch.util.fcidump, "
            "pymes_tpu_torch.util.tcdump, "
            "pymes_tpu_torch.integral.contraction, "
            "pymes_tpu_torch.kernels.ovvv_gather, "
            "pymes_tpu_torch.kernels.ccsd_tail, "
            "pymes_tpu_torch.kernels.arnoldi, "
            "pymes_tpu_torch.kernels.shifted, pymes_tpu_torch.ops.gmres, "
            "pymes_tpu_torch.solver.feast_eom_ccsd, "
            "pymes_tpu_torch.solver.rt_eom_ccsd, "
            "pymes_tpu_torch.parallel.mesh, "
            "pymes_tpu_torch.parallel.ring_ladder, "
            "pymes_tpu_torch.kernels.ring_step, "
            "pymes_tpu_torch.models.ueg, pymes_tpu_torch.solver.drccd, "
            "pymes_tpu_torch.solver.dcd, "
            + ", ".join(UTILITY_MODULES + SOLVER_MODULES) + "\n"
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'pymes_tpu.')) "
            "or m == 'pymes_tpu')\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_utility_modules_import_neither_h5py_nor_spglib():
    """h5py and spglib are optional (the card's machine has neither): the
    new modules import them only inside the functions that need them."""
    code = ("import sys\n"
            "import " + ", ".join(UTILITY_MODULES) + "\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('h5py', 'spglib'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_feast_kernel_imports_joblib_only_to_fan_out():
    """joblib (absent on the card's machine) is imported only where
    ``feast(n_jobs != 1)`` fans out; importing the modules and running
    the serial kernel leaves it out of ``sys.modules``."""
    code = ("import sys\n"
            "import numpy as np\n"
            "import " + ", ".join(SOLVER_MODULES) + "\n"
            "from pymes_tpu_torch.solver import feast_kernel\n"
            "h = np.diag(np.arange(6.0))\n"
            "feast_kernel.feast(lambda x: h @ x, np.diag(h), e_c=2.0, "
            "e_r=0.5, max_cycle=1, seed=0, verbose=False)\n"
            "assert 'joblib' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_model_alias_is_the_ueg_module():
    from pymes_tpu.model import ueg as jalias
    from pymes_tpu_torch.model import ueg as alias
    assert alias is tueg and jalias is jueg


def test_port_sources_name_no_jax():
    """No module of the port imports jax or the JAX package by text either
    (a lazy import inside a function would escape the subprocess check)."""
    for path in (REPO / "pymes_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "jaxlib", "pymes_tpu"), \
                    f"{path.name}: {line.strip()}"


@pytest.mark.parametrize("cutoff", [2, 5])
def test_planewave_basis_identical(cutoff):
    L = 0.5 * ((4 * np.pi * 14) / 3) ** (1.0 / 3.0)
    bj = jplanewave.build_basis(cutoff, L)
    bt = tplanewave.build_basis(cutoff, L)
    assert bj.imax == bt.imax
    for field in ("k_int", "kp", "kinetic", "index_map"):
        assert np.array_equal(getattr(bj, field), getattr(bt, field)), field


@pytest.mark.parametrize("cutoff", [2, 5])
def test_eval_2b_integrals_identical(cutoff):
    uj, ut = _models(cutoff)
    idx_j, vals_j = uj.eval_2b_integrals(sp=2)
    idx_t, vals_t = ut.eval_2b_integrals(sp=2)
    assert np.array_equal(idx_j, idx_t)
    assert np.array_equal(vals_j, vals_t)
    assert np.array_equal(uj.kinetic_energies(), ut.kinetic_energies())
    if cutoff == 2:  # dense form as well (nP⁴ is small here)
        assert np.array_equal(uj.eval_2b_integrals(),
                              ut.eval_2b_integrals())


def test_lookup_keeps_per_component_bounds():
    """The port keeps the JAX package's per-component bounds check: a k
    vector with one component out of range maps to −1 in both copies."""
    uj, ut = _models(5)
    imax = ut.imax
    rng = np.random.default_rng(7)
    k = rng.integers(-2 * imax, 2 * imax + 1, size=(500, 3))
    k[:5] = [[0, imax + 1, 0], [imax, 0, 0], [0, 0, -imax - 1],
             [imax + 1, -imax - 1, 0], [0, 0, 0]]
    assert np.array_equal(uj._lookup_flat(k), ut._lookup_flat(k))
    assert (ut._lookup_flat(k[:5])[[0, 2, 3]] == -1).all()


def test_log_copy_prints_the_same(capsys):
    from pymes_tpu import log as jlog
    from pymes_tpu_torch import log as tlog
    outs = []
    for mod in (jlog, tlog):
        mod.print_title("CCD", level=1)
        mod.print_title("sub", "-", level=2, debug_level=3)
        mod.print_logging_info("E = ", 1.5, level=1)
        mod.print_logging_info("muted", level=5)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "muted" not in outs[1]


def test_partition_names_identical():
    assert tpartition.BLOCK_NAMES == jpartition.BLOCK_NAMES
    assert set(tpartition.OCC_LETTERS) == set(jpartition.OCC_LETTERS)


def test_sparse_scatter_matches_jax():
    """``sparse_to_blocks`` / ``sparse_to_dense`` on the CPU give the JAX
    package's blocks exactly (a scatter of unique indices: no sums)."""
    uj, ut = _models(2)
    idx, vals = ut.eval_2b_integrals(sp=2)
    n_p, no = ut.n_spatial, 7
    names = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "abcd")
    dj = jueg.sparse_to_blocks(idx, vals, n_p, no, names=names)
    dt = tueg.sparse_to_blocks(idx, vals, n_p, no, device="cpu", names=names)
    for name in names:
        assert dt[name].dtype == torch.float64
        assert np.array_equal(np.asarray(dj[name]), dt[name].numpy()), name
    Vt = tueg.sparse_to_dense(idx, vals, n_p, device="cpu")
    assert np.array_equal(np.asarray(jueg.sparse_to_dense(idx, vals, n_p)),
                          Vt.numpy())


@pytest.mark.parametrize("bra", ["virtual", "all"])
@pytest.mark.parametrize("cutoff", [2, 5])
def test_build_block_ladder_identical(cutoff, bra):
    uj, ut = _models(cutoff)
    pj = jladder.build_block_ladder(uj, bra=bra, preslice=None)
    pt = tladder.build_block_ladder(ut, device="cpu", bra=bra)
    assert (pt.n_bra, pt.nv, pt.w0) == (pj.n_bra, pj.nv, pj.w0)
    assert len(pt.groups) == len(pj.groups)
    for gj, gt in zip(pj.groups, pt.groups):
        assert np.array_equal(np.asarray(gj.blocks), gt.blocks.numpy())
        assert np.array_equal(np.asarray(gj.perm_ket), gt.perm_ket.numpy())
    assert np.array_equal(np.asarray(pj.inv_bra), pt.inv_bra.numpy())


def test_explicit_device_required():
    """The device defaults to the card: without one, the default, None
    and "cuda" all raise RuntimeError (no CPU fallback); the CPU takes
    ``device="cpu"``."""
    _, ut = _models(2)
    assert tladder.build_block_ladder(ut, device="cpu").inv_bra.is_cpu
    if torch.cuda.is_available():
        assert tladder.build_block_ladder(ut).inv_bra.is_cuda
        return
    for kw in ({}, {"device": None}, {"device": "cuda"}):
        with pytest.raises(RuntimeError):
            tladder.build_block_ladder(ut, **kw)
