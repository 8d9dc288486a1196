"""The port's examples (``pymes_tpu_torch/examples``) against the JAX
package's ``examples/*.py`` on the CPU: the molecular CCSD → EOM-CCSD
workflow on LiH/3-21G (its checkpoint written where the caller says), the
RT autocorrelation for 2 steps, and the TC twist average on the 2³ mesh.

Tolerances: the CCSD energy 1e-10 (and 1e-8 from the oracle); the EOM roots
1e-8, the Davidson convergence threshold (``e_epsilon``) of both
packages, since the JAX example runs its default mixed-precision Davidson
(an f32 bulk, then f64) and the port's example the port's default f64
path: the two land 1.42e-9 apart on LiH/3-21G, where the port's mixed
Davidson (``precision="mixed"``) on the same input lands 1.59e-11 from the
JAX example's roots (measured on a CPU); c(t) 1e-7, since both
examples stop each contour node's GMRES at the default relative residual
``ls_conv_tol`` = 1e-4 and the port solves the complex system in its real
(Re, Im) embedding, whose Krylov space is another than the JAX complex
GMRES's (the RT solves themselves agree to 1e-12 at a tight tolerance,
``tests/test_torch_rt.py``); the TC twist energies 1e-12 relative.
"""

import importlib.util
import os
import types
from pathlib import Path

import numpy as np

from pymes_tpu.util.kpoints import gen_ir_ks
from pymes_tpu_torch.examples import (molecular_ccsd_eom,
                                      rt_autocorrelation,
                                      ueg_tc_twist_average)
from pymes_tpu_torch.util import checkpoint

REPO = Path(__file__).resolve().parent.parent


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_molecular_example_matches_jax(tmp_path):
    jex = _jax_example("molecular_ccsd_eom")
    caught = {}
    real = jex.checkpoint
    # catch the JAX example's checkpoint instead of its fixed /tmp path
    jex.checkpoint = types.SimpleNamespace(
        save=lambda path, ck: caught.update(ck=ck),
        from_result=real.from_result)

    class EOM(jex.eom_ccsd.EOM_CCSD):
        def solve(self, *args):
            caught["roots"] = [float(e) for e in super().solve(*args)]
            return caught["roots"]

    jex.eom_ccsd = types.SimpleNamespace(EOM_CCSD=EOM)
    jex.main(str(molecular_ccsd_eom.DEFAULT_DUMP))

    out = molecular_ccsd_eom.main(device="cpu",
                                  checkpoint_path=str(tmp_path / "ck"))
    assert abs(out["ccsd e"] - caught["ck"].energy) <= 1e-10
    assert abs(out["ccsd e"] - (-0.01908832713)) <= 1e-8
    assert np.abs(np.array(out["roots"])
                  - np.array(caught["roots"])).max() <= 1e-8
    ck = checkpoint.load(str(tmp_path / "ck"))
    assert ck.energy == out["ccsd e"]
    assert np.abs(ck.t2 - caught["ck"].t2).max() <= 1e-9
    assert np.abs(ck.t1 - caught["ck"].t1).max() <= 1e-9


def test_rt_example_matches_jax(tmp_path, monkeypatch):
    os.chdir(REPO)  # an earlier test may leave the cwd deleted
    monkeypatch.chdir(tmp_path)
    _jax_example("rt_autocorrelation").main(2, 0.1)
    want = np.load("ct.npy")
    t, c_t = rt_autocorrelation.main(2, 0.1, "cpu", out="port_ct.npy")
    got = np.load("port_ct.npy")
    assert np.array_equal(got[:, 0], want[:, 0])
    assert np.abs(got[:, 1:] - want[:, 1:]).max() <= 1e-7
    assert np.array_equal(got[:, 1] + 1j * got[:, 2], c_t)


def test_tc_twist_example_matches_jax():
    jex = _jax_example("ueg_tc_twist_average")
    rows, total = ueg_tc_twist_average.main(2, "cpu")
    ks, weights = gen_ir_ks(2)
    want = np.zeros(3)
    for (k, w, *got), kj, wj in zip(rows, ks, weights):
        assert np.array_equal(k, kj) and w == wj
        ref = np.array(jex.tc_mp2(kj))
        want += wj * ref
        assert np.abs(np.array(got) - ref).max() <= \
            1e-12 * np.abs(ref).max()
    assert np.abs(total - want).max() <= 1e-12 * np.abs(want).max()
