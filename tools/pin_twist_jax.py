#!/usr/bin/env python3
"""Numbers of the JAX package (f64, on the CPU) that ``chip_smoke.py``
phase 19 holds the port to: the twist-averaged matrix-free CCD and the
three examples.

* ``twist``: mf-CCD of UEG 14e, rs 0.5, cutoff 14 at each irreducible
  twist of the 3³ mesh (``util/kpoints.gen_ir_ks(3)``): the sparse
  integrals scattered into the named blocks, the diagonal HF Fock of
  ``calcOccupiedOrbE``/``calcVirtualOrbE``, the virtual block-ladder plan,
  DIIS, level shift −1, |dE| < 1e-8.  Prints nP, the HF gap, the energy and
  iteration count of each twist, and the weighted mean.
* ``molecular``: ``examples/molecular_ccsd_eom.py`` on LiH/3-21G (CCSD
  energy, iterations, the two EOM-CCSD roots; its checkpoint is caught in
  memory, not written).
* ``rt``: ``examples/rt_autocorrelation.py`` for ``--rt-steps`` steps of
  0.1 (c(t) of each step; its ct.npy goes to a temporary directory).
* ``tc``: ``examples/ueg_tc_twist_average.py`` at mesh 3 (HF, 3-body and
  MP2 energies of each twist and their weighted sums).

Run from the repository root:
``python3 tools/pin_twist_jax.py [--cutoff 14] [--parts twist,molecular,rt,tc]``
(the twist part took ~30 s at cutoff 14 on an 8-core CPU).
"""

import argparse
import importlib.util
import os
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pymes_tpu.log import set_verbosity  # noqa: E402
from pymes_tpu.mean_field import hf  # noqa: E402
from pymes_tpu.models import ueg  # noqa: E402
from pymes_tpu.ops import ueg_ladder  # noqa: E402
from pymes_tpu.solver import ccd  # noqa: E402
from pymes_tpu.util.kpoints import gen_ir_ks  # noqa: E402

NO = 7
RS = 0.5
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")


def example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twist_ccd(cutoff, shift):
    """(nP, HF gap, energy, iterations, energy history) of the mf-CCD at
    one twist."""
    u = ueg.UEG(14, NO, NO, RS)
    u.init_single_basis(cutoff, list(shift))
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    plan = ueg_ladder.build_block_ladder(u, preslice=None)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=plan)
    res = ccd.CCD(NO).solve(fock, blocks, level_shift=-1.0, max_iter=60,
                            contract_mode="xla")
    hist = [float(e) for e in np.asarray(res["e history"])]
    gap = float(jnp.min(eps_a) - jnp.max(eps_i))
    return n_p, gap, float(res["ccd e"]), len(hist), hist


def twist(cutoff):
    ks, weights = gen_ir_ks(3)
    energies = []
    for k, w in zip(ks, weights):
        t0 = time.time()
        n_p, gap, e, n_it, hist = twist_ccd(cutoff, k)
        energies.append(e)
        print(f"twist {k.tolist()} w={float(w)!r} nP={n_p} gap={gap!r}: "
              f"E={e!r} in {n_it} iterations ({time.time() - t0:.1f} s)",
              flush=True)
        print(f"  history {hist}", flush=True)
    print(f"twist mean: {float(np.dot(weights, energies))!r}", flush=True)


def molecular():
    mod = example("molecular_ccsd_eom")
    caught = {}
    real = mod.checkpoint

    def save(path, ck):
        caught["ck"] = ck

    mod.checkpoint = types.SimpleNamespace(save=save,
                                           from_result=real.from_result)

    class EOM(mod.eom_ccsd.EOM_CCSD):
        def solve(self, *args):
            caught["roots"] = [float(e) for e in super().solve(*args)]
            return caught["roots"]

    mod.eom_ccsd = types.SimpleNamespace(EOM_CCSD=EOM)
    mod.main(str(REPO / "tests" / "data" / "FCIDUMP.LiH.321g"))
    print(f"molecular: ccsd e {caught['ck'].energy!r}, roots "
          f"{caught['roots']!r}", flush=True)


def rt(steps):
    mod = example("rt_autocorrelation")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            mod.main(steps, 0.1)
            ct = np.load("ct.npy")
        finally:
            os.chdir(cwd)
    print(f"rt: c(t) re {ct[:, 1].tolist()!r} im {ct[:, 2].tolist()!r}",
          flush=True)


def tc():
    mod = example("ueg_tc_twist_average")
    ks, weights = gen_ir_ks(3)
    total = np.zeros(3)
    for k, w in zip(ks, weights):
        row = mod.tc_mp2(k)
        total += w * np.array(row)
        print(f"tc twist {k.tolist()}: (HF, 3-body, MP2) {row!r}",
              flush=True)
    print(f"tc total (HF, 3-body, MP2) {total.tolist()!r}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cutoff", type=int, default=14,
                    help="twist mf-CCD cutoff (14: nP=211-223)")
    ap.add_argument("--rt-steps", type=int, default=3)
    ap.add_argument("--parts", default="twist,molecular,rt,tc")
    args = ap.parse_args()
    set_verbosity(0)
    parts = args.parts.split(",")
    if "molecular" in parts:
        molecular()
    if "rt" in parts:
        rt(args.rt_steps)
    if "tc" in parts:
        tc()
    if "twist" in parts:
        twist(args.cutoff)


if __name__ == "__main__":
    main()
