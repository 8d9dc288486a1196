#!/usr/bin/env python3
"""Energies of the JAX package (f64, on the CPU) that ``chip_smoke.py``
phase 18 holds the port to: the transcorrelated UEG and drCCD.

* ``tc-ccd``: non-hermitian TC CCD through the matrix-free block ladder.
  UEG 14e, rs 0.5, the ``gaskell`` correlator with ``gamma = None`` and
  ``k_cutoff = L/(2π)·2.3225029893472993/rs`` (``tests/test_ueg.py:114``),
  ``is_only_2b``; the sparse integrals scattered into the named blocks, the
  diagonal HF Fock of ``calcOccupiedOrbE``/``calcVirtualOrbE``, the
  virtual non-hermitian plan, DIIS, level shift −1, |dE| < 1e-8.
* ``tc-ccsd``: hermitian-TC (``is_only_hermi_2b``, same correlator)
  matrix-free CCSD on the all-bra plan and the TC OVVV plans, with the
  seeded non-canonical Fock (noise ``rng(5)·0.02``, symmetrised), level
  shift −1, |dE| < 1e-10.
* ``drccd``: Coulomb drCCD on the dense blocks at cutoff 5 (nP=57), DIIS,
  level shift −1, |dE| < 1e-8.

Prints each energy with its iteration count and energy history.  At
cutoff 14 (nP=219) the host set-up takes minutes on one core.

Run from the repository root:
``python3 tools/pin_tc_jax.py [--cutoff 14] [--parts tc-ccd,tc-ccsd,drccd]``
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pymes_tpu.log import set_verbosity  # noqa: E402
from pymes_tpu.mean_field import hf  # noqa: E402
from pymes_tpu.models import ueg  # noqa: E402
from pymes_tpu.ops import ueg_ladder  # noqa: E402
from pymes_tpu.solver import ccd, ccsd  # noqa: E402

NO = 7
RS = 0.5
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
        "ijak", "iajk")


def tc_model(cutoff):
    u = ueg.UEG(14, NO, NO, RS)
    u.init_single_basis(cutoff)
    u.gamma = None
    u.k_cutoff = u.L / (2 * np.pi) * 2.3225029893472993 / RS
    return u


def blocks_and_fock(u, **flags):
    idx, vals = u.eval_2b_integrals(sp=2, **flags)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    return d, eps_i, eps_a


def report(label, res, key, t0):
    hist = np.asarray(res["e history"])
    print(f"{label}: E={res[key]!r} in {len(hist)} iterations "
          f"({time.time() - t0:.1f} s)", flush=True)
    print(f"{label}: history {[float(e) for e in hist]}", flush=True)


def tc_ccd(cutoff):
    t0 = time.time()
    u = tc_model(cutoff)
    d, eps_i, eps_a = blocks_and_fock(u, correlator=u.gaskell,
                                      is_only_2b=True)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    plan = ueg_ladder.build_block_ladder(u, correlator=u.gaskell,
                                         preslice=None, is_only_2b=True)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=plan)
    res = ccd.CCD(NO).solve(fock, blocks, level_shift=-1.0, max_iter=60,
                            contract_mode="xla")
    report(f"TC CCD (gaskell, is_only_2b) nP={u.n_spatial}", res, "ccd e",
           t0)


def tc_ccsd(cutoff):
    t0 = time.time()
    u = tc_model(cutoff)
    flags = {"is_only_hermi_2b": True}
    d, eps_i, eps_a = blocks_and_fock(u, correlator=u.gaskell, **flags)
    n_p = u.n_spatial
    eps = np.asarray(jnp.concatenate([eps_i, eps_a]))
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    fock = jnp.asarray(np.diag(eps) + noise + noise.T)
    dmf = {k: d[k] for k in NEED}
    dmf["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, u.gaskell, **flags)
    plan = ueg_ladder.build_block_ladder(u, correlator=u.gaskell,
                                         bra="all", preslice=None, **flags)
    res = ccsd.CCSD(NO).solve(fock, dmf, level_shift=-1.0, max_iter=100,
                              delta_e=1e-10, ladder=plan,
                              contract_mode="xla")
    report(f"TC CCSD (gaskell, is_only_hermi_2b, non-canonical) nP={n_p}",
           res, "ccsd e", t0)
    print(f"  |T1|max = {float(np.abs(np.asarray(res['t1'])).max())!r}")


def drccd(cutoff):
    t0 = time.time()
    u = ueg.UEG(14, NO, NO, RS)
    u.init_single_basis(cutoff)
    d, eps_i, eps_a = blocks_and_fock(u)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None)
    res = ccd.CCD(NO, is_dr_ccd=True).solve(
        fock, blocks, level_shift=-1.0, max_iter=60, contract_mode="xla")
    report(f"drCCD (Coulomb, dense blocks) nP={u.n_spatial}", res, "ccd e",
           t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cutoff", type=int, default=14,
                    help="TC cutoff (14: nP=219); drCCD runs at cutoff 5")
    ap.add_argument("--parts", default="tc-ccd,tc-ccsd,drccd")
    args = ap.parse_args()
    set_verbosity(0)
    parts = args.parts.split(",")
    if "drccd" in parts:
        drccd(5)
    if "tc-ccd" in parts:
        tc_ccd(args.cutoff)
    if "tc-ccsd" in parts:
        tc_ccsd(args.cutoff)


if __name__ == "__main__":
    main()
