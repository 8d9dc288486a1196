#!/usr/bin/env python3
"""The FEAST/RT mixed-precision engine of ``pymes_tpu_torch``
(``ls_precision="mixed"``) beside its f64 path at nP=19 on the CPU, where
every kernel runs its plain twin: refinement passes, Arnoldi steps and
honest residuals.

    python3 tools/mixed_cpu.py

UEG 14 electrons, rs = 0.5, cutoff 2 (nP=19): the matrix-free CCD
amplitudes and the no-ovvv EOM operator (the small blocks, the all-bra
ladder plan, the OVVV plans), as ``chip_smoke.py`` builds them at nP=57
and nP=123, and the port's Davidson root e0; then

* FEAST in the window e0 ± 0.05 (4 nodes × 2 trials, 2 iterations,
  GMRES(30) × 4 solves, ``ls_conv_tol`` 1e-10), f64 and mixed with
  ``ls_refine_max`` 8: the refinement passes of each lane chunk and the
  largest honest residual;
* one RT step from the Davidson vector (32 nodes, e_r 0.5, dt 0.1,
  GMRES(20), ``ls_conv_tol`` 1e-10), f64 and mixed: the mean and largest
  Arnoldi steps of the lanes in each Krylov solve (one solve in f64, one a
  refinement pass in the mixed engine).

Prints one line a run; a few minutes on a CPU.  Counts and residuals only:
a time taken here is the CPU's, not the card's.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pymes_tpu_torch.mean_field import hf  # noqa: E402
from pymes_tpu_torch.models import ueg  # noqa: E402
from pymes_tpu_torch.ops import ueg_ladder  # noqa: E402
from pymes_tpu_torch.solver import (ccd, eom_ccsd, feast_eom_ccsd,  # noqa: E402
                                    rt_eom_ccsd)

NO = 7
BLOCKS = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
          "ijak", "iajk")


def operator():
    """(fock, no-ovvv EOM operator, CCD T2) of UEG 14e, rs 0.5, cutoff 2."""
    u = ueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(2)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, "cpu", names=BLOCKS)
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    fock = torch.diag(torch.cat([eps_i, eps_a]))
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=ueg_ladder.build_block_ladder(u, "cpu"))
    T2 = ccd.CCD(NO, "cpu").solve(fock, blocks, level_shift=-1.0,
                                  max_iter=60)["t2 amp"]
    V = {k: d[k] for k in BLOCKS if k not in ("aibj", "aijb")}
    V.update(abcd=None,
             abcd_ladder=ueg_ladder.build_block_ladder(u, "cpu", bra="all"),
             _ovvv_plans=ueg_ladder.build_ovvv_plans(u, "cpu"))
    return fock, V, T2


def steps(st):
    return [(round(float(np.mean(a)), 2), int(np.max(a))) for a in st]


def main():
    fock, V, T2 = operator()
    dav = eom_ccsd.EOM_CCSD(NO, "cpu", n_excit=2)
    dav.e_epsilon = 1e-10
    e0 = float(np.sort(np.real(dav.solve(fock, V, T2)))[0])
    print(f"nP=19 Davidson root {e0:.13f}")
    for prec in ("f64", "mixed"):
        s = feast_eom_ccsd.FEAST_EOM_CCSD(
            NO, "cpu", e_c=e0, e_r=0.05, n_trial=2, n_quad=4, n_excit=2,
            max_iter=2, tol=1e-10, seed=7, ls_conv_tol=1e-10,
            ls_precision=prec)
        s.ls_restart, s.ls_max_iter, s.ls_refine_max = 30, 4, 8
        s.solve(fock, V, T2)
        print(f"FEAST {prec}: passes a chunk {s.ls_stats['passes']}, "
              f"largest honest residual {np.max(s.last_ls_residuals):.2e}",
              flush=True)
    u = (dav.u_singles[0].numpy().astype(complex),
         dav.u_doubles[0].numpy().astype(complex))
    for prec in ("f64", "mixed"):
        s = rt_eom_ccsd.RT_EOM_CCSD(NO, "cpu", e_c=e0, e_r=0.5, n_quad=32,
                                    ls_conv_tol=1e-10, ls_precision=prec)
        s.ls_restart = 20
        s.solve(fock, V, T2, dt=0.1, u_singles=u[0], u_doubles=u[1])
        print(f"RT {prec}: passes {s.ls_stats['passes']}, Arnoldi steps "
              f"(mean, max) of the lanes a solve {steps(s.ls_stats['steps'])}"
              f", largest honest residual "
              f"{np.max(s.last_ls_residuals):.2e}", flush=True)


if __name__ == "__main__":
    main()
