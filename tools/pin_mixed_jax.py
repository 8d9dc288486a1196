#!/usr/bin/env python3
"""Numbers of the JAX package's precision modes (on the CPU) that
``chip_smoke.py`` phase 25 holds the port's to.

* ``eom``: the default (``precision="mixed"``) EOM-CCSD Davidson at UEG
  14e, rs 0.5, cutoff 5 (nP=57) on the matrix-free no-ovvv operator and the
  mf-CCD amplitudes of ``benchmarks/_setup.build_ueg_mf(5,
  contract_mode="xla")`` (n_excit 2, max_dim 16, ``contract_mode="xla"``):
  the sorted roots, the f32 seed phase's iterations and the f64 polish's.
* ``eom_tight``: the converged roots of the same problem, the JAX
  package's f64 Davidson (``precision="f64"``, MOM) to |dE| < 1e-12;
  ``--cutoff 14`` takes the nP=219 problem instead (the mf-CCD of
  ``build_ueg_mf(14, ...)`` included: 280 s on two cores, 241 s of it
  the Davidson's 16 iterations).
* ``ccd``: ``CCD.solve(mixed_precision=True)`` at nP=57 on the virtual
  ladder plan (the blocks and diagonal HF Fock of ``chip_smoke.setup``,
  DIIS, level shift −1, ``max_iter`` 60, |dE| < 1e-8): the energy, the f32
  iterations and the f64 polish's.
* ``lih``: ``CCSD.solve(mixed_precision=True)`` on LiH/3-21G (|dE| <
  1e-8): the energy, the f32 iterations and the polish's.

Run from the repository root:
``python3 tools/pin_mixed_jax.py [--parts eom,eom_tight,ccd,lih]
[--cutoff C]`` (a few minutes on one core at cutoff 5, most of it the JAX
compiles of the EOM; ``--cutoff`` applies to ``eom_tight`` alone).
"""

import argparse
import contextlib
import io
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks._setup import build_ueg_mf  # noqa: E402
from pymes_tpu.mean_field import hf  # noqa: E402
from pymes_tpu.models import ueg  # noqa: E402
from pymes_tpu.ops import ueg_ladder  # noqa: E402
from pymes_tpu.solver import ccd, ccsd, eom_ccsd  # noqa: E402
from pymes_tpu.util import fcidump  # noqa: E402

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")


def logged(fn):
    """``fn()`` with its printed log captured; returns (result, log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def f32_iterations(log):
    return int(re.search(r"mixed precision: (\d+) f32 iterations",
                         log).group(1))


def eom():
    t0 = time.time()
    x = build_ueg_mf(5, contract_mode="xla", verbose=False)
    s = eom_ccsd.EOM_CCSD(NO, n_excit=2)
    s.max_dim = 16
    s.contract_mode = "xla"
    # prints the f32 phase's iterations (and each tracked iteration)
    s._debug_track = True
    e, log = logged(lambda: s.solve(x["fock"], x["Vd"], x["T2"]))
    it32 = int(re.search(r"f32 phase e=.* iters=(\d+)", log).group(1))
    print(f"eom nP={x['n_p']}: mixed roots "
          f"{[float(r) for r in np.sort(np.real(e))]} in {it32} f32 + "
          f"{s.n_iterations} f64 iterations ({time.time() - t0:.1f} s)",
          flush=True)


def eom_tight(cutoff=5):
    t0 = time.time()
    x = build_ueg_mf(cutoff, contract_mode="xla", verbose=False)
    s = eom_ccsd.EOM_CCSD(NO, n_excit=2)
    s.max_dim = 16
    s.contract_mode = "xla"
    s.precision, s.root_tracking = "f64", "guess"
    s.e_epsilon, s.max_iter = 1e-12, 300
    t1 = time.time()
    e, _ = logged(lambda: s.solve(x["fock"], x["Vd"], x["T2"]))
    print(f"eom nP={x['n_p']}: f64 roots to |dE| < 1e-12 "
          f"{[float(r) for r in np.sort(np.real(e))]} in {s.n_iterations} "
          f"iterations ({time.time() - t0:.1f} s, the Davidson "
          f"{time.time() - t1:.1f} s)", flush=True)


def ccd_np57():
    t0 = time.time()
    u = ueg.UEG(14, NO, NO, 0.5)
    u.init_single_basis(5)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, names=NEED,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    blocks = ccd.CCDBlocks(
        klij=d["klij"], ijab=d["ijab"], abij=d["abij"], iajb=d["iajb"],
        iabj=d["iabj"], abcd=None,
        ladder=ueg_ladder.build_block_ladder(u, preslice=None))
    res, log = logged(lambda: ccd.CCD(NO).solve(
        jnp.diag(jnp.concatenate([eps_i, eps_a])), blocks, level_shift=-1.0,
        max_iter=60, contract_mode="xla", mixed_precision=True))
    print(f"ccd nP={n_p}: mixed E={res['ccd e']!r} in {f32_iterations(log)} "
          f"f32 + {len(res['e history'])} f64 iterations "
          f"({time.time() - t0:.1f} s)", flush=True)


def lih():
    t0 = time.time()
    n_elec, _, _, _, h, V = fcidump.read(str(ROOT / "tests" / "data"
                                             / "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h, V)
    res, log = logged(lambda: ccsd.CCSD(no).solve(fock, V,
                                                  mixed_precision=True))
    print(f"lih CCSD: mixed E={res['ccsd e']!r} in {f32_iterations(log)} "
          f"f32 + {len(res['e history'])} f64 iterations "
          f"({time.time() - t0:.1f} s)", flush=True)


PARTS = {"eom": eom, "eom_tight": eom_tight, "ccd": ccd_np57, "lih": lih}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--cutoff", type=int, default=5,
                    help="the UEG cutoff of eom_tight (5: nP=57, 14: nP=219)")
    args = ap.parse_args()
    for part in args.parts.split(","):
        if part == "eom_tight":
            eom_tight(args.cutoff)
        else:
            PARTS[part]()


if __name__ == "__main__":
    main()
