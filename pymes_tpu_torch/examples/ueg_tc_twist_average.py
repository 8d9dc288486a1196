"""Transcorrelated UEG with twist averaging, as
``examples/ueg_tc_twist_average.py`` of the JAX package: 14 electrons at
rs = 1, the gaskell correlator, the 3-body mean-field corrections and
TC-MP2 at each irreducible twist of a mesh, weight-averaged.  The
integrals are host numpy; the HF and MP2 contractions run on ``device``.

    python -m pymes_tpu_torch.examples.ueg_tc_twist_average [mesh=3]
        [--device cuda]
"""

import argparse

import numpy as np
import torch

from pymes_tpu_torch.config import DTYPE, resolve_device
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.models import ueg
from pymes_tpu_torch.solver import mp2
from pymes_tpu_torch.util.kpoints import gen_ir_ks


def tc_mp2(shift, device):
    """(HF, 3-body, TC-MP2) energies at twist ``shift``."""
    nel, rs = 14, 1.0
    k_f = 0.5 * (3 * nel / np.pi) ** (1.0 / 3)
    no = nel // 2
    u = ueg.UEG(nel, no, no, rs)
    u.init_single_basis((k_f * 1.2) ** 2, list(shift))
    u.gamma, u.k_cutoff = None, 1.0

    def on_dev(x):
        return torch.as_tensor(x, dtype=DTYPE, device=device)

    V = on_dev(u.eval_2b_integrals(correlator=u.gaskell, is_only_2b=True))
    h = on_dev(np.diag(u.kinetic_energies()))
    fock = hf.construct_hf_matrix(no, h, V)
    hf_e = float(hf.calc_hf_e(no, 0.0, h, V))

    eps = fock.diagonal().cpu().numpy().copy()
    eps += np.asarray(u.double_contractions_in_3_body())
    e3 = float(u.triple_contractions_in_3_body())

    V = V + on_dev(u.eval_2b_integrals(correlator=u.gaskell,
                                       is_rpa_approx=True))
    eps = on_dev(eps)
    e_mp2, _ = mp2.solve(eps[:no], eps[no:], V[:no, :no, no:, no:],
                         V[no:, no:, :no, :no])
    return hf_e, e3, float(e_mp2)


def main(mesh=3, device="cuda"):
    """Returns (rows, total): per twist (twist, weight, HF, 3-body, MP2),
    and the weighted (HF, 3-body, MP2) sums."""
    dev = resolve_device(device)
    ir_ks, weights = gen_ir_ks(mesh)
    print(f"{mesh}^3 Monkhorst mesh -> {len(ir_ks)} irreducible twists")
    total = np.zeros(3)
    rows = []
    for ks, w in zip(ir_ks, weights):
        hf_e, e3, e_mp2 = tc_mp2(ks, dev)
        total += w * np.array([hf_e, e3, e_mp2])
        rows.append((ks, w, hf_e, e3, e_mp2))
        print(f"  twist {np.round(ks, 3)} (w={w:.4f}): "
              f"HF={hf_e:.8f}  3-body={e3:.8f}  MP2={e_mp2:.8f}")
    print(f"twist-averaged: HF={total[0]:.8f}  3-body={total[1]:.8f}  "
          f"MP2={total[2]:.8f}  total={total.sum():.8f}")
    return rows, total


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mesh", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.mesh, args.device)
