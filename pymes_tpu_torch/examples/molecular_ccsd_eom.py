"""FCIDUMP → HF → CCSD → EOM-CCSD excitation energies.

The canonical molecular workflow, ``examples/molecular_ccsd_eom.py`` of the
JAX package with the import root changed: CCSD to |dE| < 1e-10, a
checkpoint of its amplitudes (when a path is given), then the two lowest
EOM-CCSD roots of the T1-dressed operator.  Runs on the card unless
``device="cpu"``.

    python -m pymes_tpu_torch.examples.molecular_ccsd_eom [FCIDUMP]
        [--device cpu] [--checkpoint ccsd_ckpt]
"""

import argparse
from pathlib import Path

from pymes_tpu_torch.integral.partition import part_2_body_int
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.solver import ccsd, eom_ccsd
from pymes_tpu_torch.util import checkpoint, fcidump

DEFAULT_DUMP = (Path(__file__).resolve().parents[2] / "tests" / "data"
                / "FCIDUMP.LiH.321g")


def main(fcidump_file=DEFAULT_DUMP, checkpoint_path=None, *, device=None):
    """Returns {"hf e", "ccsd e", "iterations", "roots"}; writes the CCSD
    checkpoint to ``checkpoint_path`` (``<path>.npz`` + ``.json``) when
    given."""
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(str(fcidump_file))
    no = n_elec // 2
    print(f"{n_elec} electrons in {n_orb} orbitals")

    hf_e = float(hf.calc_hf_e(no, e_core, h, V, device=device))
    print(f"HF total energy      = {hf_e:.12f}")

    fock = hf.construct_hf_matrix(no, h, V, device=device)
    cc = ccsd.CCSD(no, device=device)
    cc.delta_e = 1e-10
    result = cc.solve(fock, V)
    print(f"CCSD correlation E   = {result['ccsd e']:.12f} "
          f"({len(result['e history'])} iterations)")

    # persist amplitudes for warm starts / later analysis
    if checkpoint_path is not None:
        checkpoint.save(checkpoint_path, checkpoint.from_result(result))

    dict_V = part_2_body_int(no, V)
    f_dressed = cc.get_T1_dressed_fock(fock, result["t1"], dict_V)
    V_dressed = cc.get_T1_dressed_V(result["t1"], dict_V)

    eom = eom_ccsd.EOM_CCSD(no, n_excit=2, device=device)
    excitations = eom.solve(f_dressed, V_dressed, result["t2"])
    for i, e in enumerate(excitations):
        print(f"EOM-CCSD root {i}: {e:.10f} Ha = {e * 27.2114:.4f} eV")
    return {"hf e": hf_e, "ccsd e": result["ccsd e"],
            "iterations": len(result["e history"]),
            "roots": [float(e) for e in excitations]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fcidump", nargs="?", default=str(DEFAULT_DUMP))
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--checkpoint", default="ccsd_ckpt",
                    help="checkpoint base path (<path>.npz + .json)")
    args = ap.parse_args()
    main(args.fcidump, args.checkpoint, device=args.device)
