"""CIF real-time EOM-CCSD dynamics: propagate a state and record the
autocorrelation c(t) = <u(0), u(t)>, ``examples/rt_autocorrelation.py``
of the JAX package with the import root changed (H₂/STO-6G, CCSD to
|dE| < 1e-12, a seeded singles state, 32 contour nodes).  Runs on the
card unless ``device="cpu"``.

    python -m pymes_tpu_torch.examples.rt_autocorrelation [nt=50] [dt=0.1]
        [--device cpu] [--out ct.npy]

Writes ``out`` with columns (t, Re c, Im c).
"""

import argparse
from pathlib import Path

import numpy as np

from pymes_tpu_torch.integral.partition import part_2_body_int
from pymes_tpu_torch.mean_field import hf
from pymes_tpu_torch.solver import ccsd
from pymes_tpu_torch.solver.rt_eom_ccsd import RT_EOM_CCSD
from pymes_tpu_torch.util import fcidump

DUMP = (Path(__file__).resolve().parents[2] / "tests" / "data"
        / "FCIDUMP.H2.sto6g")


def main(nt=50, dt=0.1, out="ct.npy", *, device=None):
    """Returns (t, c_t) and writes them to ``out`` (when not None)."""
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(str(DUMP))
    no = n_elec // 2

    fock = hf.construct_hf_matrix(no, h, V, device=device)
    cc = ccsd.CCSD(no, device=device)
    result = cc.solve(fock, V, delta_e=1e-12, max_iter=100)
    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, result["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(result["t1"], dict_V)
    T2 = result["t2"]
    nv = T2.shape[0]

    rng = np.random.default_rng(0)
    u1_0 = rng.random((nv, no)) - 0.5
    u2_0 = np.zeros((nv, nv, no, no))
    norm = np.sqrt(np.sum(u1_0 ** 2))
    u1_0 /= norm

    rt = RT_EOM_CCSD(no, e_c=0.5, e_r=0.6, n_quad=32, device=device)
    rt.ls_max_iter = 100

    t = np.arange(1, nt + 1) * dt
    c_t = np.zeros(nt, dtype=complex)
    u1, u2 = u1_0.astype(complex), u2_0.astype(complex)
    for n in range(nt):
        u1, u2 = rt.solve(fd, Vd, T2, dt=dt, u_singles=u1, u_doubles=u2)
        c_t[n] = (np.tensordot(u1_0, u1, axes=2)
                  + np.tensordot(u2_0, u2, axes=4))
        print(f"t = {t[n]:6.2f}   c(t) = {c_t[n]:.6f}")
    if out is not None:
        np.save(out, np.column_stack((t, c_t.real, c_t.imag)))
        print(f"wrote {out}")
    return t, c_t


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nt", nargs="?", type=int, default=50)
    ap.add_argument("dt", nargs="?", type=float, default=0.1)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default="ct.npy")
    args = ap.parse_args()
    main(args.nt, args.dt, args.out, device=args.device)
