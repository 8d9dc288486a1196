"""What every kind of unit shares: the fixed-count twisted basis, the
seed's twist, the program's inputs of one twist of the gas, host spans
around set-up calls, and a device synchronisation.
"""

import time

import numpy as np

from portbench.reference.ueg import sorted_waves

NEED_HF = ("klij", "aibj", "aijb")
NEED_CC = ("klij", "ijab", "abij", "iajb", "iabj")
NEED_EOM = ("ijka", "ijak", "iajk")


def fixed_cutoff(n_p, twist):
    """The cutoff, in units of (2π/L)²/2, that keeps exactly the ``n_p``
    lowest |n + k_s|²: the midpoint of the gap above the last one kept."""
    _, e = sorted_waves(twist, n_p)
    if not e[n_p] - e[n_p - 1] > 1e-9:
        raise ValueError(f"twist {tuple(twist)} puts plane waves {n_p} and "
                         f"{n_p + 1} at one energy: no cutoff keeps {n_p}")
    return 0.5 * (e[n_p - 1] + e[n_p])


def twist_of(seed, n_p):
    """The seed's own twist: drawn uniformly in [0, 0.25)³ (full doubles,
    so no two plane waves share a kinetic energy), redrawn until a cutoff
    keeps exactly ``n_p`` plane waves.  Every seed gets a basis of the
    same count, so the same shapes (``calibrate.py`` draws the twists of
    its seeds so too)."""
    rng = np.random.default_rng(seed)
    while True:
        tw = [float(x) for x in rng.uniform(0.0, 0.25, 3)]
        try:
            fixed_cutoff(n_p, tw)
            return tw
        except ValueError:
            continue


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Host seconds spent in named calls of the set-up."""

    def __init__(self):
        self.seconds = {}

    def timed(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)
        return out


def gas(cfg, twist, names, device, spans, plans=("virtual",)):
    """The program's inputs of one twist: the integral list, the named
    blocks on ``device``, the canonical HF Fock and the ladder plans."""
    import torch

    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops import ueg_ladder

    n_ele, n_p = cfg["n_ele"], cfg["n_p"]
    no = n_ele // 2
    u = ueg.UEG(n_ele, no, no, cfg["rs"])
    u.init_single_basis(fixed_cutoff(n_p, twist), k_shift=tuple(twist))
    if u.n_spatial != n_p:
        raise RuntimeError(f"basis of {u.n_spatial} plane waves, not {n_p}")
    idx, vals = spans.timed("integrals", u.eval_2b_integrals, sp=2)
    d = spans.timed("blocks", ueg.sparse_to_blocks, idx, vals, n_p, no,
                    names=names, device=device)
    del idx, vals
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], no)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], no, n_p - no)
    out = {"ueg": u, "no": no, "dict": d,
           "fock": torch.diag(torch.cat([eps_i, eps_a])),
           "k_int": np.asarray(u.basis.k_int)}
    for bra in plans:
        out[f"plan_{bra}"] = spans.timed(
            "plans", ueg_ladder.build_block_ladder, u, device=device,
            bra=bra)
    return out
