"""``ccd``: one unit is a matrix-free CCD solve of one twist's gas to
|dE| < ``delta_e`` from the MP2 guess (DIIS 6, ``level_shift``, at most
``max_iter`` iterations), on the virtual ladder plan (K1).

The check's numbers, each the worst over the sampled twists:

* ``eps_gap``: largest |ε_program − ε_reference| of the orbital energies
  (the set-up's integrals, blocks and HF energies), Ha;
* ``e_gap``: largest |E_program − E_reference| of the correlation energy
  over every solve of the twist in the window, Ha;
* ``t_gap``: largest |T_program − T_reference| of the doubles over the
  largest |T_reference|.
"""

import torch

from portbench import check, common
from portbench.reference import cc, ueg

NUMBERS = ("eps_gap", "e_gap", "t_gap")
NAMES = common.NEED_CC + common.NEED_HF


def blocks(g):
    from pymes_tpu_torch.solver import ccd

    d = g["dict"]
    return ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                         iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                         ladder=g["plan_virtual"])


def ground(g, traffic, device, delta_e=None):
    """One converged CCD solve from the MP2 guess; (energy, T [abij],
    iterations, converged)."""
    from pymes_tpu_torch.solver import ccd

    de = traffic["delta_e"] if delta_e is None else delta_e
    s = ccd.CCD(g["no"], device=device)
    res = s.solve(g["fock"], g["blocks"], level_shift=traffic["level_shift"],
                  delta_e=de, max_iter=traffic["max_iter"])
    common.sync()
    n = len(res["e history"])
    ok = n <= traffic["max_iter"] and abs(res["dE"]) <= de
    return res["ccd e"], res["t2 amp"], n, ok


def setup(cfg, traffic, twists, device, spans):
    probs = []
    for tw in twists:
        g = common.gas(cfg, tw, NAMES, device, spans)
        g["blocks"] = blocks(g)
        probs.append(g)
    return {"traffic": traffic, "device": device, "probs": probs,
            "last": [None] * len(probs)}


def unit(state, k):
    e, T, n, ok = ground(state["probs"][k], state["traffic"],
                         state["device"])
    state["last"][k] = {"e": e, "t2": T}
    return {"energy": e, "cc_iters": n, "converged": ok}


def answers(state):
    return [{"e": a["e"], "t2": a["t2"].cpu(),
             "eps": state["probs"][k]["fock"].diagonal().cpu(),
             "k_int": state["probs"][k]["k_int"]}
            for k, a in enumerate(state["last"])]


def reference(cfg, traffic, twist, device, dtype=torch.float64):
    """The orbital energies, energy and amplitudes of one twist, worked out
    again from the gas (a tight Jacobi + DIIS, far past the program's
    stopping test)."""
    gas = ueg.Gas(cfg["n_ele"], cfg["rs"], cfg["n_p"], twist, device, dtype)
    p = cc.Problem(gas, cc.CCD_BLOCKS)
    e, T, _ = cc.solve(p)
    return {"eps": torch.cat([p.eps_i, p.eps_a]).double().cpu(), "e": e,
            "t2": T.double().cpu(), "k_int": gas.n_int}


def matched(prog, ref):
    """``ref`` in the program's orbital order, or None (no match)."""
    m = check.in_program_order(prog, ref)
    return None if m is None else dict(ref, eps=m[0], t2=m[1])


def gaps(prog, ref, records):
    ref = matched(prog, ref)
    if ref is None:
        return {name: float("inf") for name in NUMBERS}
    es = [r["energy"] for r in records] + [prog["e"]]
    big = float(ref["t2"].abs().max())
    return {"eps_gap": float((prog["eps"] - ref["eps"]).abs().max()),
            "e_gap": check.worst(abs(e - ref["e"]) for e in es),
            "t_gap": float((prog["t2"] - ref["t2"]).abs().max()) / big}


def control(cfg, traffic, twist, device):
    """The reference computed in float32 (full f32 products, no TF32),
    judged as the program's answers against the reference in float64."""
    ref = reference(cfg, traffic, twist, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        low = reference(cfg, traffic, twist, device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return gaps(low, ref, [{"energy": low["e"]}])
