"""``eom``: one unit is an EOM-CCSD Davidson solve of one twist's gas
(``n_excit`` roots, ``max_dim``, ``e_epsilon``, MOM from unit guesses, at
most ``eom_max_iter`` iterations) on the no-ovvv matrix-free operator of
the CCD amplitudes converged in set-up to ``ground_delta_e``; each solve
starts from its guesses.  The sigma (``_sigma_batched_hbar``: K1 on the
all-bra plan, K4, K5) and K6 do the work.

The check's numbers, each the worst over the sampled twists:

* ``eps_gap``: largest |ε_program − ε_reference| of the orbital energies, Ha;
* ``e_gap``: |E_program − E_reference| of the set-up's ground state, Ha;
* ``root_gap``: largest |ω_program − ω_reference| over every root of every
  solve of the twist in the window, Ha.
"""

import numpy as np
import torch

from portbench import check, common
from portbench.kinds import ccd
from portbench.reference import cc, eom, ueg

NUMBERS = ("eps_gap", "e_gap", "root_gap")
NAMES = common.NEED_CC + common.NEED_HF + common.NEED_EOM
OPERATOR = common.NEED_CC + common.NEED_EOM


def solver(no, device, traffic):
    """An EOM_CCSD of the traffic's settings."""
    from pymes_tpu_torch.solver import eom_ccsd

    s = eom_ccsd.EOM_CCSD(no, device=device, n_excit=traffic["n_excit"])
    s.max_dim = traffic["max_dim"]
    s.e_epsilon = traffic["e_epsilon"]
    s.max_iter = traffic["eom_max_iter"]
    return s


def problem(cfg, tw, traffic, device, spans):
    """A twist's inputs: the CCD ground state on the virtual plan, then
    the no-ovvv operator on the all-bra plan and the OVVV gather plans."""
    from pymes_tpu_torch.ops import ueg_ladder

    g = common.gas(cfg, tw, NAMES, device, spans, plans=("virtual", "all"))
    g["blocks"] = ccd.blocks(g)
    e, T, n, ok = ccd.ground(g, traffic, device, traffic["ground_delta_e"])
    if not ok:
        raise RuntimeError(f"the ground state of twist {tw} did not "
                           f"converge in {n} iterations")
    g["e0"], g["t2"] = e, T
    del g["blocks"], g["plan_virtual"]
    V = {k: g["dict"][k] for k in OPERATOR}
    V["abcd"] = None
    V["abcd_ladder"] = g["plan_all"]
    V["_ovvv_plans"] = spans.timed("plans", ueg_ladder.build_ovvv_plans,
                                   g["ueg"], device=device)
    g["V"] = V
    return g


def setup(cfg, traffic, twists, device, spans):
    probs = [problem(cfg, tw, traffic, device, spans) for tw in twists]
    return {"traffic": traffic, "device": device, "probs": probs,
            "last": [None] * len(probs),
            "solver": solver(probs[0]["no"], device, traffic)}


def unit(state, k):
    g, s = state["probs"][k], state["solver"]
    roots = np.sort(np.real(s.solve(g["fock"], g["V"], g["t2"])))
    common.sync()
    n = int(s.n_iterations)
    state["last"][k] = {"roots": roots}
    return {"roots": roots, "davidson_iters": n,
            "converged": n < s.max_iter}


def answers(state):
    return [{"e": g["e0"], "roots": a["roots"],
             "eps": g["fock"].diagonal().cpu(), "k_int": g["k_int"]}
            for g, a in zip(state["probs"], state["last"])]


def reference(cfg, traffic, twist, device, dtype=torch.float64):
    """The orbital energies, ground state and roots of one twist, worked
    out again from the gas: tight CCD, then the quantwo sigma terms in a
    tight Davidson."""
    gas = ueg.Gas(cfg["n_ele"], cfg["rs"], cfg["n_p"], twist, device, dtype)
    p = cc.Problem(gas, eom.EOM_BLOCKS)
    e, T, _ = cc.solve(p)
    roots, _, _ = eom.davidson(eom.Hbar(p, T), traffic["n_excit"])
    return {"eps": torch.cat([p.eps_i, p.eps_a]).double().cpu(), "e": e,
            "t2": T.double().cpu(), "k_int": gas.n_int, "roots": roots}


def gaps(prog, ref, records):
    ref = ccd.matched(prog, ref)
    if ref is None:
        return {name: float("inf") for name in NUMBERS}
    return {"eps_gap": float((prog["eps"] - ref["eps"]).abs().max()),
            "e_gap": abs(prog["e"] - ref["e"]),
            "root_gap": check.worst(np.max(np.abs(np.sort(r["roots"])
                                                  - ref["roots"]))
                                    for r in records + [prog])}


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
    return gaps(low, ref, [{"roots": low["roots"]}])
