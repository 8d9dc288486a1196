#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pymes_tpu_torch``) on one GPU.

Drives the port's main paths through its own kernels:

* CCD — UEG 14 electrons, rs = 0.5: integrals → named o/v blocks on the
  card → HF orbital energies → momentum-sector ladder plan → MP2 guess →
  matrix-free CCD to |dE| < 1e-8, at cutoff 5 (nP=57) and cutoff 14
  (nP=219);
* dense CCSD — LiH/3-21G, H₂/STO-6G, and the transcorrelated TC-LiH and
  TC-H₂ (FCIDUMP ``.tc`` + TCDUMP through the port's readers and
  contractions), each against its oracle;
* matrix-free CCSD at nP=219 — all-bra ladder plan + OVVV gather plans, no
  ``abcd`` and no ovvv-class block on the card: the canonical Fock (T1 ≡ 0,
  so E equals the CCD energy) and the seeded non-canonical Fock (T1 ≠ 0,
  against the JAX package's energy for the same system);
* EOM-CCSD — the matrix-free no-ovvv operator (all-bra ladder, OVVV plans,
  no ``abcd``/ovvv block), n_excit=2, max_dim=16, f64 with MOM root
  tracking from unit-vector guesses: nP=57 and nP=219 on the CCD
  amplitudes of phase 3/4, nP=219 on the canonical CCSD amplitudes of
  phase 7, each against the JAX package's roots and iteration count; and
  LiH/3-21G on the dressed CCSD operator against its oracle.

Kernels: K1 ``block_ladder`` (CUDA C++, built with nvcc for sm_90a at first
use); K2 ``ccd_jacobi_diis``, K3 ``ccd_mix_energy``, K4 ``ovvv_gather``,
K2′ ``ccsd_jacobi_diis``, K3′ ``ccsd_mix_energy``, K5 ``pair_symmetrize``
and K6 ``davidson_residual`` (Triton).

Phases: (0) card and versions; (1) kernel builds; (2) each kernel against
its plain twin on the card at the main paths' shapes (K2′/K3′ at nP=219
and at each molecule's; K5 at the CCD and the EOM shapes, K6 and the
batched K1/K4 entries at the nP=219 EOM shapes), seeded inputs, bound
max|kernel − twin| ≤ 1e-12·max|twin| (both f64, only the summation order
differs); (3, 4) the converged CCD solves; (6) the dense molecular CCSD
solves; (7) the matrix-free CCSD solves; (9) the EOM solves (the LiH
ground state they dress is solved before) — for each path the launch
counts are reset just before and read just after, and each EOM solve's
launches must match its count of sigma calls exactly; (5, 8, 10)
timing: kernel vs twin per call, ms/iteration of fixed-61-iteration CCD and
CCSD solves (min of 5) and of 8 Davidson iterations at nP=219, through the
kernels and through the twins.  Prints a JSON line of the kernels, the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits nonzero; without CUDA it
exits nonzero at once.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb", "ijka",
        "ijak", "iajk")
# converged CCD energies of the JAX package (f64, CPU) and the reference
# oracle (BASELINE.md)
E_JAX = {5: -0.5120153543911, 14: -0.5767206765319}
ORACLE_NP57 = -0.5120153512190824
# matrix-free CCSD of the JAX package (f64, CPU) at nP=219 with the seeded
# non-canonical Fock of setup_ccsd (level shift -1, |dE| < 1e-10): 11
# iterations, |T1|max = 0.01188
E_JAX_CCSD_NONCANONICAL = -0.664928068966791
N_IT_JAX_CCSD_NONCANONICAL = 11
# EOM-CCSD of the JAX package on a CPU: its f64 path (precision="f64",
# root_tracking="guess", contract_mode="xla", n_excit=2, max_dim=16,
# unit-vector guesses) on the matrix-free no-ovvv operator and the mf-CCD
# amplitudes of benchmarks/_setup.build_ueg_mf(cutoff, contract_mode="xla")
# (and at nP=219 also on its canonical mf-CCSD amplitudes): sorted roots
# and iteration counts
EOM_JAX = {5: ((5.2429519002247345, 5.2429519002247424), 10),
           14: ((5.239661269908714, 5.239701177870126), 9)}
EOM_JAX_CCSD_AMPS_NP219 = ((5.239661269908716, 5.239701177870117), 9)
EOM_RECORDED_NP219 = (5.2396613, 5.2397012)   # benchmarks/RESULTS.md:491
LIH_EOM_ORACLE = (0.1180867117168979, 0.154376205595602)   # BASELINE.md
EOM_KEYS = ("klij", "ijab", "abij", "iajb", "iabj", "ijka", "ijak", "iajk")
DATA = Path(__file__).resolve().parent / "tests" / "data"
# dense molecular CCSD: (FCIDUMP, TCDUMP or None, oracle correlation
# energy, oracle HF energy or None, tolerance) — BASELINE.md and
# tests/test_tc_ccsd.py
MOLECULES = {
    "LiH": ("FCIDUMP.LiH.321g", None, -0.01908832712812761,
            -7.92958534362757, 1e-8),
    "H2": ("FCIDUMP.H2.sto6g", None, -0.1012250926230937, None, 1e-8),
    "TC-LiH": ("FCIDUMP.LiH.tc", "TCDUMP.LiH_FNO", -0.010563160683828635,
               -8.044059106879612, 1e-7),
    "TC-H2": ("FCIDUMP.H2.tc", "TCDUMP.H2.tc", -0.005914233662984753,
              -1.166009516046628, 1e-7),
}
REL_TOL = 1e-12
KERNELS = {
    "block_ladder": ("cuda", "pymes_tpu_torch/csrc/block_ladder.cu",
                     "pymes_tpu/ops/ueg_ladder.py:450"),
    "ccd_jacobi_diis": ("triton", "pymes_tpu_torch/kernels/ccd_tail.py",
                        "pymes_tpu/solver/ccd.py:525"),
    "ccd_mix_energy": ("triton", "pymes_tpu_torch/kernels/ccd_tail.py",
                       "pymes_tpu/mixer/diis.py:107"),
    "ovvv_gather": ("triton", "pymes_tpu_torch/kernels/ovvv_gather.py",
                    "pymes_tpu/ops/ueg_ladder.py:150"),
    "ccsd_jacobi_diis": ("triton", "pymes_tpu_torch/kernels/ccsd_tail.py",
                         "pymes_tpu/solver/ccsd.py:615"),
    "ccsd_mix_energy": ("triton", "pymes_tpu_torch/kernels/ccsd_tail.py",
                        "pymes_tpu/solver/ccsd.py:393"),
    "pair_symmetrize": ("triton", "pymes_tpu_torch/kernels/pair_sym.py",
                        "pymes_tpu/solver/ccd.py:349"),
    "davidson_residual": ("triton", "pymes_tpu_torch/kernels/davidson.py",
                          "pymes_tpu/solver/eom_ccsd.py:697"),
}
CCD_KERNELS = ("block_ladder", "ccd_jacobi_diis", "ccd_mix_energy",
               "pair_symmetrize")
DENSE_CCSD_KERNELS = ("ccsd_jacobi_diis", "ccsd_mix_energy",
                      "pair_symmetrize")
MF_CCSD_KERNELS = ("block_ladder", "ovvv_gather", "ccsd_jacobi_diis",
                   "ccsd_mix_energy", "pair_symmetrize")
EOM_KERNELS = ("block_ladder", "ovvv_gather", "pair_symmetrize",
               "davidson_residual")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def setup(cutoff, device):
    import torch

    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops.ueg_ladder import build_block_ladder
    from pymes_tpu_torch.solver import ccd, mp2

    t0 = time.time()
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(cutoff)
    idx, vals = u.eval_2b_integrals(sp=2)
    n_p = u.n_spatial
    d = ueg.sparse_to_blocks(idx, vals, n_p, NO, device, names=NEED)
    kin = u.kinetic_energies()
    eps_i = hf.calcOccupiedOrbE(kin, d["klij"], NO)
    eps_a = hf.calcVirtualOrbE(kin, d["aibj"], d["aijb"], NO, n_p - NO)
    fock = torch.diag(torch.cat([eps_i, eps_a]))
    plan = build_block_ladder(u, device)
    blocks = ccd.CCDBlocks(klij=d["klij"], ijab=d["ijab"], abij=d["abij"],
                           iajb=d["iajb"], iabj=d["iabj"], abcd=None,
                           ladder=plan)
    _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
    torch.cuda.synchronize()
    buckets = ", ".join("{}x{}x{}".format(*g.blocks.shape)
                        for g in plan.groups)
    print(f"setup cutoff {cutoff}: nP={n_p} nnz={len(vals)} "
          f"buckets [{buckets}] ({time.time() - t0:.2f} s)", flush=True)
    return {"cutoff": cutoff, "nP": n_p, "nv": n_p - NO, "fock": fock,
            "blocks": blocks, "T0": T0, "eps_i": eps_i, "eps_a": eps_a,
            "ueg": u, "dict": d}


def setup_ccsd(p, device):
    """The matrix-free CCSD inputs on top of a CCD set-up: the all-bra
    ladder plan, the OVVV gather plans, the V dict (no abcd, no ovvv-class
    block), the canonical Fock and the seeded non-canonical one (noise
    rng(5)·0.02, symmetrised), and the MP2 guess of each."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder
    from pymes_tpu_torch.solver import mp2

    t0 = time.time()
    u, n_p = p["ueg"], p["nP"]
    d = dict(p["dict"])
    d["_ovvv_plans"] = ueg_ladder.build_ovvv_plans(u, device)
    plan = ueg_ladder.build_block_ladder(u, device, bra="all")
    eps = torch.cat([p["eps_i"], p["eps_a"]]).cpu().numpy()
    noise = np.random.default_rng(5).standard_normal((n_p, n_p)) * 0.02
    focks = {"canonical": p["fock"],
             "non-canonical": torch.as_tensor(
                 np.diag(eps) + noise + noise.T, device=p["fock"].device)}
    T0 = {}
    for kind, f in focks.items():
        diag = torch.diagonal(f)
        T0[kind] = mp2.solve(diag[:NO], diag[NO:], d["ijab"], d["abij"],
                             -1.0)[1]
    torch.cuda.synchronize()
    print(f"setup CCSD nP={n_p}: all-bra plan n_bra={plan.n_bra}, OVVV "
          f"plans {sorted(d['_ovvv_plans'])} "
          f"({time.time() - t0:.2f} s)", flush=True)
    return {**p, "plan_all": plan, "mf_dict": d, "focks": focks,
            "T2_0": T0}


def inputs(p, seed):
    """Seeded amplitudes/residual, DIIS rings and coefficients at the
    shapes the main path gives the kernels."""
    import torch

    rng = np.random.default_rng(seed)
    nv, dev = p["nv"], p["fock"].device
    shape = (NO, NO, nv, nv)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    n = NO * NO * nv * nv
    return {"T": t(rng.standard_normal(shape) * 0.01),
            "R": t(rng.standard_normal(shape) * 0.01),
            "errs": t(rng.standard_normal((6, n)) * 0.01),
            "amps": t(rng.standard_normal((6, n)) * 0.01),
            "coeff": t(rng.standard_normal(6))}


def rel_err(got, want, what):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # a zero reference would pass any kernel: every compared output must
    # carry signal
    check(scale > 0, f"{what}: the twin's output is all zero")
    check(err <= REL_TOL * scale,
          f"{what}: max|kernel - twin| = {err:.3e} > {REL_TOL} * {scale:.3e}")
    return err


def compare_kernels(p, seed):
    """Each kernel vs its twin on the card; returns max abs errors."""
    from pymes_tpu_torch.kernels import ccd_tail
    from pymes_tpu_torch.ops.ueg_ladder import block_ladder_apply_ij

    x = inputs(p, seed)
    plan, V = p["blocks"].ladder, p["blocks"].ijab.contiguous()
    Vx = V.transpose(2, 3).contiguous()
    errs = {}
    got = block_ladder_apply_ij(plan, x["T"])
    want = block_ladder_apply_ij(plan, x["T"], twin=True)
    errs["block_ladder"] = rel_err(got, want, "block_ladder")

    e_k2 = 0.0
    for slot, n_valid in ((0, 1), (2, 6)):   # first insertion; full ring
        rings = [(x["errs"].clone(), x["amps"].clone()) for _ in range(2)]
        rows = [ccd_tail.jacobi_diis_insert(
            x["R"], x["T"], p["eps_i"], p["eps_a"], -1.0, e, a, slot,
            n_valid, twin=tw) for (e, a), tw in zip(rings, (False, True))]
        e_k2 = max(e_k2, rel_err(rows[0], rows[1], "K2 Gram row"),
                   rel_err(rings[0][0], rings[1][0], "K2 error ring"),
                   rel_err(rings[0][1], rings[1][1], "K2 amplitude ring"))
    errs["ccd_jacobi_diis"] = e_k2

    e_k3 = 0.0
    for n_valid in (1, 6):
        Ts = [x["T"].clone() for _ in range(2)]
        es = [ccd_tail.diis_mix_energy(x["amps"], x["coeff"], n_valid, T,
                                       V, Vx, twin=tw)
              for T, tw in zip(Ts, (False, True))]
        e_k3 = max(e_k3, rel_err(Ts[0], Ts[1], "K3 mixed amplitudes"),
                   *(rel_err(a, b, "K3 energy") for a, b in zip(*es)))
    errs["ccd_mix_energy"] = e_k3
    print(f"kernel vs twin, nP={p['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def cuda_ms(fn, n=20, warmup=3):
    """Mean device time of ``fn`` over ``n`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernels(p, seed):
    """ms per call of each kernel and of its twin, at the main path's
    shapes (plain, kernel, kernel, plain; the mean of each pair)."""
    from pymes_tpu_torch.kernels import ccd_tail
    from pymes_tpu_torch.ops.ueg_ladder import block_ladder_apply_ij

    x = inputs(p, seed)
    plan, V = p["blocks"].ladder, p["blocks"].ijab.contiguous()
    Vx = V.transpose(2, 3).contiguous()
    calls = {
        "block_ladder": lambda tw: block_ladder_apply_ij(plan, x["T"],
                                                         twin=tw),
        "ccd_jacobi_diis": lambda tw: ccd_tail.jacobi_diis_insert(
            x["R"], x["T"], p["eps_i"], p["eps_a"], -1.0, x["errs"],
            x["amps"], 2, 6, twin=tw),
        "ccd_mix_energy": lambda tw: ccd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R"], V, Vx, twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    return out


def tail_inputs(no, V, seed):
    """Seeded T1/T2/residuals, the CCSD DIIS rings over [T1 | T2],
    coefficients and a one-body operand F1 = f_ovᵀ at the shapes of one
    CCSD path: ``no`` occupied orbitals, ``V`` its V_ijab block.  F1 is
    seeded too, since a canonical Fock has f_ov = 0 and would leave K3′'s
    one-body energy unchecked."""
    import torch

    rng = np.random.default_rng(seed)
    nv, dev = V.shape[2], V.device
    n = nv * no + no * no * nv * nv

    def t(shape, scale=0.01):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float64, device=dev)

    V = V.contiguous()
    return {"T1": t((nv, no)), "R1": t((nv, no)),
            "T2": t((no, no, nv, nv)), "R2": t((no, no, nv, nv)),
            "errs": t((6, n)), "amps": t((6, n)), "coeff": t(6, 1.0),
            "F1": t((nv, no), 0.1), "V": V,
            "Vx": V.transpose(2, 3).contiguous()}


def compare_ccsd_tail(x, eps_i, eps_a, label):
    """K2′ and K3′ vs their twins on the inputs of :func:`tail_inputs`:
    slot 0 with n_valid 1 (first insertion) and slot 2 with n_valid 6
    (full ring); returns their max abs errors."""
    from pymes_tpu_torch.kernels import ccsd_tail

    e_k2 = 0.0
    for slot, n_valid in ((0, 1), (2, 6)):
        rings = [(x["errs"].clone(), x["amps"].clone()) for _ in range(2)]
        rows = [ccsd_tail.jacobi_diis_insert(
            x["R1"], x["T1"], x["R2"], x["T2"], eps_i, eps_a, -1.0, e, a,
            slot, n_valid, twin=tw)
            for (e, a), tw in zip(rings, (False, True))]
        e_k2 = max(e_k2,
                   rel_err(rows[0], rows[1], f"K2' Gram row, {label}"),
                   rel_err(rings[0][0], rings[1][0],
                           f"K2' error ring, {label}"),
                   rel_err(rings[0][1], rings[1][1],
                           f"K2' amplitude ring, {label}"))

    e_k3 = 0.0
    for n_valid in (1, 6):
        Ts = [(x["T1"].clone(), x["T2"].clone()) for _ in range(2)]
        es = [ccsd_tail.diis_mix_energy(x["amps"], x["coeff"], n_valid, T1,
                                        T2, x["F1"], x["V"], x["Vx"],
                                        twin=tw)
              for (T1, T2), tw in zip(Ts, (False, True))]
        e_k3 = max(e_k3, rel_err(Ts[0][0], Ts[1][0], f"K3' mixed T1, {label}"),
                   rel_err(Ts[0][1], Ts[1][1], f"K3' mixed T2, {label}"),
                   *(rel_err(a, b, f"K3' energy {piece}, {label}")
                     for piece, a, b in zip(("e_1b", "e_dir", "e_exc"),
                                            *es)))
    return e_k2, e_k3


def compare_ccsd_kernels(q, seed):
    """K4, K2′/K3′ and K1 with the stacked CCSD operand vs their twins on
    the card at nP=219; returns max abs errors."""
    import torch

    from pymes_tpu_torch.ops import ueg_ladder

    x = tail_inputs(NO, q["dict"]["ijab"], seed)
    errs = {}
    e_k4 = 0.0
    for pat, plan in q["mf_dict"]["_ovvv_plans"].items():
        got = ueg_ladder.ovvv_t1_apply_j(plan, x["T1"])
        want = ueg_ladder.ovvv_t1_apply_j(plan, x["T1"], twin=True)
        e_k4 = max(e_k4, rel_err(got, want, f"K4 {pat}"))
    errs["ovvv_gather"] = e_k4
    errs["ccsd_jacobi_diis"], errs["ccsd_mix_energy"] = compare_ccsd_tail(
        x, q["eps_i"], q["eps_a"], f"nP={q['nP']}")

    X = torch.einsum("ci,dj->ijcd", x["T1"], x["T1"])
    TX = torch.stack([x["T2"].reshape(NO * NO, q["nv"], q["nv"]),
                      X.reshape(NO * NO, q["nv"], q["nv"])])
    errs["block_ladder"] = rel_err(
        ueg_ladder.block_ladder_apply_ij(q["plan_all"], TX),
        ueg_ladder.block_ladder_apply_ij(q["plan_all"], TX, twin=True),
        "K1 stacked (2 no^2, nv^2) operand, all-bra plan")
    print(f"kernel vs twin, CCSD nP={q['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def time_ccsd_kernels(q, seed):
    """ms per call of K4 (mean over the three plans), K2′ and K3′ and of
    their twins at nP=219 (plain, kernel, kernel, plain)."""
    from pymes_tpu_torch.kernels import ccsd_tail
    from pymes_tpu_torch.ops import ueg_ladder

    x = tail_inputs(NO, q["dict"]["ijab"], seed)
    plans = list(q["mf_dict"]["_ovvv_plans"].values())
    calls = {
        "ovvv_gather": lambda tw: [ueg_ladder.ovvv_t1_apply_j(
            plan, x["T1"], twin=tw) for plan in plans],
        "ccsd_jacobi_diis": lambda tw: ccsd_tail.jacobi_diis_insert(
            x["R1"], x["T1"], x["R2"], x["T2"], q["eps_i"], q["eps_a"],
            -1.0, x["errs"], x["amps"], 2, 6, twin=tw),
        "ccsd_mix_energy": lambda tw: ccsd_tail.diis_mix_energy(
            x["amps"], x["coeff"], 6, x["R1"], x["R2"], x["F1"], x["V"],
            x["Vx"], twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        per = len(plans) if name == "ovvv_gather" else 1
        out[name] = ((t[1] + t[2]) / 2 / per, (t[0] + t[3]) / 2 / per)
    return out


def solve_ccsd_fixed(q, twin, max_iter=60):
    """ms/iteration of ``max_iter + 1`` matrix-free CCSD iterations with the
    non-canonical Fock (host clock, synchronised)."""
    import torch

    from pymes_tpu_torch.solver import ccsd

    fock = q["focks"]["non-canonical"]
    T1 = torch.zeros((q["nv"], NO), dtype=torch.float64, device=fock.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ccsd.ccsd_solve(fock, q["mf_dict"], NO, T1,
                          q["T2_0"]["non-canonical"], level_shift=-1.0,
                          delta_e=-1.0, max_iter=max_iter,
                          ladder_all=q["plan_all"], twin=twin)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / out[4], out[4]


def load_molecule(name, device):
    """(no, Fock, V, HF energy, solve options) of one molecule of
    ``MOLECULES`` through the port's own FCIDUMP and TCDUMP readers and
    3-body contractions, on ``device``."""
    import torch

    from pymes_tpu_torch.integral import contraction
    from pymes_tpu_torch.mean_field import hf
    from pymes_tpu_torch.util import fcidump, tcdump

    fdump, tdump = MOLECULES[name][:2]
    n_elec, _, e_core, _, h, V = fcidump.read(str(DATA / fdump),
                                              is_tc=tdump is not None)
    no = n_elec // 2
    h = torch.as_tensor(h, device=device)
    Vt = torch.as_tensor(V, device=device)
    hf_e = float(hf.calc_hf_e(no, e_core, h, Vt))
    fock = hf.construct_hf_matrix(no, h, Vt)
    kw = {}
    if tdump is not None:
        L = tcdump.read(str(DATA / tdump))
        hf_e += contraction.get_triple_contraction(no, L)
        fock = fock + torch.as_tensor(
            contraction.get_double_contraction(no, L), device=device)
        Vt = Vt + torch.as_tensor(
            contraction.get_single_contraction(no, L), device=device)
        kw["delta_e"] = 1e-11
    return {"no": no, "fock": fock, "V": Vt, "hf_e": hf_e, "kw": kw}


def compare_molecular_kernels(mols, seed):
    """K2′/K3′ vs their twins at each molecule's shapes (e.g. LiH/3-21G
    no=2, nv=9; H₂/STO-6G no=1, nv=1, so one program holds both segments),
    with the molecule's orbital energies and V_ijab; returns max abs
    errors."""
    e_k2 = e_k3 = 0.0
    for name, m in mols.items():
        no = m["no"]
        eps = m["fock"].diagonal()
        x = tail_inputs(no, m["V"][:no, :no, no:, no:], seed)
        k2, k3 = compare_ccsd_tail(x, eps[:no].contiguous(),
                                   eps[no:].contiguous(), name)
        print(f"kernel vs twin, {name} (no={no}, nv={x['T1'].shape[0]}): "
              f"ccsd_jacobi_diis max_abs_err={k2:.3e}, ccsd_mix_energy "
              f"max_abs_err={k3:.3e}", flush=True)
        e_k2, e_k3 = max(e_k2, k2), max(e_k3, k3)
    return {"ccsd_jacobi_diis": e_k2, "ccsd_mix_energy": e_k3}


def molecular_ccsd(mols, device):
    """Dense CCSD on the four molecules of :func:`load_molecule`, each
    against its oracle."""
    import torch

    from pymes_tpu_torch.solver import ccsd

    for name, m in mols.items():
        e_ref, hf_ref, tol = MOLECULES[name][2:]
        t0 = time.time()
        no, fock, hf_e = m["no"], m["fock"], m["hf_e"]
        if hf_ref is not None:
            check(abs(hf_e - hf_ref) <= 1e-8,
                  f"{name}: HF {hf_e} vs oracle {hf_ref}")
        res = ccsd.CCSD(no, device).solve(fock, m["V"], **m["kw"])
        e = res["ccsd e"]
        check(bool(torch.isfinite(res["t2"]).all())
              and res["t1"].shape == (fock.shape[0] - no, no),
              f"{name}: amplitudes not finite or of the wrong shape")
        check(abs(e - e_ref) <= tol,
              f"{name}: CCSD E={e} vs oracle {e_ref} (tol {tol})")
        print(f"CCSD {name}: E={e:.13f} in {len(res['e history'])} "
              f"iterations, |E - oracle|={abs(e - e_ref):.2e} (tol {tol})"
              + (f", HF |E - oracle|={abs(hf_e - hf_ref):.2e}"
                 if hf_ref is not None else "")
              + f", {time.time() - t0:.2f} s", flush=True)


def mf_ccsd(q, device):
    """Matrix-free CCSD at nP=219: canonical (T1 ≡ 0, E = the CCD energy)
    and the seeded non-canonical Fock (against the JAX package); returns
    each solve's result by kind."""
    import torch

    from pymes_tpu_torch.solver import ccsd

    out = {}
    for kind, fock in q["focks"].items():
        t0 = time.time()
        res = out[kind] = ccsd.CCSD(NO, device).solve(
            fock, q["mf_dict"], level_shift=-1.0, ladder=q["plan_all"],
            delta_e=1e-10 if kind == "non-canonical" else 1e-8,
            max_iter=100)
        e, n_it = res["ccsd e"], len(res["e history"])
        t1max = float(res["t1"].abs().max())
        check(res["t2"].shape == (q["nv"], q["nv"], NO, NO)
              and bool(torch.isfinite(res["t2"]).all())
              and bool(torch.isfinite(res["t1"]).all()),
              f"mf-CCSD {kind}: amplitudes not finite or of the wrong shape")
        if kind == "canonical":
            ref = E_JAX[q["cutoff"]]
            check(t1max <= 1e-12, f"canonical |T1|max = {t1max:.3e}")
        else:
            ref = E_JAX_CCSD_NONCANONICAL
            check(t1max > 1e-4, f"non-canonical |T1|max = {t1max:.3e}")
            check(n_it == N_IT_JAX_CCSD_NONCANONICAL,
                  f"non-canonical took {n_it} iterations, the JAX package "
                  f"{N_IT_JAX_CCSD_NONCANONICAL}")
        check(abs(e - ref) <= 1e-9,
              f"mf-CCSD {kind} nP={q['nP']}: E={e:.13f} vs {ref}")
        print(f"mf-CCSD {kind} nP={q['nP']}: E={e:.13f} in {n_it} "
              f"iterations, |E - ref|={abs(e - ref):.2e}, |T1|max="
              f"{t1max:.3e}, {time.time() - t0:.2f} s", flush=True)
    return out


def eom_operator(p, device, plan_all=None, plans=None):
    """The matrix-free no-ovvv EOM operator of one UEG set-up: the small
    blocks, no ``abcd``, the all-bra ladder plan and the OVVV plans."""
    from pymes_tpu_torch.ops import ueg_ladder

    V = {k: p["dict"][k] for k in EOM_KEYS}
    V["abcd"] = None
    V["abcd_ladder"] = plan_all or ueg_ladder.build_block_ladder(
        p["ueg"], device, bra="all")
    V["_ovvv_plans"] = plans or ueg_ladder.build_ovvv_plans(p["ueg"], device)
    return V


def eom_inputs(V, nv, seed):
    """Seeded K5/K6 operands and a trial batch at the EOM shapes of one
    set-up (n_excit = 2, max_dim = 16): X, Y (2, nv, nv, no, no), the
    Davidson buffers U, W (16, N) with v (16, 2), e (2,) and diag (N,)
    (three denominators inside the clamp), U1 (2, nv, no)."""
    import torch

    rng = np.random.default_rng(seed)
    dev = V["ijab"].device
    N = nv * NO + nv * nv * NO * NO

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float64, device=dev)

    e = t(2) + 5.0
    diag = t(N) + 5.0
    diag[:3] = e[0] + torch.tensor([0.0, 3e-6, -4e-6], dtype=torch.float64,
                                   device=dev)
    return {"X": t((2, nv, nv, NO, NO), 0.01), "Y": t((2, nv, nv, NO, NO),
                                                      0.01),
            "U": t((16, N)), "W": t((16, N)), "v": t((16, 2)), "e": e,
            "diag": diag, "U1": t((2, nv, NO))}


def compare_eom_kernels(q, V, seed):
    """K5 at the CCD (ijab, with Y) and the EOM (abij batch of 2, with and
    without Y) shapes, K6 at the EOM buffer shapes (all 16 rows and 9), and
    the batched cd-major K1 and batched K4 entries, against their twins at
    nP=219; returns max abs errors."""
    from pymes_tpu_torch.kernels import davidson, pair_sym
    from pymes_tpu_torch.ops import ueg_ladder

    x = eom_inputs(V, q["nv"], seed)
    ij = inputs(q, seed)
    e5 = max(rel_err(pair_sym.pair_symmetrize(ij["T"], ij["R"]),
                     pair_sym.pair_symmetrize(ij["T"], ij["R"], twin=True),
                     "K5 ijab with Y"),
             *(rel_err(pair_sym.pair_symmetrize(x["X"], Y),
                       pair_sym.pair_symmetrize(x["X"], Y, twin=True),
                       f"K5 abij batch, Y={Y is not None}")
               for Y in (None, x["Y"])))
    e6 = 0.0
    for m in (16, 9):
        U, W = x["U"].clone(), x["W"].clone()
        U[m:], W[m:] = 0.0, 0.0
        v = x["v"].clone()
        v[m:] = 0.0
        args = (U, W, v, x["e"], x["diag"], m)
        got = davidson.davidson_residual(*args)
        want = davidson.davidson_residual(*args, twin=True)
        # the three clamped columns are ~1e5 larger than the rest: each
        # part is held to 1e-12 of its own scale
        e6 = max(e6, rel_err(got[:, :3], want[:, :3],
                             f"K6 m={m}, clamped columns"),
                 rel_err(got[:, 3:], want[:, 3:], f"K6 m={m}, the rest"))
    e1 = rel_err(ueg_ladder.ladder_apply(V["abcd_ladder"], x["X"]),
                 ueg_ladder.ladder_apply(V["abcd_ladder"], x["X"],
                                         twin=True),
                 "K1 cd-major batch (nv^2, 2 no^2)")
    e4 = max(rel_err(ueg_ladder.ovvv_t1_apply(plan, x["U1"]),
                     ueg_ladder.ovvv_t1_apply(plan, x["U1"], twin=True),
                     f"K4 batched {pat}")
             for pat, plan in V["_ovvv_plans"].items())
    errs = {"pair_symmetrize": e5, "davidson_residual": e6,
            "block_ladder": e1, "ovvv_gather": e4}
    print(f"kernel vs twin, EOM nP={q['nP']}: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def time_eom_kernels(q, V, seed):
    """ms per call of K5 (abij batch of 2, the EOM sigma's operand; and
    ijab with Y, the CCD/CCSD residual's) and K6 (16 valid rows, k = 2)
    and of their twins at nP=219 (plain, kernel, kernel, plain)."""
    from pymes_tpu_torch.kernels import davidson, pair_sym

    x = eom_inputs(V, q["nv"], seed)
    ij = inputs(q, seed)
    calls = {
        "pair_symmetrize": lambda tw: pair_sym.pair_symmetrize(x["X"],
                                                               twin=tw),
        "pair_symmetrize ijab+Y": lambda tw: pair_sym.pair_symmetrize(
            ij["T"], ij["R"], twin=tw),
        "davidson_residual": lambda tw: davidson.davidson_residual(
            x["U"], x["W"], x["v"], x["e"], x["diag"], 16, twin=tw),
    }
    out = {}
    for name, fn in calls.items():
        t = [cuda_ms(lambda: fn(tw)) for tw in (True, False, False, True)]
        out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    return out


def eom_solver(no, device):
    """An EOM_CCSD (n_excit = 2, the defaults: max_dim 16, f64, MOM) that
    counts in ``n_sigma`` the calls of the ``_batched_sigma`` hook, which
    every sigma of a solve goes through."""
    from pymes_tpu_torch.solver import eom_ccsd

    class Counted(eom_ccsd.EOM_CCSD):
        n_sigma = 0

        def _batched_sigma(self, *args):
            self.n_sigma += 1
            return super()._batched_sigma(*args)

    return Counted(no, device, n_excit=2)


def eom_solve(fock, V, T2, device, max_iter=300, twin=False, eps=None,
              no=NO):
    """EOM-CCSD through :func:`eom_solver`; returns the solver and its
    sorted real roots."""
    solver = eom_solver(no, device)
    solver.max_iter = max_iter
    solver.twin = twin
    if eps is not None:
        solver.e_epsilon = eps
    roots = np.sort(np.real(solver.solve(fock, V, T2)))
    return solver, roots


def lih_dressed(m, device):
    """The LiH EOM input: converged CCSD (|dE| < 1e-12), then the
    T1-dressed Fock and operator; returns (Fock, V, T2)."""
    from pymes_tpu_torch.integral.partition import part_2_body_int
    from pymes_tpu_torch.solver import ccsd

    cc = ccsd.CCSD(m["no"], device)
    res = cc.solve(m["fock"], m["V"], delta_e=1e-12, max_iter=200)
    dV = part_2_body_int(m["no"], m["V"])
    return (cc.get_T1_dressed_fock(m["fock"], res["t1"], dV),
            cc.get_T1_dressed_V(res["t1"], dV,
                                {k: None for k in ccsd.EOM_DRESSED}),
            res["t2"])


def check_eom_launches(label, before, solver, ladder):
    """The launches of one EOM solve against its count n of sigma calls:
    K5 once per sigma; K6 n − 1 times (each Davidson step ends in one
    sigma, and the solve's first sigma precedes every step); on the
    matrix-free operator (``ladder``) K1 once per sigma plus once for
    H̄'s W_laji, and K4 three times per sigma (ovv, vov, vvo)."""
    from pymes_tpu_torch import kernels

    n = solver.n_sigma
    got = {k: kernels.LAUNCHES[k] - before[k] for k in EOM_KERNELS}
    want = {"block_ladder": n + 1 if ladder else 0,
            "ovvv_gather": 3 * n if ladder else 0,
            "pair_symmetrize": n, "davidson_residual": n - 1}
    check(n > 1 and got == want,
          f"EOM {label}: launches {got}, expected {want} for {n} sigma calls")


def eom_runs(cases, lih, device):
    """The EOM path: each UEG case (label, fock, operator, T2, JAX roots,
    JAX iterations) against the JAX package, then LiH on the dressed CCSD
    operator ``lih`` = (Fock, V, T2) against its oracle; each solve's
    launches against its sigma calls.  Returns the roots by label."""
    import torch

    from pymes_tpu_torch import kernels

    out = {}
    for label, fock, V, T2, ref, n_ref in cases:
        t0 = time.time()
        before = dict(kernels.LAUNCHES)
        solver, roots = eom_solve(fock, V, T2, device)
        check_eom_launches(label, before, solver, ladder=True)
        nv = T2.shape[0]
        check(all(bool(torch.isfinite(u).all()) for u in
                  solver.u_singles + solver.u_doubles)
              and solver.u_singles[0].shape == (nv, NO)
              and solver.u_doubles[0].shape == (nv, nv, NO, NO),
              f"EOM {label}: Ritz vectors not finite or of the wrong shape")
        err = float(np.abs(roots - np.asarray(ref)).max())
        n_it = solver.n_iterations
        check(err <= 1e-8, f"EOM {label}: roots {roots} vs JAX {ref}")
        check(abs(n_it - n_ref) <= 1,
              f"EOM {label}: {n_it} iterations, the JAX package {n_ref}")
        print(f"EOM {label}: roots {roots[0]:.13f} {roots[1]:.13f} in {n_it} "
              f"iterations (JAX {n_ref}), |roots - JAX|={err:.2e}, "
              f"{time.time() - t0:.2f} s", flush=True)
        out[label] = roots

    t0 = time.time()
    fd, Vd, t2 = lih
    before = dict(kernels.LAUNCHES)
    solver, roots = eom_solve(fd, Vd, t2, device, max_iter=1000,
                              no=t2.shape[-1])
    check_eom_launches("LiH", before, solver, ladder=False)
    err = float(np.abs(roots - np.asarray(LIH_EOM_ORACLE)).max())
    check(err <= 1e-7, f"EOM LiH: roots {roots} vs oracle {LIH_EOM_ORACLE}")
    print(f"EOM LiH/3-21G: roots {roots[0]:.13f} {roots[1]:.13f} in "
          f"{solver.n_iterations} iterations, |roots - oracle|={err:.2e}, "
          f"{time.time() - t0:.2f} s", flush=True)
    return out


def eom_ms_per_iter(fock, V, T2, device, twin, n=8):
    """ms per Davidson iteration at one set-up: the host wall (synchronised)
    of a solve of 2 + n iterations minus that of a solve of 2 (the set-up
    cancels), over n; with no stopping test (``e_epsilon`` < 0), so a
    restart at max_dim falls inside the n."""
    import torch

    walls = []
    for n_iter in (2, 2 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eom_solve(fock, V, T2, device, max_iter=n_iter, twin=twin, eps=-1.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (walls[1] - walls[0]) * 1e3 / n


def path_launches(label, run, expect):
    """Run one main path with the launch counts reset just before and read
    just after; every kernel in ``expect`` must have launched."""
    from pymes_tpu_torch import kernels

    kernels.reset_launches()
    run()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the {label} path: {launches}", flush=True)
    for name in expect:
        check(launches[name] > 0,
              f"kernel {name} never launched on the {label} path")
    return launches


def solve_fixed(p, twin, max_iter=60):
    """ms/iteration of ``max_iter + 1`` CCD iterations (host clock,
    synchronised)."""
    import torch

    from pymes_tpu_torch.solver import ccd

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ccd.ccd_solve(p["fock"], p["blocks"], NO, p["T0"],
                        level_shift=-1.0, delta_e=-1.0, max_iter=max_iter,
                        twin=twin)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / out[5], out[5]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # phase 0: card and versions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = smi.strip()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    device = "cuda"

    from pymes_tpu_torch.kernels import _build
    from pymes_tpu_torch.solver import ccd

    # phase 1: builds (nvcc for K1; Triton JIT for the others at their
    # first launch, which phase 2 makes)
    t0 = time.time()
    _build.library()
    print(f"K1 nvcc build + load: {time.time() - t0:.2f} s", flush=True)
    problems = {c: setup(c, device) for c in (5, 14)}
    q = setup_ccsd(problems[14], device)
    t0 = time.time()
    compare = [compare_kernels(problems[5], 1)]
    print(f"first CCD kernel launches (Triton JIT of K2/K3 included): "
          f"{time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    compare.append(compare_ccsd_kernels(q, 4))
    print(f"first CCSD kernel launches at nP={q['nP']} (Triton JIT of K4, "
          f"K2' and K3' included): {time.time() - t0:.2f} s", flush=True)
    # phase 2: kernel vs twin at the nP=219 CCD plan and at the dense
    # CCSD path's molecular shapes too
    compare.append(compare_kernels(problems[14], 2))
    t0 = time.time()
    mols = {name: load_molecule(name, device) for name in MOLECULES}
    print(f"molecular integrals read: {time.time() - t0:.2f} s", flush=True)
    compare.append(compare_molecular_kernels(mols, 6))
    t0 = time.time()
    eom_ops = {5: eom_operator(problems[5], device),
               14: eom_operator(problems[14], device, q["plan_all"],
                                q["mf_dict"]["_ovvv_plans"])}
    compare.append(compare_eom_kernels(q, eom_ops[14], 7))
    print(f"EOM operators + first K5/K6 launches (Triton JIT included): "
          f"{time.time() - t0:.2f} s", flush=True)
    max_err = {k: max(c[k] for c in compare if k in c) for k in KERNELS}

    # phases 3-4: the CCD path, converged
    results = {}

    def run_ccd():
        for c, p in problems.items():
            t0 = time.time()
            res = ccd.CCD(NO, device).solve(p["fock"], p["blocks"],
                                            level_shift=-1.0, max_iter=60)
            n_it = len(res["e history"])
            e = res["ccd e"]
            T = res["t2 amp"]
            check(T.shape == (p["nv"], p["nv"], NO, NO)
                  and bool(torch.isfinite(T).all()),
                  f"nP={p['nP']}: amplitudes not finite or of the wrong "
                  "shape")
            check(abs(e - E_JAX[c]) <= 1e-9,
                  f"nP={p['nP']}: E={e:.13f} vs JAX {E_JAX[c]}")
            print(f"CCD nP={p['nP']}: E={e:.13f} in {n_it} iterations, "
                  f"|E - E_jax|={abs(e - E_JAX[c]):.2e}, "
                  f"{time.time() - t0:.2f} s", flush=True)
            results[c] = (e, n_it, T)

    launches = {"CCD": path_launches("CCD", run_ccd, CCD_KERNELS)}
    e57, it57 = results[5][:2]
    check(it57 == 6, f"nP=57 took {it57} iterations, expected 6")
    check(abs(e57 - ORACLE_NP57) <= 1e-8,
          f"nP=57 E={e57} vs oracle {ORACLE_NP57}")
    print(f"nP=57 |E - oracle| = {abs(e57 - ORACLE_NP57):.2e}", flush=True)

    # phase 6: dense molecular CCSD (molecular and transcorrelated)
    launches["dense CCSD"] = path_launches(
        "dense CCSD", lambda: molecular_ccsd(mols, device),
        DENSE_CCSD_KERNELS)
    # phase 7: matrix-free CCSD at nP=219
    ccsd_res = {}
    launches["matrix-free CCSD"] = path_launches(
        "matrix-free CCSD", lambda: ccsd_res.update(mf_ccsd(q, device)),
        MF_CCSD_KERNELS)
    # phase 9: EOM-CCSD, the no-ovvv operator at nP=57 and nP=219, and LiH
    T2_ccsd = ccsd_res["canonical"]["t2"]
    cases = [(f"nP={problems[c]['nP']} CCD amplitudes", problems[c]["fock"],
              eom_ops[c], results[c][2], *EOM_JAX[c]) for c in (5, 14)]
    cases.append((f"nP={q['nP']} CCSD amplitudes", q["fock"], eom_ops[14],
                  T2_ccsd, *EOM_JAX_CCSD_AMPS_NP219))
    # the LiH ground state and its dressing run before the EOM path's
    # counted window, so that the window holds EOM solves alone
    t0 = time.time()
    lih = lih_dressed(mols["LiH"], device)
    print(f"LiH CCSD + T1 dressing for EOM: {time.time() - t0:.2f} s",
          flush=True)
    eom_roots = {}
    launches["EOM"] = path_launches(
        "EOM", lambda: eom_roots.update(eom_runs(cases, lih, device)),
        EOM_KERNELS)
    r_ccd, r_ccsd = (eom_roots[c[0]] for c in cases[1:])
    for label, r in (("CCD", r_ccd), ("CCSD", r_ccsd)):
        dev = float(np.abs(r - np.asarray(EOM_RECORDED_NP219)).max())
        check(dev <= 1e-6, f"EOM nP={q['nP']} {label} amplitudes: roots {r} "
              f"vs recorded {EOM_RECORDED_NP219}")
    gap = float(np.abs(r_ccd - r_ccsd).max())
    check(gap <= 1e-7, f"EOM nP={q['nP']}: CCD- vs CCSD-amplitude roots "
          f"differ by {gap:.3e}")
    print(f"EOM nP={q['nP']}: |roots - recorded| <= 1e-6, |roots(CCD amps)"
          f" - roots(CCSD amps)| = {gap:.2e}", flush=True)
    total = {k: sum(run[k] for run in launches.values()) for k in KERNELS}

    # phase 5: CCD timing
    kernel_ms = {}
    for c, p in problems.items():
        kernel_ms[c] = time_kernels(p, 3)
        for name, (ms, plain) in kernel_ms[c].items():
            print(f"[{card}] nP={p['nP']} {name}: kernel {ms:.4f} ms, "
                  f"twin {plain:.4f} ms per call", flush=True)
        walls = {False: [], True: []}
        n_fixed = 0
        for _ in range(5):
            for twin in (False, True):
                ms, n_fixed = solve_fixed(p, twin)
                walls[twin].append(ms)
        print(f"[{card}] nP={p['nP']} fixed-{n_fixed}-iteration CCD, min of "
              f"5: kernels {min(walls[False]):.3f} ms/iter, twins "
              f"{min(walls[True]):.3f} ms/iter", flush=True)
    # phase 8: CCSD timing at nP=219
    kernel_ms[14].update(time_ccsd_kernels(q, 5))
    for name in ("ovvv_gather", "ccsd_jacobi_diis", "ccsd_mix_energy"):
        ms, plain = kernel_ms[14][name]
        print(f"[{card}] nP={q['nP']} {name}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms per call", flush=True)
    walls = {False: [], True: []}
    n_fixed = 0
    for _ in range(5):
        for twin in (False, True):
            ms, n_fixed = solve_ccsd_fixed(q, twin)
            walls[twin].append(ms)
    print(f"[{card}] nP={q['nP']} fixed-{n_fixed}-iteration matrix-free "
          f"CCSD (non-canonical), min of 5: kernels "
          f"{min(walls[False]):.3f} ms/iter, twins {min(walls[True]):.3f} "
          "ms/iter", flush=True)

    # phase 10: EOM timing at nP=219
    kernel_ms[14].update(time_eom_kernels(q, eom_ops[14], 8))
    for name in ("pair_symmetrize", "pair_symmetrize ijab+Y",
                 "davidson_residual"):
        ms, plain = kernel_ms[14][name]
        print(f"[{card}] nP={q['nP']} {name}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms per call", flush=True)
    it_ms = {True: [], False: []}
    for twin in (True, False, False, True):
        it_ms[twin].append(eom_ms_per_iter(q["fock"], eom_ops[14],
                                           results[14][2], device, twin))
    print(f"[{card}] nP={q['nP']} EOM-CCSD Davidson (k=2, max_dim=16), mean "
          f"of 2: kernels {np.mean(it_ms[False]):.3f} ms/iter, twins "
          f"{np.mean(it_ms[True]):.3f} ms/iter", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": max_err[name],
         "ms": kernel_ms[14][name][0], "plain_ms": kernel_ms[14][name][1]}
        for name, (route, src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
