#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pymes_tpu_torch``) on one GPU.

Drives the port's main path — UEG 14 electrons, rs = 0.5: integrals →
named o/v blocks on the card → HF orbital energies → momentum-sector ladder
plan → MP2 guess → matrix-free CCD to |dE| < 1e-8 — at cutoff 5 (nP=57)
and cutoff 14 (nP=219), through the port's own kernels:

* K1 ``block_ladder`` (CUDA C++, built with nvcc for sm_90a at first use);
* K2 ``ccd_jacobi_diis`` and K3 ``ccd_mix_energy`` (Triton).

Phases: (0) card and versions; (1) kernel builds; (2) each kernel against
its plain twin on the card at both plans, seeded inputs, bound
max|kernel − twin| ≤ 1e-12·max|twin| (both f64, only the summation order
differs); (3, 4) the converged solves, with launch counts reset just before
and read just after; (5) timing: kernel vs twin per call, and ms/iteration
of fixed-61-iteration solves (min of 5) through the kernels and through the
twins.  Prints a JSON line of the kernels, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits nonzero; without CUDA it exits nonzero at once.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time

import numpy as np

NO = 7
NEED = ("klij", "ijab", "abij", "iajb", "iabj", "aibj", "aijb")
# converged CCD energies of the JAX package (f64, CPU) and the reference
# oracle (BASELINE.md)
E_JAX = {5: -0.5120153543911, 14: -0.5767206765319}
ORACLE_NP57 = -0.5120153512190824
REL_TOL = 1e-12
KERNELS = {
    "block_ladder": ("cuda", "pymes_tpu_torch/csrc/block_ladder.cu",
                     "pymes_tpu/ops/ueg_ladder.py:450"),
    "ccd_jacobi_diis": ("triton", "pymes_tpu_torch/kernels/ccd_tail.py",
                        "pymes_tpu/solver/ccd.py:525"),
    "ccd_mix_energy": ("triton", "pymes_tpu_torch/kernels/ccd_tail.py",
                       "pymes_tpu/mixer/diis.py:107"),
}


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
            "blocks": blocks, "T0": T0, "eps_i": eps_i, "eps_a": eps_a}


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


def solve_fixed(p, twin):
    import torch

    from pymes_tpu_torch.solver import ccd

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ccd.ccd_solve(p["fock"], p["blocks"], NO, p["T0"],
                        level_shift=-1.0, delta_e=-1.0, max_iter=60,
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

    from pymes_tpu_torch import kernels
    from pymes_tpu_torch.kernels import _build
    from pymes_tpu_torch.solver import ccd

    # phase 1: builds (nvcc for K1; Triton JIT for K2/K3 at their first
    # launch, which phase 2 makes)
    t0 = time.time()
    _build.library()
    print(f"K1 nvcc build + load: {time.time() - t0:.2f} s", flush=True)
    problems = {c: setup(c, device) for c in (5, 14)}
    t0 = time.time()
    compare = [compare_kernels(problems[5], 1)]
    print(f"first kernel launches (Triton JIT of K2/K3 included): "
          f"{time.time() - t0:.2f} s", flush=True)
    # phase 2: kernel vs twin at the nP=219 plan too
    compare.append(compare_kernels(problems[14], 2))
    max_err = {k: max(c[k] for c in compare) for k in KERNELS}

    # phases 3-4: the main path, converged, launch counts over this run
    kernels.reset_launches()
    results = {}
    for c, p in problems.items():
        t0 = time.time()
        res = ccd.CCD(NO, device).solve(p["fock"], p["blocks"],
                                        level_shift=-1.0, max_iter=60)
        n_it = len(res["e history"])
        e = res["ccd e"]
        T = res["t2 amp"]
        check(T.shape == (p["nv"], p["nv"], NO, NO)
              and bool(torch.isfinite(T).all()),
              f"nP={p['nP']}: amplitudes not finite or of the wrong shape")
        check(abs(e - E_JAX[c]) <= 1e-9,
              f"nP={p['nP']}: E={e:.13f} vs JAX {E_JAX[c]}")
        print(f"CCD nP={p['nP']}: E={e:.13f} in {n_it} iterations, "
              f"|E - E_jax|={abs(e - E_JAX[c]):.2e}, "
              f"{time.time() - t0:.2f} s", flush=True)
        results[c] = (e, n_it)
    launches = dict(kernels.LAUNCHES)
    e57, it57 = results[5]
    check(it57 == 6, f"nP=57 took {it57} iterations, expected 6")
    check(abs(e57 - ORACLE_NP57) <= 1e-8,
          f"nP=57 E={e57} vs oracle {ORACLE_NP57}")
    print(f"nP=57 |E - oracle| = {abs(e57 - ORACLE_NP57):.2e}", flush=True)
    print(f"launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    # phase 5: timing
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

    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": kernel_ms[14][name][0], "plain_ms": kernel_ms[14][name][1]}
        for name, (route, src, rep) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
