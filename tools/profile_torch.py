#!/usr/bin/env python3
"""Device-time breakdown of the port's main paths on one GPU.

Runs ``N_ITER`` fixed iterations (``delta_e = -1``) under ``torch.profiler``
(CPU + CUDA activities) for CCD at nP=57 and nP=219 and for matrix-free
CCSD at nP=219 with the seeded non-canonical Fock (UEG 14e, rs=0.5, the
set-up of ``chip_smoke.py``), and ``N_ITER`` Davidson iterations of
EOM-CCSD at nP=219 (the matrix-free no-ovvv operator on the CCD
amplitudes, n_excit=2, max_dim=16, no stopping test; the profile of a
2-iteration solve is subtracted from that of a (2 + N_ITER)-iteration one,
so the set-up drops out and a restart at max_dim falls inside), each
through the hand-written kernels and through their plain twins.  For each
run it reports, per iteration: the host wall time of the profiled solve
(synchronised), the device busy time (the union of all kernel, memcpy and
memset intervals), the idle share (1 − busy / wall), the launches, and the
device time and launch count by category (cuBLAS DGEMM and GEMV,
elementwise/copy, reductions, each hand-written kernel, other), plus the
twelve costliest kernels by name.

Run from the repository root on a machine with one CUDA device:
``python3 tools/profile_torch.py [--out build/profile_torch.json]``.
Prints one JSON object per run and writes all of them to ``--out``; the
trace files it parses are deleted.  Exits nonzero without CUDA.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_ITER = 10
# category of a kernel: the first whose keys occur in its lower-cased name
CATEGORIES = (
    ("K1 block_ladder", ("block_ladder",)),
    ("K5 pair_symmetrize", ("pair_sym",)),
    ("K6 davidson_residual", ("davidson_residual",)),
    ("K4 ovvv_gather", ("ovvv_gather",)),
    ("K2' jacobi_diis", ("ccsd_jacobi",)),
    ("K3' mix_energy", ("ccsd_mix",)),
    ("K2 jacobi_diis", ("jacobi_insert",)),
    ("K3 mix_energy", ("mix_energy",)),
    ("DGEMM", ("gemm",)),
    ("GEMV", ("gemv",)),
    ("reduction", ("reduce",)),
    ("elementwise/copy", ("elementwise", "copy", "catarray")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name, cat):
    if cat != "kernel":
        return "memcpy/memset"
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other"


def raw_totals(trace_path):
    """Device busy time (the union of the device intervals), launches and
    time by category and by kernel name of one trace, in µs."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:           # union of the device intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_cat, by_name = {}, {}
    for e in events:
        for table, key in ((by_cat, category(e["name"], e["cat"])),
                           (by_name, e["name"][:90])):
            n, us = table.get(key, (0, 0.0))
            table[key] = (n + 1, us + float(e["dur"]))
    return {"busy_us": busy_us, "events": len(events), "by_category": by_cat,
            "by_name": by_name}


def breakdown(tot, n_iter, wall_ms, base=None):
    """Per-iteration figures of ``raw_totals`` ``tot`` over ``n_iter``
    iterations, less those of ``base`` (a shorter run whose set-up is the
    same) when given."""
    def minus(table, key):
        if base is None:
            return table
        return {k: (n - base[key].get(k, (0, 0.0))[0],
                    us - base[key].get(k, (0, 0.0))[1])
                for k, (n, us) in table.items()}

    def per_iter(table, top=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:top]
        return {k: [n / n_iter, us / 1e3 / n_iter] for k, (n, us) in rows}

    busy_us = tot["busy_us"] - (base["busy_us"] if base else 0.0)
    events = tot["events"] - (base["events"] if base else 0)
    busy_ms = busy_us / 1e3 / n_iter
    return {"wall_ms_per_iter": wall_ms, "busy_ms_per_iter": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_iter": events / n_iter,
            "by_category": per_iter(minus(tot["by_category"],
                                          "by_category")),
            "top12": per_iter(minus(tot["by_name"], "by_name"), 12)}


def eom_run(q, V, T2, twin, n_iter):
    """Host wall ms of one EOM solve of ``n_iter`` Davidson iterations
    with no stopping test (synchronised)."""
    import time

    import torch

    import chip_smoke as cs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.eom_solve(q["fock"], V, T2, "cuda", max_iter=n_iter, twin=twin,
                 eps=-1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main():
    import torch

    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" /
                                              "profile_torch.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"card: {card}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    from pymes_tpu_torch.solver import ccd

    problems = {c: cs.setup(c, "cuda") for c in (5, 14)}
    q = cs.setup_ccsd(problems[14], "cuda")
    V_eom = cs.eom_operator(problems[14], "cuda", q["plan_all"],
                            q["mf_dict"]["_ovvv_plans"])
    T2_eom = ccd.CCD(cs.NO, "cuda").solve(
        q["fock"], q["blocks"], level_shift=-1.0, max_iter=60)["t2 amp"]
    runs = {f"CCD nP={p['nP']}": (lambda tw, n, p=p: cs.solve_fixed(p, tw, n))
            for p in problems.values()}
    runs[f"mf-CCSD nP={q['nP']}"] = (
        lambda tw, n: cs.solve_ccsd_fixed(q, tw, n))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    result = {"card": card, "n_iter": N_ITER}
    trace = out.parent / "profile_torch_trace.json"
    for label, run in runs.items():
        for twin in (False, True):
            run(twin, 2)                     # builds, JIT, cuBLAS handles
            with torch.profiler.profile(activities=acts) as prof:
                wall_ms, n_iter = run(twin, N_ITER - 1)
            prof.export_chrome_trace(str(trace))
            key = f"{label}, {'twins' if twin else 'kernels'}"
            result[key] = breakdown(raw_totals(trace), n_iter, wall_ms)
            trace.unlink()
            print(json.dumps({key: result[key]}), flush=True)
    for twin in (False, True):
        eom_run(q, V_eom, T2_eom, twin, 2)    # builds, JIT, cuBLAS handles
        tots, walls = [], []
        for n in (2, 2 + N_ITER):
            with torch.profiler.profile(activities=acts) as prof:
                walls.append(eom_run(q, V_eom, T2_eom, twin, n))
            prof.export_chrome_trace(str(trace))
            tots.append(raw_totals(trace))
            trace.unlink()
        key = (f"EOM-CCSD nP={q['nP']} Davidson, "
               f"{'twins' if twin else 'kernels'}")
        result[key] = breakdown(tots[1], N_ITER,
                                (walls[1] - walls[0]) / N_ITER,
                                base=tots[0])
        print(json.dumps({key: result[key]}), flush=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"[{card}] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
