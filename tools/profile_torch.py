#!/usr/bin/env python3
"""Device-time breakdown of the port's main paths on one GPU.

Runs ``N_ITER`` fixed iterations (``delta_e = -1``) under ``torch.profiler``
(CPU + CUDA activities) for CCD at nP=57 and nP=219 and for matrix-free
CCSD at nP=219 with the seeded non-canonical Fock (UEG 14e, rs=0.5, the
set-up of ``chip_smoke.py``), each through the hand-written kernels and
through their plain twins.  For each run it reports, per iteration: the
host wall time of the profiled solve (synchronised), the device busy time
(the union of all kernel, memcpy and memset intervals), the idle share
(1 − busy / wall), the launches, and the device time and launch count by
category (cuBLAS DGEMM and GEMV, elementwise/copy, reductions, each
hand-written kernel, other), plus the twelve costliest kernels by name.

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


def breakdown(trace_path, n_iter, wall_ms):
    """Per-iteration busy time, idle share and categories of one trace."""
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

    def per_iter(table, top=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:top]
        return {k: [n / n_iter, us / 1e3 / n_iter] for k, (n, us) in rows}

    busy_ms = busy_us / 1e3 / n_iter
    return {"wall_ms_per_iter": wall_ms, "busy_ms_per_iter": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_iter": len(events) / n_iter,
            "by_category": per_iter(by_cat), "top12": per_iter(by_name, 12)}


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

    problems = {c: cs.setup(c, "cuda") for c in (5, 14)}
    q = cs.setup_ccsd(problems[14], "cuda")
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
            result[key] = breakdown(trace, n_iter, wall_ms)
            trace.unlink()
            print(json.dumps({key: result[key]}), flush=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"[{card}] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
