#!/usr/bin/env python3
"""Time K4, the ovvv T1 gather, of one checkout at the widths its callers
give it, on one CUDA card.

    python3 tools/time_k4.py [--tree DIR] [--out FILE]

Imports ``pymes_tpu_torch`` from ``DIR`` (default: the checkout this file
lies in), so that two trees, a parent and a change, can be timed in one
call on one card, in turns (parent, change, change, parent).  Each width
goes through the entry its main path calls, with the plans of the UEG 14
electrons, rs = 0.5:

* the CCSD dressing at nP=219: ``ovvv_t1_apply_j`` on the (nv, no) T1, 7
  columns, and the dressing's G_vv trace as that tree computes it (the
  fused trace ``ovvv_t1_trace`` where the tree has it, else the two full
  gathers and their einsums);
* the EOM Davidson sigma at nP=219, the FEAST nP=57 sigma (16 nodes × 4
  trials as 64 lanes) and the RT nP=123 sigma (32 lanes):
  ``ovvv_t1_apply`` on 2 trials a lane, a (k, nv, no) view of (k, N)
  Krylov rows as the lane-batched GMRES hands them over (14, 896 and 448
  columns).

Per width: ms per call (CUDA events, mean of 20 calls after 3 warm-ups,
over the three plans) and on the card alone (``torch.profiler``, the
kernels whose name holds ``ovvv``: the trace's row is the whole G_vv on
the card), the twin's ms per call, and the bound (S, W and T1 read once,
the output written once, at 3.35 TB/s).  Prints the card and one JSON
line; ``--out`` also writes it to FILE.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

NO = 7
HBM_BYTES_S = 3.35e12
# (label, cutoff, trials): None trials = the dressing's (nv, no) T1
WIDTHS = (("CCSD dressing nP=219, 7 columns", 14, None),
          ("EOM batch of 2 nP=219, 14 columns", 14, 2),
          ("FEAST nP=57, 896 columns", 5, 128),
          ("RT nP=123, 448 columns", 10, 64))


def cuda_ms(torch, fn, n=20, warmup=3):
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


def card_ms(torch, fn, name, n=20, warmup=3):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # self_device_time_total, self_cuda_time_total before torch 2.4; a 0
    # is a time, not a missing field
    us = sum(e.self_cuda_time_total
             if getattr(e, "self_device_time_total", None) is None
             else e.self_device_time_total
             for e in prof.key_averages() if name in e.key)
    return us / 1e3 / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--out")
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k4: torch sees no CUDA device", file=sys.stderr)
        return 1
    from pymes_tpu_torch.models import ueg
    from pymes_tpu_torch.ops import ueg_ladder

    assert Path(ueg_ladder.__file__).resolve().is_relative_to(tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    out = {"tree": tree, "card": card.strip(), "widths": {}}
    plans_of = {}
    for label, cutoff, k in WIDTHS:
        if cutoff not in plans_of:
            u = ueg.UEG(14, 7, 7, 0.5)
            u.init_single_basis(cutoff)
            plans_of[cutoff] = (u.n_spatial - NO,
                                ueg_ladder.build_ovvv_plans(u, device=dev))
        nv, plans = plans_of[cutoff]
        N = nv * NO + nv * nv * NO * NO
        if k is None:
            T = torch.randn((nv, NO), generator=g, dtype=torch.float64,
                            device=dev)
            apply, ncol = ueg_ladder.ovvv_t1_apply_j, NO
        else:
            rows = torch.randn((k, N), generator=g, dtype=torch.float64,
                               device=dev)
            T = rows[:, :nv * NO].reshape(k, nv, NO)
            apply, ncol = ueg_ladder.ovvv_t1_apply, k * NO

        def fn(tw, T=T, apply=apply, plans=plans):
            return [apply(p, T, twin=tw) for p in plans.values()]

        for a, b in zip(fn(False), fn(True)):
            torch.cuda.synchronize()
            assert torch.equal(a, b), f"{label}: kernel and twin differ"
        n = len(plans)
        t = [cuda_ms(torch, lambda: fn(tw)) / n
             for tw in (True, False, False, True)]
        nbytes = np.mean([4 * p.S.numel() + 8 * p.W.numel() + 8 * nv * ncol
                          + 8 * ncol * p.S.numel() for p in plans.values()])
        out["widths"][label] = {
            "ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
            "device_ms": card_ms(torch, lambda: fn(False), "ovvv") / n,
            "bound_ms": nbytes / HBM_BYTES_S * 1e3}
        if k is None:
            if hasattr(ueg_ladder, "ovvv_t1_trace"):
                def gvv(T=T, plans=plans):
                    return (2.0 * ueg_ladder.ovvv_t1_trace(plans["vov"], T, 1)
                            - ueg_ladder.ovvv_t1_trace(plans["ovv"], T, 0))
            else:
                def gvv(T=T, plans=plans):
                    o1 = ueg_ladder.ovvv_t1_apply_j(plans["vov"], T)
                    o2 = ueg_ladder.ovvv_t1_apply_j(plans["ovv"], T)
                    return (2.0 * torch.einsum("jajb->ab", o1)
                            - torch.einsum("jjab->ab", o2))
            out["widths"]["G_vv of the CCSD dressing nP=219"] = {
                "ms": cuda_ms(torch, gvv),
                "device_ms": card_ms(torch, gvv, "")}
        del T
        torch.cuda.empty_cache()
    print(card.strip())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
