#!/usr/bin/env python3
"""Time the CC tail passes K2/K3 and K2′/K3′ of one checkout, f64 and
f32, on one CUDA card, and the host-bound walls around them.

    python3 tools/time_tails.py [--tree DIR] [--out FILE]

Imports ``pymes_tpu_torch`` from ``DIR`` (default: the checkout this file
lies in) and the set-up and timing helpers from this checkout's
``chip_smoke.py``, so that two trees, a parent and a change, can be timed
in one call on one card, in turns (parent, change, change, parent).  On
UEG 14 electrons, rs = 0.5:

* first the walls, before any profiler session: ms per iteration of the
  fixed-61-iteration CCD at nP=57 and nP=219 and of the non-canonical
  matrix-free CCSD at nP=219 (``chip_smoke.solve_fixed``,
  ``solve_ccsd_fixed``; min of 5 solves);
* then each pass at nP=219 on ``chip_smoke.tail_calls`` (slot 2 of a
  6-slot ring, all valid), f64 and f32: ms per wrapper call (CUDA events,
  mean of 20 calls after 3 warm-ups), the host's time to issue a call
  (host clock over 20 calls issued back to back, without a synchronise),
  and on the card alone (``torch.profiler``: every device operation of a
  call, and the pass's own kernels, those whose name holds ``jacobi`` or
  ``mix``).

Prints the card and one JSON line; ``--out`` also writes it to FILE.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def host_ms(torch, fn, n=20, warmup=3):
    """ms of host time to issue one call of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--out")
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("time_tails: torch sees no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pymes_tpu_torch.kernels import ccsd_tail

    assert Path(ccsd_tail.__file__).resolve().is_relative_to(tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    p57, p219 = cs.setup(5, "cuda"), cs.setup(14, "cuda")
    q = cs.setup_ccsd(p219, "cuda")
    out = {"tree": tree, "card": card.strip(), "walls": {}, "tails": {}}
    # every kernel of the timed paths built and launched once
    cs.solve_fixed(p57, False, max_iter=1)
    cs.solve_ccsd_fixed(q, False, max_iter=1)
    for label, run in (("CCD nP=57", lambda: cs.solve_fixed(p57, False)),
                       ("CCD nP=219", lambda: cs.solve_fixed(p219, False)),
                       ("mf-CCSD nP=219", lambda: cs.solve_ccsd_fixed(
                           q, False))):
        out["walls"][label] = [run()[0] for _ in range(5)]
    for sfx, dtype in (("", torch.float64), ("_f32", torch.float32)):
        calls = cs.tail_calls(p219, q, 5, dtype)
        for name, fn in calls.items():
            out["tails"][name + sfx] = {"ms": cs.cuda_ms(fn),
                                        "host_ms": host_ms(torch, fn)}
        for name, fn in calls.items():
            kernel = "jacobi" if "jacobi" in name else "mix"
            out["tails"][name + sfx].update(
                card_ms=cs.card_ms(fn, ""), kernel_ms=cs.card_ms(fn, kernel))
        del calls
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
