#!/usr/bin/env python3
"""Hold ``chip_smoke.queued_ms``, the fallback of ``chip_smoke.card_ms``
when the profiler sees no CUDA activity, against the profiler's device
time and against ``chip_smoke.cuda_ms`` on one CUDA card.

    python3 tools/check_queued_ms.py

Two calls: a 64-float ``mul_``, whose launch takes longer on the host than
on the card (the spin should match the profiler and come far under the
events round unqueued calls), and a 4096² f32 GEMM, which the card takes
far longer than its launch (all three should agree).  Then ``card_ms``
with a kernel name no trace holds, which takes the fallback and prints
its line.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("check_queued_ms: torch sees no CUDA device", file=sys.stderr)
        return 1
    x = torch.randn(4096, 4096, device="cuda")
    small = torch.randn(64, device="cuda")
    for label, f, name in (("mul_ of 64 floats", lambda: small.mul_(1.0),
                            "elementwise"),
                           ("4096^2 f32 GEMM", lambda: x @ x, "gemm")):
        print(f"{label}: profiler {cs.card_ms(f, name):.5f} ms, queued "
              f"{cs.queued_ms(f):.5f} ms, events {cs.cuda_ms(f):.5f} ms",
              flush=True)
    ms = cs.card_ms(lambda: small.mul_(1.0), "no_such_kernel")
    print(f"forced fallback: {ms:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
