#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from (one process,
on the card; not part of a benchmark run).

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \
        --control 1-3 [--out chiprun_out/calib.jsonl]

For each seed of ``--seeds``: the cell run through the harness (set-up,
one unit after the warm one, the check) on the seed's own twist alone
(``common.twist_of``, as a run draws it), printing the check's numbers:
the lower readings.  For each seed of
``--control``: the control, the reference in float32 judged against the
reference in float64 on the twist of that seed: the upper readings.  One
JSON line each.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("calibrate: torch sees no CUDA device", file=sys.stderr)
        return 3
    from portbench import common, run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    names = kind.NUMBERS
    out = open(args.out, "a") if args.out else None

    def emit(row):
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    for s in seeds(args.seeds) if args.seeds else []:
        tw = common.twist_of(s, cfg["n_p"])
        tr = dict(traffic, twists=[], check=0)
        t0 = time.perf_counter()
        line, rows = run.execute(args.workload, cfg, tr,
                                 {n: float("inf") for n in names}, [], s,
                                 0.0, 0)
        emit({"kind": "program", "seed": s, "twist": tw,
              "numbers": {k: v["value"] for k, v in rows.items()},
              "units": line["attempted"], "failed": line["failed"],
              "seconds": time.perf_counter() - t0})
    for s in seeds(args.control) if args.control else []:
        tw = common.twist_of(s, cfg["n_p"])
        t0 = time.perf_counter()
        emit({"kind": "control", "seed": s, "twist": tw,
              "numbers": kind.control(cfg, traffic, tw, "cuda"),
              "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
