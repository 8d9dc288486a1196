#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``pymes_tpu_torch``) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a run: set-up (the cell's problems built, one a twist of the
traffic and one at the seed's own twist, each warmed by one unit), a
closed-loop window of ``--seconds`` (one caller, units back to back: the
seed's twist first, then the traffic's twists in an order drawn from the
seed), the check against the plain reference, and one JSON line as the
last line of standard output.  ``--trace 1`` reports the cell's per-layer
metrics in place of its end-to-end ones: counts and host clocks over the
window, then one ``torch.profiler`` session over a few units.  The cell,
its configuration, its traffic mix (and the kind of unit it names), its
limits and its metrics are found by name from ``BENCHMARK.json``
(``portbench/README.md``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
# the Triton kernels' cache, beside the CUDA library of build/torch_kernels
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pymes_tpu")
PROFILE_MIN_S = 2.0


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell):
    """The end-to-end metrics the cell reports, and its per-layer ones."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    ends = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in ends}
    layers = [m for m in bench["per_layer"]
              if applies(m) and m["moves"] in names]
    return ends, layers


class Calls:
    """Records the calls of the program's functions that the per-layer
    metrics name (a reader's ``CALLS``, "module:function") in the profiled
    session, each by the reader's ``record`` and the problem it ran on."""

    def __init__(self, readers):
        self.problem = 0
        self.seen = {}
        self.patches = []
        for r in readers:
            target = getattr(r, "CALLS", None)
            if target is None or target in self.seen:
                continue
            self.seen[target] = []
            name, attr = target.split(":")
            mod = importlib.import_module(name)
            self.patches.append((mod, attr, getattr(mod, attr),
                                 self.wrap(getattr(mod, attr), r.record,
                                           self.seen[target])))

    def wrap(self, fn, record, out):
        def hooked(*args, **kw):
            out.append(dict(record(*args, **kw), problem=self.problem))
            return fn(*args, **kw)
        return hooked

    def __enter__(self):
        for mod, attr, _, hooked in self.patches:
            setattr(mod, attr, hooked)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig, _ in self.patches:
            setattr(mod, attr, orig)


def run_units(kind, state, pick, start, records, seconds, calls=None,
              min_units=0):
    """Units back to back, the n-th on problem ``pick(start + n)``, until
    ``seconds`` have passed and at least ``min_units`` ran; returns (wall
    seconds, units run)."""
    from portbench.common import sync

    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        k = pick(start + n)
        if calls is not None:
            calls.problem = k
        records[k].append(kind.unit(state, k))
        n += 1
        if n >= min_units and time.perf_counter() - t0 >= seconds:
            break
    sync()
    return time.perf_counter() - t0, n


def parse_trace(path, t_host):
    """Device intervals, busy seconds, kernel durations and the idle gaps
    by the host op running in them, from a Chrome trace."""
    import numpy as np

    ev = json.loads(Path(path).read_text())["traceEvents"]
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset") and "dur" in e]
    cpu = [e for e in ev if e.get("cat") == "cpu_op" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy_us = sum(hi - lo for lo, hi in merged)
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    idle = {}
    if cpu and gaps:
        tids = {}
        for e in cpu:
            tids[e["tid"]] = tids.get(e["tid"], 0) + 1
        main = max(tids, key=tids.get)
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in cpu if e["tid"] == main)
        mids = sorted(((lo + hi) / 2, hi - lo) for lo, hi in gaps)
        stack, i = [], 0
        for t, width in mids:
            while i < len(ops) and ops[i][0] <= t:
                while stack and stack[-1][1] <= ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            name = stack[-1][2] if stack else "no_host_op"
            idle[name] = idle.get(name, 0.0) + width / 1e6
    kern = {}
    for e in dev:
        kern.setdefault((e["cat"], e["name"]), []).append(float(e["dur"]))
    return {"busy_s": busy_us / 1e6, "window_s": t_host,
            "ops": [(cat, name, durs) for (cat, name), durs in kern.items()],
            "n_device_ops": len(dev),
            "device_ops": sorted(((name[:64], float(np.sum(durs)) / 1e6)
                                  for (_, name), durs in kern.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10]}


def profile(kind, state, pick, start, n_problems, readers):
    """One profiler session over at least one unit of every problem and
    ``PROFILE_MIN_S`` seconds, retried once if it saw no device activity;
    returns (trace summary, the calls the readers name)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    records = [[] for _ in state["probs"]]
    for attempt in (1, 2):
        with Calls(readers) as calls, \
                torch.profiler.profile(activities=acts) as p:
            wall, n = run_units(kind, state, pick, start, records,
                                PROFILE_MIN_S, calls, n_problems)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            p.export_chrome_trace(str(path))
            tr = parse_trace(path, wall)
        tr["units"] = n
        if tr["n_device_ops"] > 0:
            return tr, calls.seen
        print(f"portbench: the profiler saw no device activity in session "
              f"{attempt} of 2", file=sys.stderr, flush=True)
    raise RuntimeError("the profiler saw no device activity in two "
                       "sessions: no per-layer metric can be read")


def execute(cell, cfg, traffic, limits, metrics, seed, seconds, trace,
            device="cuda"):
    """Set-up, window, check: returns (result line, check rows).  The
    look for a card is the caller's (``main``).  ``metrics`` are the
    definitions of the metrics the line reports (the cell's end-to-end
    ones, or with ``trace`` its per-layer ones), each read by
    ``portbench/metrics/<name>.py``.

    The problems are the traffic's fixed twists and, last, the seed's own
    twist (``common.twist_of``); each is warmed by one unit.  The window's
    first unit is on the seed's twist, the rest cycle over the fixed ones
    in an order drawn from the seed (over the seed's twist alone where the
    traffic has none).  The check samples the seed's twist and
    ``traffic["check"]`` of the fixed ones, drawn from the seed."""
    import numpy as np
    import torch

    from portbench import check, common
    from pymes_tpu_torch.log import set_verbosity

    set_verbosity(-1)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    readers = [load_module(HERE / "metrics" / f"{m['name']}.py")
               for m in metrics]
    m = len(traffic["twists"])
    twists = [list(tw) for tw in traffic["twists"]]
    twists.append(common.twist_of(seed, cfg["n_p"]))
    spans = common.Spans()
    state = kind.setup(cfg, traffic, twists, device, spans)
    for k in range(m + 1):
        kind.unit(state, k)
    common.sync()
    setup_s = time.perf_counter() - T_START

    rng = np.random.default_rng(seed)
    order = [int(k) for k in rng.permutation(m)]

    def pick(p):
        return m if p == 0 or m == 0 else order[(p - 1) % m]

    records = [[] for _ in twists]
    wall, n = run_units(kind, state, pick, 0, records, seconds)
    counts = {}
    for r in (r for rs in records for r in rs):
        for key, v in r.items():
            if isinstance(v, int) and not isinstance(v, bool):
                counts[key] = counts.get(key, 0) + v
    ctx = {"cell": cell, "config": cfg, "traffic": traffic,
           "setup_s": setup_s, "spans": dict(spans.seconds),
           "window": {"seconds": wall, "units": n, "counts": counts},
           "problems": [{"k_int": g["k_int"], "no": g["no"]}
                        for g in state["probs"]]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1}
    breakdown = None
    if trace:
        ctx["trace"], ctx["calls"] = profile(kind, state, pick, n, max(m, 1),
                                             readers)
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        breakdown = {"device_ops": ctx["trace"]["device_ops"],
                     "idle_gaps": ctx["trace"]["idle_gaps"]}
    ctx["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    dev["memory_peak_bytes"] = ctx["peak_bytes"]
    values = {}
    for mdef, reader in zip(metrics, readers):
        v = reader.read(ctx)
        if v is not None:
            values[mdef["name"]] = {"value": v, "unit": mdef["unit"]}

    # the check: the program's state freed first, the reference after
    t_check = time.perf_counter()
    answers = kind.answers(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picks = [m] + sorted(int(k) for k in rng.choice(m, traffic["check"],
                                                    replace=False))
    numbers, bad = check.compare(kind, cfg, traffic, twists, answers,
                                 records, picks, limits, device)
    ok, rows = check.judge(numbers, limits)
    failed = sum(1 for k, rs in enumerate(records) for r in rs
                 if k in bad or not r["converged"])
    print(f"portbench: set-up {setup_s:.3f} s ({json.dumps(ctx['spans'])}),"
          f" window {wall:.3f} s over {n} units, seed twist "
          f"{twists[m]}, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    line = {"correct": bool(ok and failed == 0), "attempted": n,
            "failed": failed, "metrics": values, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = rows
    return line, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" /
                         f"{args.workload}.json").read_text())
    ends, layers = cell_metrics(bench, args.workload)
    line, rows = execute(args.workload, cfg, traffic, limits,
                         layers if args.trace else ends, args.seed,
                         args.seconds, args.trace)

    found = sorted({name.split(".")[0] for name in sys.modules}
                   & set(FORBIDDEN))
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, row in rows.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
