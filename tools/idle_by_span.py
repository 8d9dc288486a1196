#!/usr/bin/env python3
"""The card's idle gaps of one benchmark cell, put down to the port's
program spans (``pymes_tpu_torch/util/observability.py``).

    python3 tools/idle_by_span.py --workload np389.ccd --seed 7 \
        [--seconds 2] [--out chiprun_out/idle_np389.ccd.json]

Sets the cell up as ``portbench/run.py`` does (its configuration, traffic
and kind of unit from ``BENCHMARK.json``; the traffic's twists and the
seed's own, each warmed by one unit) with the tracer on, then:

* counts: one unit of every problem, and the ``cc.iter`` / ``eom.iter``
  spans against the iterations the units report;
* one ``observability.profile`` session of at least ``--seconds`` and a
  unit of every problem, exported as a Chrome trace; ``idle_share`` is
  1 − busy / the session's wall, as ``device_idle.*`` reads it;
* idle: the gaps between the union of the kernel, memcpy and memset
  intervals, each put down by its midpoint to the innermost program span
  (a ``user_annotation`` of the host's main thread) over it, and, as
  ``portbench/run.py`` ``parse_trace`` does, to the innermost ``cpu_op``
  (``no_host_op`` where none is);
* the session's spans: count, median and total ms by name;
* clock: each span's start through ``observability.epoch_ns`` less its
  annotation's ``ts`` × 1000 + ``baseTimeNanoseconds`` (median, least and
  largest, µs).

Prints one JSON line and writes it to ``--out``.  Needs a CUDA card.
"""

import argparse
import importlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def innermost(events, points):
    """For each sorted midpoint, the name of the innermost event of
    ``events`` ((start, end, name), sorted by start) over it, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_by_span(trace):
    """Busy and idle seconds of a Chrome trace, the idle by program span,
    by program span within the ``no_host_op`` idle, and by the pair."""
    ev = trace["traceEvents"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset") and "dur" in e)
    merged = []
    for lo, hi in dev:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    cpu = [e for e in ev if e.get("cat") == "cpu_op" and "dur" in e]
    tids = {}
    for e in cpu:
        tids[e["tid"]] = tids.get(e["tid"], 0) + 1
    main = max(tids, key=tids.get)

    def on_main(cat):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in ev if e.get("cat") == cat
                      and e.get("tid") == main and "dur" in e)

    mids = sorted(((lo + hi) / 2, (hi - lo) / 1e6) for lo, hi in gaps)
    spans = innermost(on_main("user_annotation"), [t for t, _ in mids])
    ops = innermost(on_main("cpu_op"), [t for t, _ in mids])
    by_span, no_op, by_op, pairs = {}, {}, {}, {}
    for (_, width), s, op in zip(mids, spans, ops):
        s = s or "no_span"
        op = op or "no_host_op"
        by_span[s] = by_span.get(s, 0.0) + width
        by_op[op] = by_op.get(op, 0.0) + width
        pairs[f"{s} {op}"] = pairs.get(f"{s} {op}", 0.0) + width
        if op == "no_host_op":
            no_op[s] = no_op.get(s, 0.0) + width

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"busy_s": sum(hi - lo for lo, hi in merged) / 1e6,
            "idle_s": sum(w for _, w in mids),
            "idle_by_span_s": ranked(by_span),
            "no_host_op_by_span_s": ranked(no_op),
            "idle_by_op_s": dict(list(ranked(by_op).items())[:10]),
            "idle_by_span_op_s": dict(list(ranked(pairs).items())[:16]),
            "gpu_user_annotations": sum(
                1 for e in ev if e.get("cat") == "gpu_user_annotation")}


def clock_gaps_us(trace, records, epoch_ns):
    """Span start − annotation start, µs, of every span (spans and
    annotations of one name matched in order): median, least, largest."""
    base = trace["baseTimeNanoseconds"]
    marks = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(
                float(e["ts"]) * 1000 + base)
    starts = {}
    for r in records:
        starts.setdefault(r.name, []).append(epoch_ns(r.t0_ns))
    gaps = []
    for name, ts in starts.items():
        got = sorted(marks.get(name, []))
        if len(got) != len(ts):
            raise RuntimeError(f"{len(ts)} spans {name} but {len(got)} "
                               "annotations in the trace")
        gaps += [(a - b) / 1e3 for a, b in zip(sorted(ts), got)]
    return {"median": statistics.median(gaps), "least": min(gaps),
            "largest": max(gaps), "spans": len(gaps)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import common
    from pymes_tpu_torch.log import set_verbosity
    from pymes_tpu_torch.util import observability as obs

    if not torch.cuda.is_available():
        print("idle_by_span: torch sees no CUDA device", file=sys.stderr)
        return 3
    set_verbosity(-1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg_file = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_file["file"]).read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")

    obs.enable()
    twists = [list(tw) for tw in traffic["twists"]]
    twists.append(common.twist_of(args.seed, cfg["n_p"]))
    state = kind.setup(cfg, traffic, twists, "cuda", common.Spans())
    for k in range(len(twists)):
        kind.unit(state, k)
    common.sync()

    obs.clear()
    recs = [kind.unit(state, k) for k in range(len(twists))]
    counts = {}
    for key, span in (("cc_iters", "cc.iter"),
                      ("davidson_iters", "eom.iter")):
        if key in recs[0]:
            counts[span] = {"spans": obs.summary()[span]["count"],
                            "iterations": sum(r[key] for r in recs)}

    obs.clear()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with obs.profile(tmp, device="cuda"):
            common.sync()
            t0 = time.perf_counter()
            n = 0
            while n < len(twists) or time.perf_counter() - t0 < args.seconds:
                kind.unit(state, n % len(twists))
                n += 1
            common.sync()
            wall = time.perf_counter() - t0
        trace = json.loads((Path(tmp) / "trace.json").read_text())
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "units": n,
           "window_s": wall, "counts": counts}
    out.update(idle_by_span(trace))
    out["idle_share"] = 1.0 - out["busy_s"] / wall
    durs = {}
    for r in obs.spans():
        durs.setdefault(r.name, []).append((r.t1_ns - r.t0_ns) / 1e6)
    out["spans_ms"] = {name: {"count": len(d),
                              "median": statistics.median(d),
                              "total": sum(d)} for name, d in durs.items()}
    out["clock_gap_us"] = clock_gaps_us(trace, obs.spans(), obs.epoch_ns)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
