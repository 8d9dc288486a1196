"""Profiling and run-record observability.

Counterpart of ``pymes_tpu/util/observability.py``:

* :func:`profile` — context manager around ``torch.profiler`` (CPU
  activity, and the card's kernels and copies on a CUDA device), written
  as a Chrome trace into ``log_dir`` when the block ends;
* :class:`RunRecord` — structured per-solve metrics appended as JSON lines
  (system, solver settings, energies, iteration history, wall times), the
  same records as the JAX package's.
"""

import contextlib
import json
import os
import time

import numpy as np
import torch

from pymes_tpu_torch.config import resolve_device


@contextlib.contextmanager
def profile(log_dir, device):
    """Trace the enclosed block with ``torch.profiler`` and export it to
    ``<log_dir>/trace.json`` (Chrome trace format).  Yields the profiler
    (``key_averages()`` sums time by op).  The profiler stops when the
    block raises too; the trace is then not written."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RunRecord:
    """Append structured solve records to a JSONL file."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, solver, system=None, result=None, wall_s=None, **extra):
        rec = {"time": time.time(), "solver": solver}
        if system:
            rec["system"] = system
        if wall_s is not None:
            rec["wall_s"] = wall_s
        if result is not None:
            for key in ("ccd e", "ccsd e", "dE"):
                if key in result:
                    rec[key] = float(np.real(result[key]))
            if "e history" in result:
                rec["e_history"] = [float(x)
                                    for x in np.asarray(result["e history"])]
                rec["iterations"] = len(rec["e_history"])
        rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def read(self):
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
