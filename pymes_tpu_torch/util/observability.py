"""Profiling and run-record observability.

Counterpart of ``pymes_tpu/util/observability.py``:

* :func:`profile` — context manager around ``torch.profiler`` (CPU
  activity, and the card's kernels and copies on a CUDA device), written
  as a Chrome trace into ``log_dir`` when the block ends;
* :class:`RunRecord` — structured per-solve metrics appended as JSON lines
  (system, solver settings, energies, iteration history, wall times), the
  same records as the JAX package's;
* the tracer — named host spans at the port's layer boundaries
  (:func:`span`, :func:`traced`), off by default.  :func:`enable` turns it
  on; each span then records ``(id, parent, root, name, t0_ns, t1_ns)`` on
  ``time.perf_counter_ns()`` (``parent`` the innermost open span, ``root``
  the outermost, so one solve's spans share its root's id) into a list of
  at most :data:`CAP` records (past it, :data:`dropped` counts them), and
  enters ``torch.profiler.record_function(name)`` while a profiler runs
  (outside one it would record nothing), so that the session's Chrome
  trace shows it as a ``user_annotation`` on the kernels' timeline (on a
  card also as a ``gpu_user_annotation`` over its kernels); :func:`epoch_ns`
  maps a record's time onto that trace's clock (Unix-epoch ns: ``ts`` µs ×
  1000 + ``baseTimeNanoseconds``).  A span never synchronises a device and
  reads no device value.  :func:`spans` gives the records, :func:`summary`
  the count, total and self ns (the duration less what its child spans
  cover) by name.
"""

import contextlib
import functools
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pymes_tpu_torch.config import resolve_device


@contextlib.contextmanager
def profile(log_dir="/tmp/pymes_tpu_profile", *, device=None):
    """Trace the enclosed block with ``torch.profiler`` on ``device`` (None:
    the card) and export it to ``<log_dir>/trace.json`` (Chrome trace
    format; the default directory is the JAX package's).  Yields the profiler
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


# --- the tracer ---------------------------------------------------------

CAP = 1_000_000   # records kept; later ones are counted in ``dropped``
_clock = time.perf_counter_ns

_on = False
_anchor = None    # (time.time_ns(), time.perf_counter_ns()) at enable()
_records = []
_open = []        # the open spans, outermost first
_next_id = 0
dropped = 0


class SpanRecord(NamedTuple):
    """One closed span: ids, name and host times (``perf_counter_ns``)."""
    id: int
    parent: Optional[int]
    root: int
    name: str
    t0_ns: int
    t1_ns: int


class _Off:
    """The one span of a tracer that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """An open span of a tracer that is on."""
    __slots__ = ("name", "id", "parent", "root", "t0", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        self.parent = _open[-1].id if _open else None
        self.root = _open[0].id if _open else self.id
        _open.append(self)
        self.t0 = _clock()
        # outside a profiler session an annotation records nothing
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        global dropped
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t1 = _clock()
        _open.remove(self)
        if len(_records) < CAP:
            _records.append(SpanRecord(self.id, self.parent, self.root,
                                       self.name, self.t0, t1))
        else:
            dropped += 1
        return False


def span(name):
    """A context manager timing the enclosed block as the span ``name``;
    with the tracer off, one shared object that does nothing."""
    if not _on:
        return _OFF
    return _On(name)


def traced(name):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable():
    """Turn the tracer on (records kept so far stay) and take the anchor
    of :func:`epoch_ns`."""
    global _on, _anchor
    _anchor = (time.time_ns(), _clock())
    _on = True


def disable():
    """Turn the tracer off; spans still open record when they close."""
    global _on
    _on = False


def clear():
    """Drop the records and the count of dropped ones."""
    global dropped
    _records.clear()
    dropped = 0


def spans():
    """The closed spans in the order they closed (:class:`SpanRecord`)."""
    return list(_records)


def epoch_ns(t_ns):
    """A span time (``perf_counter_ns``) as Unix-epoch ns, the clock of a
    profiler's Chrome trace, through the anchor of the last :func:`enable`."""
    if _anchor is None:
        raise RuntimeError("the tracer was never enabled: no anchor")
    return _anchor[0] + (t_ns - _anchor[1])


def summary():
    """name → {"count", "total_ns", "self_ns"} over the closed spans; a
    span's self time is its duration less its closed child spans'."""
    child = {}
    for r in _records:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.t1_ns - r.t0_ns
    out = {}
    for r in _records:
        s = out.setdefault(r.name, {"count": 0, "total_ns": 0, "self_ns": 0})
        d = r.t1_ns - r.t0_ns
        s["count"] += 1
        s["total_ns"] += d
        s["self_ns"] += d - child.get(r.id, 0)
    return out
