"""``davidson_host_ms``: the median over every ``eom.subspace`` span of the
run, in ms: the host's work in one Davidson iteration from its top to the
device step: eig, root matching, the convergence test, the restart QR and
the upload. The read before it drained the card's queue, so the card idles
through it. The spans are the program's tracer's
(``pymes_tpu_torch/util/observability.py``, host ``perf_counter_ns``).
Loading this reader turns the tracer on: the harness loads per-layer readers
only in traced runs, before set-up, so untraced runs keep it off. A program
without the tracer, or without such spans, gives nothing."""

import statistics

from pymes_tpu_torch.util import observability as obs

TRACER = hasattr(obs, "enable")
if TRACER:
    obs.enable()
SPAN = "eom.subspace"


def read(ctx):
    if not TRACER:
        return None
    durs = [s.t1_ns - s.t0_ns for s in obs.spans() if s.name == SPAN]
    return statistics.median(durs) / 1e6 if durs else None
