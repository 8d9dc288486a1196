"""``sigma_issue_ms``: the median over every ``eom.sigma`` span of the run, in
ms: the host's time to issue one sigma on the rows a Davidson iteration
appends. The spans are the program's tracer's
(``pymes_tpu_torch/util/observability.py``, host ``perf_counter_ns``).
Loading this reader turns the tracer on: the harness loads per-layer readers
only in traced runs, before set-up, so untraced runs keep it off. A program
without the tracer, or without such spans, gives nothing."""

import statistics

from pymes_tpu_torch.util import observability as obs

TRACER = hasattr(obs, "enable")
if TRACER:
    obs.enable()
SPAN = "eom.sigma"


def read(ctx):
    if not TRACER:
        return None
    durs = [s.t1_ns - s.t0_ns for s in obs.spans() if s.name == SPAN]
    return statistics.median(durs) / 1e6 if durs else None
